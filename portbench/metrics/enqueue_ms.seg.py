"""Entry (segmentation): the host's milliseconds to queue one unit of
`segment_many` (the span `f3d.seg.enqueue`: every device op of the unit's
forward and the copy of its logits queued, no wait), their mean over the
traced window. None in a program without the span."""
from portbench import spans


def read(r):
    return spans.mean_ms(r.trace, "f3d.seg.enqueue")
