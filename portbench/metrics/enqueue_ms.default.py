"""Entry (extraction): the host's milliseconds to queue one unit of
`extract_many` (the span `f3d.extract.enqueue`: every device op of the
unit and the copy of its outputs queued, no wait), their mean over the
traced window. The default route queues each ConvBN's GEMM and
elementwise ops one by one, so this shows whether the host sets the pace."""
from portbench import spans


def read(r):
    return spans.mean_ms(r.trace, "f3d.extract.enqueue")
