"""Entry (training): the host's milliseconds in one call of the fused step
(the span `f3d.train.step`: augment, forward, loss, backward, Adam and the
device histograms queued), their mean over the traced window."""
from portbench import spans


def read(r):
    return spans.mean_ms(r.trace, "f3d.train.step")
