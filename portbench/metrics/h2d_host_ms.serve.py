"""Entry (server): the host's milliseconds in the copy of one request's
clusters to the device (`torch.as_tensor` of the pageable host array, the
span `f3d.serve.h2d`), their mean over the traced window."""
from portbench import spans


def read(r):
    return spans.mean_ms(r.trace, "f3d.serve.h2d")
