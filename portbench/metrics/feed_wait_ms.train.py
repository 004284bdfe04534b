"""Entry (training): the milliseconds the step's thread waits on the
prefetch thread for each batch (the span `f3d.data.wait`), their total
over the traced window's steps."""
from portbench import spans


def read(r):
    return spans.per_unit_ms(r.trace, lambda n: n == "f3d.data.wait",
                             r.traced["work"]["steps"])
