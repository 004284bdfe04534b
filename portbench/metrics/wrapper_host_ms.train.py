"""Op wrappers: the host's milliseconds inside the kernel wrappers (the
spans `f3d.k<n>.*`: validation, allocation, packing and the launch; on
every thread, the backward's K9 and K10 included), their total over the
traced window's steps. No wrapper calls another on the training path."""
from portbench import spans


def _wrapper(name):
    return name.startswith("f3d.k") and name[5:6].isdigit()


def read(r):
    return spans.per_unit_ms(r.trace, _wrapper, r.traced["work"]["steps"])
