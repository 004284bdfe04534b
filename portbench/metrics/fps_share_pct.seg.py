"""Kernels, K1 (csrc/fps.cu): its device time over the traced window's busy
time; at 16 384 points the four levels' FPS are 5 436 dependent steps a
cloud. None where K1 did not run."""
from portbench import flops_seg


def read(r):
    t = r.trace.time_s(flops_seg.FPS_KERNELS)
    return 100.0 * t / r.trace.busy_s if t > 0 else None
