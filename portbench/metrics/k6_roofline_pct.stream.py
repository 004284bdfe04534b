"""Kernels, K6 (csrc/fused_detect.cu): the bound of the detector's work on
the traced window's clusters of real points, over K6's device time."""
from portbench import flops

KERNELS = ("fused_detect_kernel",)


def read(r):
    return r.roofline_pct(KERNELS, *flops.k6_work(r.cfg, r.traced["work"]["real_points"]))
