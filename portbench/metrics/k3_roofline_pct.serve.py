"""Kernels, K3 (csrc/fused_describe.cu): the bound of the whole eval
forward on the traced window's clusters, over K3's device time."""
from portbench import flops

KERNELS = ("describe_kernel",)


def read(r):
    return r.roofline_pct(KERNELS, *flops.k3_work(r.cfg, r.traced["work"]["clusters"]))
