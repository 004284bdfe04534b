"""Kernels, K7-K10 (csrc/fused_train.cu) taken together: the bound of the
pre-pool segments' forward and backward over the traced window's steps,
over the four kernels' device time summed."""
from portbench import flops

KERNELS = ("train_stats_kernel", "train_final_kernel", "train_bwd_top_kernel",
           "train_bwd_kernel")


def read(r):
    clouds = 3 * int(r.run.spec["triplets"])
    f, b = flops.towers_work(r.cfg, clouds)
    steps = r.traced["work"]["steps"]
    return r.roofline_pct(KERNELS, steps * f, steps * b)
