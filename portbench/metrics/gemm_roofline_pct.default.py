"""Towers (default route): the bound of both towers' work on the traced
window's clouds (the detector at every real point, the descriptor at every
keypoint; portbench/flops_default.py) over the device time of their GEMM
and GEMV kernels (the names in gemm_share_pct.default.py)."""
from portbench import flops_default


def read(r):
    w = r.traced["work"]
    return r.roofline_pct(flops_default.GEMM_KERNELS,
                          *flops_default.default_towers_work(r.cfg, w["real_points"],
                                                             w["keypoints"]))
