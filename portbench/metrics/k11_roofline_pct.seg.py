"""Kernels, K11 (csrc/three_interp.cu): the bound of the four FP levels'
interpolation on the traced window's clouds (portbench/flops_seg.py: its
search and weighted sum at the one peak, or its bytes at the memory rate,
the larger), over K11's device time. None where K11 did not run."""
from portbench import flops_seg


def read(r):
    return r.roofline_pct(flops_seg.K11_KERNELS,
                          *flops_seg.k11_work(r.cfg, r.traced["work"]["clouds"]))
