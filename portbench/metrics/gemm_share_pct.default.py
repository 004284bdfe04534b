"""Towers (default route): the device time of the towers' GEMM and GEMV
kernels (names holding `gemm` or `gemv`) over the traced window's busy time;
the rest is the eval BatchNorm, ReLU and pooling kernels between them, K4,
K5 and the layout. None where no such kernel ran.

The names found on an H100 (torch 2.11.0+cu128, TF32 off): cuBLAS's f32
FFMA kernels `sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize<T>_stage3_
warpsize<W>_ffma_aligna4_alignc4_execute_kernel__5x_cublas`, T one of
128x128x8, 64x64x8, 64x128x8, 128x64x8, 128x32x8 and 32x32x8, and
`gemv2T_kernel_val<int, int, float, ...>` for the one-wide heads."""
from portbench.flops_default import GEMM_KERNELS


def read(r):
    t = r.trace.time_s(GEMM_KERNELS)
    return 100.0 * t / r.trace.busy_s if t > 0 else None
