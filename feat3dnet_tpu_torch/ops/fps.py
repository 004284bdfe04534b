"""Farthest point sampling (port of feat3dnet_tpu/ops/fps.py).

Contract (reference CUDA farthestpointsamplingKernel, index-exact): start
at index 0; keep each point's running minimum squared distance to the
chosen set (initial 1e38); the next point is the argmax of that minimum,
ties to the lowest index; masked points are never chosen.

* `farthest_point_sample_scan` — the plain version: a Python loop over the
  npoint steps, each a few tensor ops on (B, N). The CPU path and the
  oracle for the kernel.
* `farthest_point_sample` — the wrapper of kernel K1 (csrc/fps.cu). CPU
  tensors take the plain version; CUDA tensors launch the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from feat3dnet_tpu_torch import kernels

_INIT_DIST = 1e38


def farthest_point_sample_scan(xyz: torch.Tensor, npoint: int,
                               valid_mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain FPS: (B, N, 3) -> (B, npoint) int32 indices."""
    b, n, _ = xyz.shape
    out = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    if npoint <= 1:
        return out
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    mindist = torch.full((b, n), _INIT_DIST, dtype=xyz.dtype, device=xyz.device)
    neg_inf = torch.tensor(float("-inf"), dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        d = dx * dx + dy * dy          # ((dx*dx) + dy*dy) + dz*dz, as the reference
        d = d + dz * dz
        mindist = torch.minimum(mindist, d)
        score = mindist if valid_mask is None else torch.where(valid_mask, mindist, neg_inf)
        last = torch.argmax(score, dim=1, keepdim=True)   # first max on ties
        out[:, j] = last[:, 0].to(torch.int32)
    return out


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          valid_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """FPS through kernel K1: (B, N, 3) f32 -> (B, npoint) int32.

    CPU tensors take `farthest_point_sample_scan`; CUDA tensors launch the
    kernel, and anything it does not take raises.
    """
    if xyz.device.type == "cpu":
        return farthest_point_sample_scan(xyz, npoint, valid_mask)
    if xyz.device.type != "cuda":
        raise ValueError(f"farthest_point_sample: unsupported device {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"farthest_point_sample: want (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("farthest_point_sample: xyz must be contiguous")
    b, n, _ = xyz.shape
    if npoint < 1 or n < 1:
        raise ValueError(f"farthest_point_sample: npoint={npoint}, N={n}")
    mask = None
    if valid_mask is not None:
        if (valid_mask.dtype != torch.bool or valid_mask.shape != (b, n)
                or valid_mask.device != xyz.device or not valid_mask.is_contiguous()):
            raise ValueError("farthest_point_sample: valid_mask must be a contiguous "
                             f"(B, N) bool tensor on {xyz.device}")
        mask = valid_mask
    scratch = None
    if n > kernels.fps_max_smem_points():
        scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    kernels.launch_fps(xyz, mask, scratch, npoint, out)
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0
farthest_point_sample.plain = farthest_point_sample_scan
