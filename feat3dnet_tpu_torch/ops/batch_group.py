"""Exact ball query on the card (port of feat3dnet_tpu/ops/batch_group.py).

On the TPU the model ran XLA's dense ball query and the Pallas kernel was
opt-in. Here kernel K2 (csrc/ball_query.cu) is the ball query for every
CUDA tensor: `ops.ball_query` reaches it through `ball_query_fused`. The
contract is `neighborhoods.ball_query_plain`'s (scalar radius, optional
valid mask), index-exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.ops.neighborhoods import _scalar_radius, ball_query_plain


def ball_query_fused(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                     nsample: int, valid_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ball query through kernel K2: (B, N, 3), (B, M, 3) f32 ->
    (idx (B, M, nsample) int32, cnt (B, M) int32).

    CPU tensors take `ball_query_plain`; CUDA tensors launch the kernel,
    and anything it does not take raises.
    """
    if xyz.device.type == "cpu":
        return ball_query_plain(xyz, centers, radius, nsample, valid_mask)
    if xyz.device.type != "cuda":
        raise ValueError(f"ball_query_fused: unsupported device {xyz.device}")
    r = _scalar_radius(radius)
    if (xyz.dtype != torch.float32 or centers.dtype != torch.float32
            or xyz.dim() != 3 or centers.dim() != 3 or xyz.shape[2] != 3
            or centers.shape[2] != 3 or centers.shape[0] != xyz.shape[0]):
        raise ValueError(f"ball_query_fused: want (B, N, 3), (B, M, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}, {tuple(centers.shape)} "
                         f"{centers.dtype}")
    if centers.device != xyz.device:
        raise ValueError("ball_query_fused: xyz and centers on different devices")
    if not (xyz.is_contiguous() and centers.is_contiguous()):
        raise ValueError("ball_query_fused: xyz and centers must be contiguous")
    b, n, _ = xyz.shape
    m = centers.shape[1]
    if nsample < 1 or n < 1:
        raise ValueError(f"ball_query_fused: nsample={nsample}, N={n}")
    if valid_mask is not None and (
            valid_mask.dtype != torch.bool or valid_mask.shape != (b, n)
            or valid_mask.device != xyz.device or not valid_mask.is_contiguous()):
        raise ValueError("ball_query_fused: valid_mask must be a contiguous (B, N) "
                         f"bool tensor on {xyz.device}")
    r2 = float(np.float32(r) * np.float32(r))                # float32 square
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    kernels.launch_ball_query(xyz, centers, valid_mask, r2, nsample, idx, cnt)
    ball_query_fused.launches += 1
    return idx, cnt


ball_query_fused.launches = 0
ball_query_fused.plain = ball_query_plain
