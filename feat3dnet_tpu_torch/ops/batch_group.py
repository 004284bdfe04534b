"""Exact ball query on the card (port of feat3dnet_tpu/ops/batch_group.py).

On the TPU the model ran XLA's dense ball query and the Pallas kernel was
opt-in. Here kernel K2 (csrc/ball_query.cu) is the ball query for every
CUDA tensor: `ops.ball_query` reaches it through `ball_query_fused`. The
contract is `neighborhoods.ball_query_plain`'s (a scalar or a (B, M)
per-centre radius, optional valid mask), index-exact.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.ops.neighborhoods import (Radius, ball_query_plain,
                                                   per_centre_radius)
from feat3dnet_tpu_torch.utils.profiling import spanned


def ball_query_cluster_size(b: int, m: int, n: int, shape: Tuple[int, int, int],
                            sms: int) -> int:
    """K2's CTAs per group of 32 centres (a thread-block cluster that splits
    the cloud), a power of two: `shape` is K2's (warps a CTA, chunks a warp
    takes per round, largest cluster), as kernels.ball_query_shape reads it
    from the library, and `sms` the card's streaming multiprocessors. The
    smallest size that covers the cloud in one round (cluster x warps x
    chunks chunks of 32 points), then doubled while the grid stays within
    two CTAs an SM and every warp keeps at least two chunks."""
    warps, chunks_per_warp, max_cluster = shape
    groups = b * -(-m // 32)
    chunks = -(-n // 32)
    c = 1
    while c < max_cluster and c * warps * chunks_per_warp < chunks:
        c *= 2
    while (c < max_cluster and groups * (2 * c) <= 2 * sms
           and chunks >= 2 * (2 * c) * warps):
        c *= 2
    return c


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k2_cluster_size(b: int, m: int, n: int, device: torch.device) -> int:
    """The wrapper's cluster size for K2 on the CUDA `device`."""
    return ball_query_cluster_size(b, m, n, kernels.ball_query_shape(), _sm_count(device))


@spanned("f3d.k2.ball_query")
def ball_query_fused(xyz: torch.Tensor, centers: torch.Tensor, radius: Radius,
                     nsample: int, valid_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ball query through kernel K2: (B, N, 3), (B, M, 3) f32, a scalar or
    a contiguous (B, M) f32 radius -> (idx (B, M, nsample) int32, cnt (B, M)
    int32).

    CPU tensors take `ball_query_plain`; CUDA tensors launch the kernel
    (a (B, M) radius: its per-centre entry point, which squares each
    radius on the card), and anything it does not take raises. Each launch counts in
    `launches` and in `mode_launches` ('scalar' or 'radii').
    """
    if xyz.device.type == "cpu":
        return ball_query_plain(xyz, centers, radius, nsample, valid_mask)
    if xyz.device.type != "cuda":
        raise ValueError(f"ball_query_fused: unsupported device {xyz.device}")
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
    radii = per_centre_radius(radius, xyz, centers)
    if radii is None:
        r = float(radius)
        r2, mode = float(np.float32(r) * np.float32(r)), "scalar"   # float32 square
    else:
        if not radii.is_contiguous():
            raise ValueError("ball_query_fused: the (B, M) radius must be contiguous")
        r2, mode = 0.0, "radii"
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    kernels.launch_ball_query(xyz, centers, valid_mask, r2, nsample,
                              k2_cluster_size(b, m, n, xyz.device), idx, cnt, radii=radii)
    ball_query_fused.launches += 1
    ball_query_fused.mode_launches[mode] += 1
    return idx, cnt


ball_query_fused.launches = 0
ball_query_fused.mode_launches = {"scalar": 0, "radii": 0}
ball_query_fused.plain = ball_query_plain
