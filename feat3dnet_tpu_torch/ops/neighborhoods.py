"""Ball query, grouping and gathers (port of feat3dnet_tpu/ops/neighborhoods.py).

Ball-query contract (reference query_ball_point_gpu, with the JAX
package's per-centre nearest fallback): the first `nsample` points in index
order with d2 < r^2 (strict; d2 from coordinate differences, never the
|a|^2 + |b|^2 - 2ab expansion); slots past the count repeat the first
in-ball index; an empty ball gets the centre's nearest valid point (first
index on ties) in every slot; masked points are never selected.

`ball_query_plain` is the CPU path and the oracle for kernel K2
(ops/batch_group.py); `ball_query` dispatches on the tensors' device.
Per-centre radii (QueryBallPoint2) and `knn_points` are not ported yet
(no path of the port calls them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances, (..., M, 3) x (..., N, 3) -> (..., M, N), summed
    ((d0*d0) + d1*d1) + d2*d2 from per-coordinate differences."""
    d = None
    for c in range(a.shape[-1]):
        dc = a[..., c:c + 1] - b[..., None, :, c]
        dc = dc * dc
        d = dc if d is None else d + dc
    return d


def _scalar_radius(radius) -> float:
    if isinstance(radius, torch.Tensor) and radius.dim() > 0:
        raise NotImplementedError("per-centre radii are not ported yet")
    return float(radius)


def ball_query_plain(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                     nsample: int, valid_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ball query: (B, N, 3), (B, M, 3) -> idx (B, M, nsample) int32,
    cnt (B, M) int32 (the in-ball count capped at nsample).

    The s-th in-ball index is the first k whose cumulative in-ball count
    reaches s+1, found with searchsorted on the (nondecreasing) cumsum —
    O(M·N + M·ns·log N), with nothing of shape (M, N, ns).
    """
    n = xyz.shape[-2]
    lead = centers.shape[:-1]
    r = torch.tensor(_scalar_radius(radius), dtype=xyz.dtype)
    r2 = (r * r).item()                                      # float32 square
    d2 = pairwise_sqdist(centers, xyz).reshape(-1, n)        # (BM, N)
    in_ball = d2 < r2
    valid_rows = None
    if valid_mask is not None:
        valid_rows = valid_mask[..., None, :].expand(*lead, n).reshape(-1, n)
        in_ball = in_ball & valid_rows

    count = torch.cumsum(in_ball.to(torch.int32), dim=-1, dtype=torch.int32)
    cnt = torch.clamp(count[:, -1], max=nsample)
    targets = torch.arange(1, nsample + 1, dtype=torch.int32, device=xyz.device)
    idx = torch.searchsorted(count, targets.expand(count.shape[0], nsample).contiguous())
    idx = torch.clamp(idx, max=n - 1).to(torch.int32)

    d2_valid = d2 if valid_rows is None else torch.where(
        valid_rows, d2, torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device))
    nearest = torch.argmin(d2_valid, dim=-1).to(torch.int32)  # first min on ties
    first = torch.where(cnt > 0, idx[:, 0], nearest)
    slot = torch.arange(nsample, device=xyz.device)
    idx = torch.where(slot[None, :] < cnt[:, None], idx, first[:, None])
    return idx.reshape(*lead, nsample), cnt.reshape(lead)


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int, valid_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size radius neighbourhoods: the plain version on CPU tensors,
    kernel K2 (ops/batch_group.ball_query_fused) on CUDA tensors."""
    from feat3dnet_tpu_torch.ops.batch_group import ball_query_fused

    return ball_query_fused(xyz, centers, radius, nsample, valid_mask)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    flat = idx.reshape(b, m * s).long()[..., None].expand(b, m * s, points.shape[-1])
    return torch.gather(points, 1, flat).reshape(b, m, s, points.shape[-1])


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C)."""
    flat = idx.long()[..., None].expand(*idx.shape, points.shape[-1])
    return torch.gather(points, 1, flat)
