"""Ball query, grouping, gathers and kNN (port of feat3dnet_tpu/ops/neighborhoods.py).

Ball-query contract (reference query_ball_point_gpu, with the JAX
package's per-centre nearest fallback): the first `nsample` points in index
order with d2 < r^2 (strict; d2 from coordinate differences, never the
|a|^2 + |b|^2 - 2ab expansion); slots past the count repeat the first
in-ball index; an empty ball gets the centre's nearest valid point (first
index on ties) in every slot; masked points are never selected.

The radius is a scalar (a Python number or a 0-d tensor) or, as in
QueryBallPoint2, a (B, M) tensor of the cloud's dtype on its device, one
radius per centre. r^2 is the square in that dtype (JAX's
`jnp.square(radius)`), so a zero or NaN radius is an empty ball (the
nearest point fills it) and a negative one acts as its absolute value.

`ball_query_plain` is the CPU path and the oracle for kernel K2
(ops/batch_group.py); `ball_query` dispatches on the tensors' device.
`knn_points` is plain torch on every device (JAX's is `lax.top_k`, no
Pallas kernel).
"""
from __future__ import annotations

from numbers import Real
from typing import Optional, Tuple, Union

import numpy as np
import torch

Radius = Union[float, torch.Tensor]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances, (..., M, 3) x (..., N, 3) -> (..., M, N), summed
    ((d0*d0) + d1*d1) + d2*d2 from per-coordinate differences."""
    d = None
    for c in range(a.shape[-1]):
        dc = a[..., c:c + 1] - b[..., None, :, c]
        dc = dc * dc
        d = dc if d is None else d + dc
    return d


def per_centre_radius(radius: Radius, xyz: torch.Tensor,
                      centers: torch.Tensor) -> Optional[torch.Tensor]:
    """The (B, M) radius tensor of a per-centre query, or None for a scalar
    radius (a real number or a 0-d tensor); anything else raises."""
    if isinstance(radius, torch.Tensor):
        if radius.dim() == 0:
            return None
        if (radius.shape != centers.shape[:-1] or radius.dtype != xyz.dtype
                or radius.device != xyz.device):
            raise ValueError(f"ball_query: a per-centre radius is a {tuple(centers.shape[:-1])} "
                             f"{xyz.dtype} tensor on {xyz.device}, got {tuple(radius.shape)} "
                             f"{radius.dtype} on {radius.device}")
        return radius
    if isinstance(radius, (Real, np.ndarray)) and np.ndim(radius) == 0:
        return None
    raise TypeError(f"ball_query: the radius is a number, a 0-d tensor or a (B, M) tensor, "
                    f"got {type(radius).__name__}")


def ball_query_plain(xyz: torch.Tensor, centers: torch.Tensor, radius: Radius,
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
    radii = per_centre_radius(radius, xyz, centers)
    if radii is None:
        r = torch.tensor(float(radius), dtype=xyz.dtype)
        r2 = (r * r).item()                                  # square in xyz's dtype
    else:
        r2 = (radii * radii).reshape(-1, 1)                  # (BM, 1), on the device
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


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: Radius,
               nsample: int, valid_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size radius neighbourhoods (a scalar or a (B, M) radius): the
    plain version on CPU tensors, kernel K2 (ops/batch_group.ball_query_fused)
    on CUDA tensors."""
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


def knn_points(k: int, xyz: torch.Tensor, centers: torch.Tensor,
               valid_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of each centre: (dist2 (B, M, k) in xyz's dtype,
    idx (B, M, k) int32), nearest first, ties to the lower index (as
    `lax.top_k` on -d2, and the reference's selection sort); masked points
    are at inf. A stable ascending sort of d2, the same order on every
    device (torch.topk orders ties arbitrarily on CUDA). Holds (B, M, N)."""
    n = xyz.shape[-2]
    if not 0 <= k <= n:
        raise ValueError(f"knn_points: k={k} with N={n} points")
    d2 = pairwise_sqdist(centers, xyz)
    if valid_mask is not None:
        d2 = torch.where(valid_mask[..., None, :], d2,
                         torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device))
    dist2, idx = torch.sort(d2, dim=-1, stable=True)
    return dist2[..., :k].contiguous(), idx[..., :k].to(torch.int32)
