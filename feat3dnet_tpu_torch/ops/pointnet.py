"""PointNet-style set-abstraction wrappers (port of feat3dnet_tpu/ops/pointnet.py).

The reference's pointnet_common.py helpers, which the model does not call
but the reference exports:

  sample_points        (pointnet_common.py:14-29)  FPS centres (kernel K1
                       on CUDA), or the whole cloud when npoint <= 0.
  sample_and_group     (pointnet_common.py:69-135) centres (FPS or given
                       keypoints) and their normalised, optionally
                       z-rotated neighbourhoods: models/feat3dnet's
                       _group_normalized (kernel K2 on CUDA).
  sample_and_group_all (pointnet_common.py:138-165) one group of every
                       point, centred at the origin.

And PointNet++'s grouping of C-wide features (models/pointnet2.py):

  group_relative       each ball's [xyz - centre | features] rows, one
                       gather of the cloud's [xyz | features].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from feat3dnet_tpu_torch.ops.fps import farthest_point_sample
from feat3dnet_tpu_torch.ops.neighborhoods import gather_points, group_points


def sample_points(xyz: torch.Tensor, npoint: int,
                  valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS centres (B, npoint, 3); `xyz` itself when npoint <= 0."""
    if npoint <= 0:
        return xyz
    return gather_points(xyz, farthest_point_sample(xyz, npoint, valid_mask))


def sample_and_group(npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
                     keypoints: Optional[torch.Tensor] = None,
                     orientations: Optional[torch.Tensor] = None,
                     valid_mask: Optional[torch.Tensor] = None,
                     normalize_radius: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(centers (B, M, 3), grouped (B, M, nsample, 3), idx (B, M, nsample)
    int32, cnt (B, M) int32): the reference's sample_and_group with fixed
    shapes. The radius is a scalar. normalize_radius=False multiplies the
    normalised grouping back by it, as JAX does (not the raw offsets)."""
    from feat3dnet_tpu_torch.models.feat3dnet import _group_normalized

    if isinstance(radius, torch.Tensor) and radius.dim() > 0:
        raise ValueError("sample_and_group: the radius is a scalar")
    centers = keypoints if keypoints is not None else sample_points(xyz, npoint, valid_mask)
    grouped, idx, cnt = _group_normalized(xyz, centers, radius, nsample, valid_mask,
                                          orientations=orientations)
    if not normalize_radius:
        grouped = grouped * radius
    return centers, grouped, idx, cnt


def sample_and_group_all(xyz: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One group of every point, centred at the origin: (centers (B, 1, 3)
    zeros, grouped (B, 1, N, 3), idx (B, 1, N) int32)."""
    b, n, _ = xyz.shape
    centers = torch.zeros((b, 1, 3), dtype=xyz.dtype, device=xyz.device)
    idx = torch.arange(n, dtype=torch.int32, device=xyz.device).expand(b, 1, n)
    return centers, xyz[:, None], idx


def group_relative(points: torch.Tensor, centers: torch.Tensor, idx: torch.Tensor
                   ) -> torch.Tensor:
    """(B, N, 3 + C) points whose first 3 columns are xyz (the rest their
    features), (B, M, 3) centres and (B, M, S) ball indices -> (B, M, S, 3 +
    C): each member's xyz less its centre (not divided by the radius), then
    its features (Pointnet2.PyTorch's QueryAndGroup with use_xyz)."""
    grouped = group_points(points, idx)
    grouped[..., :3] -= centers[:, :, None, :]
    return grouped
