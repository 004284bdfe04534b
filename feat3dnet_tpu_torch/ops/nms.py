"""Radius NMS and keypoint selection (port of feat3dnet_tpu/ops/nms.py).

A point survives iff its attention is at least the maximum attention
within `nms_radius` (>=, so tied neighbours both survive, as the
reference's argmax==0 test keeps them). `nms_keypoints` computes that
maximum densely, streamed over tiles of 2 048 queries against the whole
cloud; the extraction's hashed path gets it from kernel K5
(ops/hash_grid.ball_max_sorted) instead. `select_keypoints` is the shared
tail: the min_response_ratio floor, the top max_keypoints by attention
with ties to the lower index (jax.lax.top_k's rule, here a stable
descending sort), and padding with the strongest keypoint.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from feat3dnet_tpu_torch.ops.neighborhoods import pairwise_sqdist


def nms_keypoints(xyz: torch.Tensor, attention: torch.Tensor, nms_radius: float,
                  max_keypoints: int, min_response_ratio: float = 1e-2,
                  valid_mask: Optional[torch.Tensor] = None, tile: int = 2048):
    """Radius NMS + top-k, batched: (B, N, 3), (B, N) ->
    (kp_xyz (B, K, 3), kp_attention (B, K), num_keypoints (B,) int32);
    slots past the true count repeat the strongest keypoint."""
    b, n, _ = xyz.shape
    att = attention
    if valid_mask is not None:
        att = torch.where(valid_mask, att, torch.zeros_like(att))
    r2 = float(np.float32(nms_radius) * np.float32(nms_radius))
    neg_inf = torch.tensor(float("-inf"), dtype=att.dtype, device=att.device)
    is_max = torch.empty((b, n), dtype=torch.bool, device=xyz.device)
    for bi in range(b):
        for s in range(0, n, tile):
            d2 = pairwise_sqdist(xyz[bi, s:s + tile], xyz[bi])           # (tile, N)
            best = torch.where(d2 < r2, att[bi][None, :], neg_inf).amax(dim=1)
            is_max[bi, s:s + tile] = att[bi, s:s + tile] >= best
    return select_keypoints(xyz, attention, is_max, max_keypoints,
                            min_response_ratio, valid_mask)


def select_keypoints(xyz: torch.Tensor, attention: torch.Tensor, is_max: torch.Tensor,
                     max_keypoints: int, min_response_ratio: float = 1e-2,
                     valid_mask: Optional[torch.Tensor] = None,
                     return_indices: bool = False):
    """Keypoints from a radius-max survival mask: keep = is_max and
    attention > max·min_response_ratio (invalid attention zeroed first);
    the top max_keypoints kept points by attention, ties to the lower
    index; pad with slot 0. Returns (kp_xyz, kp_attention, num[, idx])."""
    n = attention.shape[-1]
    if max_keypoints > n:
        raise ValueError(f"select_keypoints: max_keypoints={max_keypoints} > {n} points")
    att = attention
    if valid_mask is not None:
        att = torch.where(valid_mask, att, torch.zeros_like(att))
    thresh = att.amax(dim=-1, keepdim=True) * min_response_ratio
    keep = is_max & (att > thresh)
    if valid_mask is not None:
        keep = keep & valid_mask
    score = torch.where(keep, att, torch.full_like(att, float("-inf")))
    top_att, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top_att, top_idx = top_att[:, :max_keypoints], top_idx[:, :max_keypoints]
    num = torch.clamp(keep.sum(dim=-1), max=max_keypoints).to(torch.int32)

    slot = torch.arange(max_keypoints, device=att.device)
    valid_slot = slot[None, :] < num[:, None]
    top_idx = torch.where(valid_slot, top_idx, top_idx[:, :1])
    top_att = torch.where(valid_slot, top_att, top_att[:, :1])
    kp_xyz = torch.gather(xyz, 1, top_idx[..., None].expand(-1, -1, xyz.shape[-1]))
    if return_indices:
        return kp_xyz, top_att, num, top_idx.to(torch.int32)
    return kp_xyz, top_att, num
