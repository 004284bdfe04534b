"""Whole-cloud keypoint extraction in plain PyTorch (reference inference.py:66-180).

Every point of the cloud is a centre: its ball is the first `ns` points in
index order with d2 < r^2 (d2 = ((dx*dx) + dy*dy) + dz*dz from coordinate
differences), repeat-padded; the detector gives each point its attention
and orientation. A point is a keypoint candidate iff its attention is at
least the largest attention within `nms_radius` and above
max(attention) * min_response_ratio; the `max_keypoints` strongest
candidates are kept, ties to the lower index. Descriptors come from the
keypoint's own ball, rotated by its orientation.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import model as M


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N), ((dx*dx) + dy*dy) + dz*dz."""
    d = None
    for c in range(3):
        dc = a[..., :, None, c] - b[..., None, :, c]
        dc = dc * dc
        d = dc if d is None else d + dc
    return d


def r2_of(radius: float) -> float:
    return float(np.float32(radius) * np.float32(radius))


def ball_indices(xyz: torch.Tensor, centers: torch.Tensor, radius: float, ns: int
                 ) -> torch.Tensor:
    """(N, 3) points, (M, 3) centres -> (M, ns) int64: the first ns in-ball
    indices, slots past the count repeating the first; an empty ball takes
    the nearest point (first on ties)."""
    d2 = sqdist(centers, xyz)
    inside = d2 < r2_of(radius)
    count = torch.cumsum(inside.to(torch.int32), dim=1)
    cnt = count[:, -1].clamp(max=ns)
    want = torch.arange(1, ns + 1, device=xyz.device, dtype=torch.int32)
    idx = torch.searchsorted(count, want.expand(count.shape[0], ns).contiguous())
    idx = idx.clamp(max=xyz.shape[0] - 1)
    nearest = torch.argmin(d2, dim=1)
    first = torch.where(cnt > 0, idx[:, 0], nearest)
    slot = torch.arange(ns, device=xyz.device)
    return torch.where(slot[None, :] < cnt[:, None], idx, first[:, None])


def cluster_offsets(xyz: torch.Tensor, centers: torch.Tensor, radius: float, ns: int
                    ) -> torch.Tensor:
    """(M, ns, 3) offsets of each centre's ball from the centre."""
    idx = ball_indices(xyz, centers, radius, ns)
    return xyz[idx] - centers[:, None, :]


@torch.no_grad()
def attention_everywhere(w: M.Weights, cfg: dict, xyz: torch.Tensor, chunk: int = 2048
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention (N,) and unit orientation (N, 2) at every point of (N, 3)."""
    atts, oris = [], []
    r, ns = float(cfg["base_scale"]), int(cfg["num_samples"])
    for c0 in range(0, xyz.shape[0], chunk):
        offs = cluster_offsets(xyz, xyz[c0:c0 + chunk], r, ns)
        a, o = M.detect_clusters(w, cfg, offs)
        atts.append(a)
        oris.append(o)
    return torch.cat(atts), torch.cat(oris)


@torch.no_grad()
def ball_max(xyz: torch.Tensor, values: torch.Tensor, radius: float, chunk: int = 2048
             ) -> torch.Tensor:
    """Per point, the max of `values` over its radius ball (itself included)."""
    out = []
    r2 = r2_of(radius)
    neg = torch.tensor(float("-inf"), device=xyz.device)
    for c0 in range(0, xyz.shape[0], chunk):
        inside = sqdist(xyz[c0:c0 + chunk], xyz) < r2
        out.append(torch.where(inside, values[None, :], neg).amax(dim=1))
    return torch.cat(out)


@torch.no_grad()
def select(att: torch.Tensor, ballmax: torch.Tensor, max_keypoints: int,
           min_response_ratio: float) -> torch.Tensor:
    """Indices of the keypoints, strongest first (ties to the lower index)."""
    keep = (att >= ballmax) & (att > att.max() * min_response_ratio)
    score = torch.where(keep, att, torch.full_like(att, float("-inf")))
    order = torch.sort(score, descending=True, stable=True).indices
    num = int(min(int(keep.sum()), max_keypoints))
    return order[:num]


@torch.no_grad()
def extract(w: M.Weights, cfg: dict, icfg: dict, xyz: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference extraction of one (N, 3) cloud on its device: per-point
    attention and orientation, the keypoint indices, and their descriptors."""
    att, ori = attention_everywhere(w, cfg, xyz)
    bm = ball_max(xyz, att, float(icfg["nms_radius"]))
    kp = select(att, bm, int(icfg["max_keypoints"]), float(icfg["min_response_ratio"]))
    return {"attention": att, "orientation": ori, "keypoints": kp,
            "features": describe_at(w, cfg, xyz, kp, ori)}


@torch.no_grad()
def describe_at(w: M.Weights, cfg: dict, xyz: torch.Tensor, idx: torch.Tensor,
                ori: torch.Tensor) -> torch.Tensor:
    """Descriptors (K, D) at point indices `idx`, each ball rotated by the
    point's orientation vector from the attention pass."""
    r, ns = float(cfg["base_scale"]), int(cfg["num_samples"])
    if idx.numel() == 0:
        return torch.zeros((0, cfg["descriptor_mlp3"][-1]), device=xyz.device)
    offs = cluster_offsets(xyz, xyz[idx], r, ns)
    xs = offs / r
    mask = M.membership(offs, r)
    o = ori[idx]
    return M.descriptor(w, cfg, M.rotate(xs, o[:, 0], o[:, 1]), mask)
