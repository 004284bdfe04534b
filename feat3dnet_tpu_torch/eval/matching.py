"""Nearest-neighbour descriptor matching (port of feat3dnet_tpu/eval/matching.py).

Reference: scripts/computeAndVisualizeMatches.m:43 — `pdist2(..., 'smallest', 1)`:
for every descriptor in set B, its single nearest neighbour in set A. The
(Nb, Na) distances are one product on the tensors' device; on CUDA the
caller turns TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`),
or close distances swap their order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from feat3dnet_tpu_torch.models.layers import pairwise_sqdist_features


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each descriptor in B, the nearest descriptor in A.

    desc_a: (Na, D); desc_b: (Nb, D). Returns idx (Nb,) int32 into A (the
    first of equal distances, as jnp.argmin) and dist (Nb,) L2 distance.
    """
    d2 = pairwise_sqdist_features(desc_b[None], desc_a[None])[0]   # (Nb, Na)
    idx = torch.argmin(d2, dim=-1)
    dist = torch.sqrt(torch.gather(d2, 1, idx[:, None])[:, 0])
    return idx.to(torch.int32), dist


def mutual_matches(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Nb,) bool: B's nearest neighbour in A has that B as its own nearest."""
    d2 = pairwise_sqdist_features(desc_b[None], desc_a[None])[0]
    b_to_a = torch.argmin(d2, dim=-1)
    a_to_b = torch.argmin(d2, dim=-2)
    return a_to_b[b_to_a] == torch.arange(desc_b.shape[0], device=d2.device)
