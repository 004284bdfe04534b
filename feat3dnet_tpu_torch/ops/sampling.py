"""Weighted categorical sampling (port of feat3dnet_tpu/ops/sampling.py).

The reference's ProbSample (tf_ops/sampling/tf_sampling_g.cu:7-104): a
row cumsum of the weights, then a binary search per uniform draw. Unused
by 3DFeat-Net itself; the reference exports it. Plain torch on every
device (JAX's is `cumsum + searchsorted`, no Pallas kernel).

The indices agree with JAX's exactly where the cdf is exact (e.g. small
integer weights). With random float32 weights the three cumsums (XLA's,
torch's on the CPU, CUDA's scan) sum in different orders and differ by a
few ulp of the row total, so a draw whose target lies that close to a
boundary may land one index over.
"""
from __future__ import annotations

import torch


def prob_sample(probs: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Indices drawn from unnormalised row weights: probs (B, N) >= 0,
    uniforms (B, M) in [0, 1) -> (B, M) int32. The first index whose cdf
    exceeds u * total, clamped to N - 1 (an all-zero row gives N - 1)."""
    cdf = torch.cumsum(probs, dim=-1)
    targets = uniforms * cdf[..., -1:]
    idx = torch.searchsorted(cdf.contiguous(), targets.contiguous(), right=True)
    return torch.clamp(idx, max=probs.shape[-1] - 1).to(torch.int32)
