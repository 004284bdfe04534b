"""Rigid-transform estimation and batched RANSAC (port of feat3dnet_tpu/eval/ransac.py).

Reference: scripts/external/ransacfitRt.m (3-point minimal rigid fit inside
a generic ransac.m hypothesis loop) and estimateRigidTransform.m. Every
hypothesis is scored at once: K correspondence triples drawn as a Gumbel
top-3 over the valid matches, K Kabsch fits in one batched SVD, all K x N
residuals in one broadcast, then a refit on the best hypothesis's inliers.

The draw comes from an explicit torch.Generator, so it differs from JAX's
threefry draw; `hypotheses=` takes the (K, 3) triples instead (the tests
give both sides the same ones). torch.linalg.svd may pick other signs for
U and V than JAX's; R is the same wherever the singular values differ.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class RigidTransform(NamedTuple):
    rotation: torch.Tensor      # (3, 3)
    translation: torch.Tensor   # (3,)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return pts @ self.rotation.T + self.translation


def estimate_rigid_transform(src: torch.Tensor, dst: torch.Tensor,
                             weights: Optional[torch.Tensor] = None) -> RigidTransform:
    """Weighted least-squares rigid fit dst ≈ R @ src + t (Kabsch via SVD);
    leading batch dims allowed."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None] / torch.clamp(weights.sum(dim=-1, keepdim=True)[..., None],
                                         min=1e-12)
    src_c = (src * w).sum(dim=-2, keepdim=True)
    dst_c = (dst * w).sum(dim=-2, keepdim=True)
    cov = torch.einsum("...ni,...nj,...n->...ij", dst - dst_c, src - src_c, weights)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    fix = torch.cat([torch.ones(det.shape + (2,), dtype=src.dtype, device=src.device),
                     det[..., None]], dim=-1)
    r = torch.einsum("...ij,...j,...jk->...ik", u, fix, vt)
    t = dst_c[..., 0, :] - torch.einsum("...ij,...j->...i", r, src_c[..., 0, :])
    return RigidTransform(r, t)


def ransac_rigid(generator: Optional[torch.Generator], src: torch.Tensor, dst: torch.Tensor,
                 inlier_threshold: float = 1.0, num_hypotheses: int = 1024,
                 valid: Optional[torch.Tensor] = None,
                 hypotheses: Optional[torch.Tensor] = None
                 ) -> Tuple[RigidTransform, torch.Tensor, torch.Tensor]:
    """Batched rigid RANSAC over (N, 3) matched points src -> dst.

    generator: draws the triples on src's device (None only with
    `hypotheses`); inlier_threshold in metres (reference: 1.0); valid: (N,)
    bool mask of usable matches. Returns (the refit transform, the inlier
    mask (N,), the inlier count).
    """
    n = src.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=src.device)
    if hypotheses is None:
        # K triples of distinct valid matches: a Gumbel top-3 each
        u = torch.rand((num_hypotheses, n), generator=generator, device=src.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        logits = torch.where(valid, 0.0, float("-inf"))
        idx = torch.topk(gumbel + logits[None, :], 3, dim=1).indices          # (K, 3)
    else:
        idx = torch.as_tensor(hypotheses, device=src.device).long()
    hyp = estimate_rigid_transform(src[idx], dst[idx])                 # (K, ...)
    pred = torch.einsum("kij,nj->kni", hyp.rotation, src) + hyp.translation[:, None, :]
    resid = torch.linalg.vector_norm(pred - dst[None], dim=-1)         # (K, N)
    inl = (resid < inlier_threshold) & valid[None, :]
    best = torch.argmax(inl.sum(dim=-1))                               # first of the best

    refit = estimate_rigid_transform(src, dst, weights=inl[best].to(src.dtype))
    pred = src @ refit.rotation.T + refit.translation
    final = (torch.linalg.vector_norm(pred - dst, dim=-1) < inlier_threshold) & valid
    return refit, final, final.sum()
