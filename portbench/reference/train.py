"""The stage-2 training step in plain PyTorch (reference train.py:20-67, feat3dnet.py).

A batch is 3B clouds, anchors | positives | negatives, augmented on the
device, then: FPS centres (start at index 0, the farthest point by the
running minimum of ((dx*dx) + dy*dy) + dz*dz, first index on ties), the
first ns in-ball points of each, the detector and descriptor in training
form (batch moments shared by the three roles), the attention-weighted
triplet loss, autograd's gradients and Adam (b1 0.9, b2 0.999, eps 1e-8).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import model as M
from portbench.reference.extract import ball_indices

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64 farthest-point indices."""
    b, n, _ = xyz.shape
    out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    mind = torch.full((b, n), 1e38, device=xyz.device)
    last = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        d = (dx * dx + dy * dy) + dz * dz
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1, keepdim=True)
        out[:, j] = last[:, 0]
    return out


# ---- augmentation: the program draws each step's values from a CUDA
# generator seeded by (aug_seed, step); the same draws are made here ----

def aug_generator(device, aug_seed: int, step: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (aug_seed * 0x9E3779B97F4A7C15 + step) % (1 << 63))


def _rows3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _small_rotation(a: torch.Tensor) -> torch.Tensor:
    cx, sx = torch.cos(a[:, 0]), torch.sin(a[:, 0])
    cy, sy = torch.cos(a[:, 1]), torch.sin(a[:, 1])
    cz, sz = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    z, o = torch.zeros_like(cx), torch.ones_like(cx)
    rx = _rows3([(o, z, z), (z, cx, -sx), (z, sx, cx)])
    ry = _rows3([(cy, z, sy), (z, o, z), (-sy, z, cy)])
    rz = _rows3([(cz, -sz, z), (sz, cz, z), (z, z, o)])
    return torch.einsum("bij,bjk,bkl->bil", rz, ry, rx)


def _rot_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rows3([(c, s, z), (-s, c, z), (z, z, o)])


def augment(gen: torch.Generator, xyz: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
    """Jitter (sigma 0.01, clip 0.05), RotateSmall (sigma 0.06 rad, clip 0.18;
    R = Rz Ry Rx), Shift (uniform +-0.1 per cloud), RotateZ (uniform angle),
    Scale ([0.8, 1.25)); points are row vectors, p @ R."""
    b, dev = xyz.shape[0], xyz.device
    for name in names:
        if name == "Jitter":
            xyz = xyz + torch.clamp(0.01 * torch.randn(xyz.shape, generator=gen, device=dev),
                                    -0.05, 0.05)
        elif name == "Shift":
            xyz = xyz + (-0.1 + 0.2 * torch.rand((b, 1, 3), generator=gen, device=dev))
        elif name == "RotateZ":
            a = torch.rand((b,), generator=gen, device=dev) * (2.0 * math.pi)
            xyz = torch.einsum("bnd,bde->bne", xyz, _rot_z(a))
        elif name == "RotateSmall":
            a = torch.clamp(0.06 * torch.randn((b, 3), generator=gen, device=dev), -0.18, 0.18)
            xyz = torch.einsum("bnd,bde->bne", xyz, _small_rotation(a))
        elif name == "Scale":
            xyz = xyz * (0.8 + 0.45 * torch.rand((b, 1, 1), generator=gen, device=dev))
        else:
            raise KeyError(f"unknown augmentation {name!r}")
    return xyz


def forward_train(w: M.Weights, cfg: dict, clouds: torch.Tensor, raw: list = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3B, N, 3) clouds -> (features (3B, M, D), attention (3B, M)), training
    BatchNorm. `raw` collects the orientation head's raw output."""
    r, ns = float(cfg["base_scale"]), int(cfg["num_samples"])
    with torch.no_grad():
        centre_idx = fps(clouds, int(cfg["num_clusters"]))
        centers = torch.gather(clouds, 1, centre_idx[..., None].expand(-1, -1, 3))
        offs = torch.stack([clouds[i][ball_indices(clouds[i], centers[i], r, ns)]
                            - centers[i][:, None, :] for i in range(clouds.shape[0])])
        grouped = offs / r
        mask = torch.ones(grouped.shape[:-1], device=clouds.device)
    att, ori = M.detector(w, cfg, grouped, mask, training=True, raw=raw)
    angle = torch.atan2(ori[..., 1], ori[..., 0])
    feats = M.descriptor(w, cfg, M.rotate(grouped, torch.cos(angle), torch.sin(angle)), mask,
                         training=True)
    return feats, att


def triplet_loss(feats: torch.Tensor, att: torch.Tensor, margin: float) -> torch.Tensor:
    """Attention-weighted alignment triplet loss: per anchor descriptor the
    smallest squared distance (|a|^2 + |b|^2 - 2ab, clamped at 0) to the
    positive's and the negative's sets, weighted by the sum-normalised
    anchor attention, hinged at `margin`, averaged over the triplets."""
    a, p, n = torch.chunk(feats, 3, dim=0)
    w = torch.chunk(att, 3, dim=0)[0]
    w = w / w.sum(dim=1, keepdim=True)
    cost = (w * set_sqdist(a, p).amin(dim=2)).sum(1) \
        - (w * set_sqdist(a, n).amin(dim=2)).sum(1) + margin
    return torch.clamp(cost, min=0.0).mean()


def set_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N, D) x (B, M, D) -> (B, N, M): |x|^2 + |y|^2 - 2xy, clamped at 0."""
    d = (x * x).sum(-1, keepdim=True) + (y * y).sum(-1)[..., None, :] \
        - 2.0 * torch.einsum("bnd,bmd->bnm", x, y)
    return torch.clamp(d, min=0.0)


@torch.no_grad()
def near_ties(feats: torch.Tensor, rel: float = 1e-6) -> int:
    """Anchor descriptors whose two nearest in the positive's or the
    negative's set lie within `rel` of each other: where rounding can move
    the minimum's gradient to another descriptor."""
    a, p, n = torch.chunk(feats, 3, dim=0)
    count = 0
    for other in (p, n):
        two = torch.topk(set_sqdist(a, other), 2, dim=2, largest=False).values
        count += int(((two[..., 1] - two[..., 0]) <= rel * two[..., 1]).sum())
    return count


def train_steps(w0: M.Weights, cfg: dict, tcfg: dict, batches: List[torch.Tensor],
                aug_seed: int) -> Dict[str, object]:
    """Steps 1..len(batches) from weights `w0` on the (3B, N, 3) device
    batches: per step the loss; the first step's gradient per leaf; the
    leaves after the last step; the smallest norm of the first step's raw
    orientation vectors (where it nears 0 the normalisation's gradient, 1/|o|,
    makes every gradient upstream of it ill-conditioned) and the first step's
    near ties of the loss's minima (`near_ties`)."""
    names = M.param_names(cfg)
    w = {k: v.clone() for k, v in w0.items()}
    params = {k: w[k].requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    lr = float(tcfg["learning_rate"])
    losses, first_grad, raw = [], None, []
    with M.precision(False):
        for t, batch in enumerate(batches, start=1):
            clouds = batch
            if tcfg["augmentations"]:
                gen = aug_generator(batch.device, aug_seed, t - 1)
                clouds = augment(gen, batch, tcfg["augmentations"])
            feats, att = forward_train(w, cfg, clouds.contiguous(), raw if t == 1 else None)
            loss = triplet_loss(feats, att, float(cfg["margin"]))
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            losses.append(float(loss.detach()))
            if t == 1:
                ties = near_ties(feats.detach())
            if first_grad is None:
                first_grad = {k: g.detach().clone() for k, g in zip(names, grads)}
            with torch.no_grad():
                bc1, bc2 = 1.0 - BETA1 ** t, 1.0 - BETA2 ** t
                for k, g in zip(names, grads):
                    m[k].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                    v2[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                    denom = (v2[k].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                    params[k].addcdiv_(m[k], denom, value=-lr / bc1)
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: params[k].detach() for k in names},
            "min_orientation_norm": float(raw[0].norm(dim=-1).min()), "near_ties": ties}
