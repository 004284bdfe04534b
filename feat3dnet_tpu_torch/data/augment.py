"""Point-cloud augmentation on the device (port of feat3dnet_tpu/data/augment.py).

The six augmentations of the reference (Jitter sigma 0.01 clipped at 0.05;
Shift uniform in +-0.1 per cloud; RotateZ / RotateY a uniform angle in
[0, 2 pi); RotateSmall three angles of sigma 0.06 rad clipped at 0.18,
R = Rz Ry Rx; Scale uniform in [0.8, 1.25)) with the JAX package's matrix
conventions (points @ R). Each is a `draw` from an explicit
torch.Generator and an `apply` of the drawn values, so tests can give both
frameworks the same numbers: a torch.Generator and jax.random draw
different ones from the same seed. `jitter`, `shift`, `rotate_z`,
`rotate_y`, `rotate_small` and `scale` are the JAX package's one-step
functions, each a draw and its apply.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch


def _rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def _stack3(rows) -> torch.Tensor:
    """Rows of three (B,) tensors -> (B, 3, 3)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 3, 3) with rows [c, s, 0], [-s, c, 0], [0, 0, 1]."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack3([(c, s, z), (-s, c, z), (z, z, o)])


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 3, 3) with rows [c, 0, s], [0, 1, 0], [-s, 0, c]."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack3([(c, z, s), (z, o, z), (-s, z, c)])


def small_rotation(angles: torch.Tensor) -> torch.Tensor:
    """(B, 3) angles about x, y, z -> R = Rz Ry Rx (column-vector matrices)."""
    cx, sx = torch.cos(angles[:, 0]), torch.sin(angles[:, 0])
    cy, sy = torch.cos(angles[:, 1]), torch.sin(angles[:, 1])
    cz, sz = torch.cos(angles[:, 2]), torch.sin(angles[:, 2])
    z, o = torch.zeros_like(cx), torch.ones_like(cx)
    rx = _stack3([(o, z, z), (z, cx, -sx), (z, sx, cx)])
    ry = _stack3([(cy, z, sy), (z, o, z), (-sy, z, cy)])
    rz = _stack3([(cz, -sz, z), (sz, cz, z), (z, z, o)])
    return torch.einsum("bij,bjk,bkl->bil", rz, ry, rx)


def _rotate(xyz: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnd,bde->bne", xyz, r)


def draw_jitter(gen, xyz, sigma: float = 0.01, clip: float = 0.05):
    return torch.clamp(sigma * _randn(gen, xyz.shape, xyz.device), -clip, clip)


def draw_shift(gen, xyz, shift_range: float = 0.1):
    return -shift_range + 2.0 * shift_range * _rand(gen, (xyz.shape[0], 1, 3), xyz.device)


def draw_angle(gen, xyz):
    return _rand(gen, (xyz.shape[0],), xyz.device) * (2.0 * math.pi)


def draw_small_angles(gen, xyz, angle_sigma: float = 0.06, angle_clip: float = 0.18):
    return torch.clamp(angle_sigma * _randn(gen, (xyz.shape[0], 3), xyz.device),
                       -angle_clip, angle_clip)


def draw_scale(gen, xyz, low: float = 0.8, high: float = 1.25):
    return low + (high - low) * _rand(gen, (xyz.shape[0], 1, 1), xyz.device)


# name -> (draw(gen, xyz) -> values, apply(xyz, values) -> xyz)
AUGMENTATIONS: Dict[str, Tuple[Callable, Callable]] = {
    "Jitter": (draw_jitter, lambda xyz, v: xyz + v),
    "Shift": (draw_shift, lambda xyz, v: xyz + v),
    "RotateZ": (draw_angle, lambda xyz, v: _rotate(xyz, rot_z(v))),
    "RotateY": (draw_angle, lambda xyz, v: _rotate(xyz, rot_y(v))),
    "RotateSmall": (draw_small_angles, lambda xyz, v: _rotate(xyz, small_rotation(v))),
    "Scale": (draw_scale, lambda xyz, v: xyz * v),
}


def _one(name: str, gen: torch.Generator, xyz: torch.Tensor, **kw) -> torch.Tensor:
    draw, apply = AUGMENTATIONS[name]
    return apply(xyz, draw(gen, xyz, **kw))


# The JAX package's one-augmentation functions, a generator in place of its
# key: each is AUGMENTATIONS[name]'s apply of its draw, so at the default
# arguments it equals augment_clouds(gen, xyz, [name]) bit for bit.

def jitter(gen: torch.Generator, xyz: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    return _one("Jitter", gen, xyz, sigma=sigma, clip=clip)


def shift(gen: torch.Generator, xyz: torch.Tensor, shift_range: float = 0.1) -> torch.Tensor:
    return _one("Shift", gen, xyz, shift_range=shift_range)


def rotate_z(gen: torch.Generator, xyz: torch.Tensor) -> torch.Tensor:
    return _one("RotateZ", gen, xyz)


def rotate_y(gen: torch.Generator, xyz: torch.Tensor) -> torch.Tensor:
    return _one("RotateY", gen, xyz)


def rotate_small(gen: torch.Generator, xyz: torch.Tensor, angle_sigma: float = 0.06,
                 angle_clip: float = 0.18) -> torch.Tensor:
    return _one("RotateSmall", gen, xyz, angle_sigma=angle_sigma, angle_clip=angle_clip)


def scale(gen: torch.Generator, xyz: torch.Tensor, low: float = 0.8,
          high: float = 1.25) -> torch.Tensor:
    return _one("Scale", gen, xyz, low=low, high=high)


def resolve_augmentations(names: Sequence[str], upright_axis: int = 2) -> Sequence[str]:
    """Reference CLI names -> augmentation keys; 'Rotate1D' is RotateZ for
    z-up (upright_axis=2) and RotateY otherwise."""
    out = []
    for n in names:
        if n == "Rotate1D":
            out.append("RotateZ" if upright_axis == 2 else "RotateY")
        elif n in AUGMENTATIONS:
            out.append(n)
        else:
            raise KeyError(f"Unknown augmentation {n!r}")
    return out


def augment_clouds(gen: torch.Generator, xyz: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
    """Apply the chain in order, each cloud of the (B, N, 3) batch with its
    own draws; `gen` lives on xyz's device."""
    for name in names:
        draw, apply = AUGMENTATIONS[name]
        xyz = apply(xyz, draw(gen, xyz))
    return xyz


def augment_rows(gen: torch.Generator, xyz: torch.Tensor, names: Sequence[str],
                 rows: torch.Tensor, total: int) -> torch.Tensor:
    """`augment_clouds` of a `total`-cloud batch, for the clouds `rows` of it
    that `xyz` holds: every augmentation draws the whole batch's values, as
    `augment_clouds` draws them, and applies the rows' own. A data-parallel
    rank's clouds thus get the values the single process gives them."""
    whole = xyz[:1].expand((total,) + tuple(xyz.shape[1:]))
    for name in names:
        draw, apply = AUGMENTATIONS[name]
        xyz = apply(xyz, draw(gen, whole)[rows])
    return xyz
