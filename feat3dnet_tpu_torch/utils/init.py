"""Seeded numpy initialisation of the flax variable tree.

Makes the same tree, with the same shapes and initialiser families, that
`Feat3DNet(cfg).init(...)` makes in the JAX package: lecun-normal kernels
(truncated normal, variance 1/fan_in), zero biases, unit BN scale and
variance, zero BN mean. It needs no JAX, so it serves on machines that
cannot run `model.init`. The draws are numpy's, not jax.random's.

`bn_perturb > 0` moves the BN statistics and affine parameters away from
identity (seeded), so that BN folding is actually exercised.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np

from feat3dnet_tpu_torch.config import ModelConfig

# flax variance_scaling: stddev of the unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(rng: np.random.RandomState, cin: int, cout: int) -> np.ndarray:
    std = np.sqrt(1.0 / cin) / _TRUNC_STD
    z = rng.standard_normal((cin, cout))
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (z * std).astype(np.float32)


def _layer_shapes(cfg: ModelConfig) -> Sequence[Tuple[str, str, int, int, bool]]:
    """(tower, name, cin, cout, is_convbn) for every Dense of the model."""
    out = []
    c = 3
    for i, f in enumerate(cfg.detector_mlp):
        out.append(("detection", f"conv{i}", c, f, True))
        c = f
    for i, f in enumerate(cfg.detector_mlp2):
        out.append(("detection", f"conv_post_{i}", c, f, True))
        c = f
    out.append(("detection", "attention", c, 1, False))
    out.append(("detection", "orientation", c, 2, False))
    c = 3
    for i, f in enumerate(cfg.descriptor_mlp):
        out.append(("description", f"conv{i}", c, f, True))
        c = f
    c *= 2
    for i, f in enumerate(cfg.descriptor_mlp2):
        out.append(("description", f"conv_mid_{i}", c, f, True))
        c = f
    for i, f in enumerate(cfg.descriptor_mlp3):
        out.append(("description", f"conv_post_{i}", c, f, True))
        c = f
    return out


def init_variables(cfg: ModelConfig, seed: int = 0, bn_perturb: float = 0.0
                   ) -> Dict[str, Any]:
    """{'params': ..., 'batch_stats': ...} as nested dicts of float32 arrays."""
    rng = np.random.RandomState(seed)
    params: Dict[str, Any] = {"detection": {}, "description": {}}
    stats: Dict[str, Any] = {"detection": {}, "description": {}}
    for tower, name, cin, cout, conv in _layer_shapes(cfg):
        dense = {"kernel": _lecun_normal(rng, cin, cout),
                 "bias": np.zeros((cout,), np.float32)}
        if not conv:                       # attention / orientation heads
            params[tower][name] = dense
            continue
        if not cfg.use_bn:
            params[tower][name] = {"conv2d": dense}
            continue
        scale = np.ones((cout,), np.float32)
        beta = np.zeros((cout,), np.float32)
        mean = np.zeros((cout,), np.float32)
        var = np.ones((cout,), np.float32)
        if bn_perturb > 0:
            scale = (scale + bn_perturb * rng.standard_normal(cout)).astype(np.float32)
            beta = (bn_perturb * rng.standard_normal(cout)).astype(np.float32)
            mean = (bn_perturb * rng.standard_normal(cout)).astype(np.float32)
            var = np.exp(bn_perturb * rng.standard_normal(cout)).astype(np.float32)
        params[tower][name] = {"conv2d": dense, "bn": {"scale": scale, "bias": beta}}
        stats[tower][name] = {"bn": {"mean": mean, "var": var}}
    out: Dict[str, Any] = {"params": params}
    if cfg.use_bn:
        out["batch_stats"] = stats
    return out
