"""The 3DFeat-Net towers in plain PyTorch, f32, eval and training forms.

Weights are a flat dict keyed by the reference's scope names
(`detection.conv0.conv2d.weight`, `...bn.scale`, ...), kernels as
(Cout, Cin). Every Dense is `x @ W.T + b`; BatchNorm normalises with the
running statistics in eval and with the batch moments (biased variance,
mean(x^2) - mean(x)^2) in training, epsilon 1e-3; ReLU after BN except the
descriptor's mid and last layers. Clusters are (..., ns, 3) offsets from
their centre, in metres.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

Weights = Dict[str, torch.Tensor]

BN_EPS = 1e-3


def layer_specs(cfg: dict) -> List[Tuple[str, int, int, bool]]:
    """(scope, cin, cout, has_bn) of every Dense of the model, in order."""
    det, det2 = cfg["detector_mlp"], cfg["detector_mlp2"]
    desc, mid, post = cfg["descriptor_mlp"], cfg["descriptor_mlp2"], cfg["descriptor_mlp3"]
    out = []
    cin = 3
    for i, c in enumerate(det):
        out.append((f"detection.conv{i}", cin, c, True))
        cin = c
    for i, c in enumerate(det2):
        out.append((f"detection.conv_post_{i}", cin, c, True))
        cin = c
    out.append(("detection.attention", cin, 1, False))
    out.append(("detection.orientation", cin, 2, False))
    cin = 3
    for i, c in enumerate(desc):
        out.append((f"description.conv{i}", cin, c, True))
        cin = c
    cin *= 2
    for i, c in enumerate(mid):
        out.append((f"description.conv_mid_{i}", cin, c, True))
        cin = c
    for i, c in enumerate(post):
        out.append((f"description.conv_post_{i}", cin, c, True))
        cin = c
    return out


def _dense_key(scope: str, has_bn: bool) -> str:
    return f"{scope}.conv2d" if has_bn else scope


def param_names(cfg: dict) -> List[str]:
    """The trainable leaves, in the model's order."""
    names = []
    for scope, _, _, bn in layer_specs(cfg):
        d = _dense_key(scope, bn)
        names += [f"{d}.weight", f"{d}.bias"]
        if bn:
            names += [f"{scope}.bn.scale", f"{scope}.bn.bias"]
    return names


def make_weights(cfg: dict, seed: int, device) -> Weights:
    """Seeded weights in one draw on `device`: kernels N(0, 1/fan_in) (flax's
    LeCun normal without truncation), biases 0, BN scale 1 / bias 0,
    running mean 0 / var 1."""
    specs = layer_specs(cfg)
    total = sum(cin * cout for _, cin, cout, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    w: Weights = {}
    off = 0
    for scope, cin, cout, bn in specs:
        d = _dense_key(scope, bn)
        w[f"{d}.weight"] = (flat[off:off + cin * cout].view(cout, cin)
                            * (1.0 / math.sqrt(cin))).contiguous()
        off += cin * cout
        w[f"{d}.bias"] = torch.zeros(cout, device=device)
        if bn:
            w[f"{scope}.bn.scale"] = torch.ones(cout, device=device)
            w[f"{scope}.bn.bias"] = torch.zeros(cout, device=device)
            w[f"{scope}.bn.mean"] = torch.zeros(cout, device=device)
            w[f"{scope}.bn.var"] = torch.ones(cout, device=device)
    return w


def weights_from_npz(path: str, cfg: dict, device) -> Weights:
    """A flax-layout variable file (`params/<scope>/conv2d/kernel` (Cin, Cout),
    `batch_stats/<scope>/bn/mean`, ...) as reference weights."""
    z = np.load(path)
    w: Weights = {}
    for scope, cin, cout, bn in layer_specs(cfg):
        s = scope.replace(".", "/")
        d = f"params/{s}/conv2d" if bn else f"params/{s}"
        w[f"{_dense_key(scope, bn)}.weight"] = torch.from_numpy(
            np.ascontiguousarray(z[f"{d}/kernel"].T, np.float32)).to(device)
        w[f"{_dense_key(scope, bn)}.bias"] = torch.from_numpy(
            np.asarray(z[f"{d}/bias"], np.float32)).to(device)
        if bn:
            for leaf, col in (("scale", "params"), ("bias", "params"),
                              ("mean", "batch_stats"), ("var", "batch_stats")):
                w[f"{scope}.bn.{leaf}"] = torch.from_numpy(
                    np.asarray(z[f"{col}/{s}/bn/{leaf}"], np.float32)).to(device)
    return w


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """Products in f32 (TF32 off), or in TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dense(w: Weights, key: str, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w[f"{key}.weight"].t()) + w[f"{key}.bias"]


def conv_bn(w: Weights, scope: str, x: torch.Tensor, relu: bool, training: bool
            ) -> torch.Tensor:
    """Dense, BatchNorm (batch moments over every leading axis in training),
    optional ReLU."""
    v = dense(w, f"{scope}.conv2d", x)
    if training:
        axes = tuple(range(v.dim() - 1))
        mean = v.mean(dim=axes)
        var = torch.clamp((v * v).mean(dim=axes) - mean * mean, min=0.0)
    else:
        mean, var = w[f"{scope}.bn.mean"], w[f"{scope}.bn.var"]
    y = (v - mean) * (torch.rsqrt(var + BN_EPS) * w[f"{scope}.bn.scale"]) + w[f"{scope}.bn.bias"]
    return torch.relu(y) if relu else y


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=1e-8))


def membership(offs: torch.Tensor, radius: float) -> torch.Tensor:
    """(..., ns, 3) offsets -> (..., ns) f32 mask: d2 = (x*x + y*y) + z*z < r^2
    (r^2 rounded in f32); an empty cluster keeps its first slot at the
    smallest d2."""
    x, y, z = offs[..., 0], offs[..., 1], offs[..., 2]
    d2 = (x * x + y * y) + z * z
    r2 = float(np.float32(radius) * np.float32(radius))
    inside = d2 < r2
    empty = ~inside.any(dim=-1, keepdim=True)
    ns = offs.shape[-2]
    slots = torch.arange(ns, device=offs.device).expand_as(d2)
    first = torch.where(d2 <= d2.min(dim=-1, keepdim=True).values, slots, ns)
    first = first.min(dim=-1, keepdim=True).values
    return (inside | (empty & (slots == first))).to(torch.float32)


def detector(w: Weights, cfg: dict, xs: torch.Tensor, mask: torch.Tensor,
             training: bool = False, raw: list = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., ns, 3) radius-normalised clusters and their (..., ns) mask ->
    (attention (...), unit orientation 2-vector (..., 2)). `raw` collects
    the orientation head's output before it is normalised."""
    h = xs
    for i in range(len(cfg["detector_mlp"])):
        h = conv_bn(w, f"detection.conv{i}", h, True, training)
    g = (h * mask[..., None]).amax(dim=-2)
    for i in range(len(cfg["detector_mlp2"])):
        g = conv_bn(w, f"detection.conv_post_{i}", g, True, training)
    a = dense(w, "detection.attention", g)[..., 0]
    att = torch.logaddexp(a, torch.zeros((), device=a.device))
    o = dense(w, "detection.orientation", g)
    if raw is not None:
        raw.append(o.detach())
    return att, l2_normalize(o)


def rotate(xs: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rotate (..., ns, 3) by the (...) angle's cos / sin about z: x' = x c - y s,
    y' = x s + y c."""
    c, s = c[..., None], s[..., None]
    x, y = xs[..., 0], xs[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c, xs[..., 2]], dim=-1)


def descriptor(w: Weights, cfg: dict, xr: torch.Tensor, mask: torch.Tensor,
               training: bool = False) -> torch.Tensor:
    """(..., ns, 3) rotated normalised clusters and mask -> (..., D) unit descriptors."""
    h = xr
    for i in range(len(cfg["descriptor_mlp"])):
        h = conv_bn(w, f"description.conv{i}", h, True, training)
    pool = (h * mask[..., None]).amax(dim=-2, keepdim=True)
    h = torch.cat([h, pool.expand_as(h)], dim=-1)
    for i in range(len(cfg["descriptor_mlp2"])):
        h = conv_bn(w, f"description.conv_mid_{i}", h, False, training)
    h = torch.where(mask[..., None] > 0.5, h, torch.full_like(h, -1.0e30)).amax(dim=-2)
    for i in range(len(cfg["descriptor_mlp3"])):
        h = conv_bn(w, f"description.conv_post_{i}", h, False, training)
    return l2_normalize(h)


@torch.no_grad()
def describe_clusters(w: Weights, cfg: dict, offs: torch.Tensor, chunk: int = 2048
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval forward on (B, ns, 3) origin-centred clusters -> (descriptors (B, D),
    attention (B,)): membership, detector, rotation by the orientation
    vector, descriptor; in blocks of `chunk` clusters."""
    r = float(cfg["base_scale"])
    descs, atts = [], []
    for c0 in range(0, offs.shape[0], chunk):
        x = offs[c0:c0 + chunk].to(torch.float32)
        mask = membership(x, r)
        xs = x / r
        att, ori = detector(w, cfg, xs, mask)
        descs.append(descriptor(w, cfg, rotate(xs, ori[..., 0], ori[..., 1]), mask))
        atts.append(att)
    return torch.cat(descs), torch.cat(atts)


@torch.no_grad()
def detect_clusters(w: Weights, cfg: dict, offs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval detector on (B, ns, 3) origin-centred clusters -> (attention (B,),
    unit orientation (B, 2))."""
    x = offs.to(torch.float32)
    return detector(w, cfg, x / float(cfg["base_scale"]), membership(x, cfg["base_scale"]))
