"""Fused cluster -> descriptor forward (port of feat3dnet_tpu/ops/fused_describe.py).

The serving path: batches of origin-centred clusters -> L2-normalised
descriptors and attention, the whole eval forward per cluster with eval BN
folded into the weights (BN(Wx+b) is affine: W' = W·γ·rsqrt(σ²+ε),
b' = (b−μ)·γ·rsqrt(σ²+ε)+β).

* `folded_weights` / `transpose_folded_weights`: the JAX package's weight
  lists, same order and the same K=3 -> 8 zero pad.
* `pack_clusters_lanes`: the (ns·8, B) host layout (numpy).
* `fused_describe_clusters_t_plain`: the plain version in that layout, the
  CPU path and the oracle for kernel K3.
* `fused_describe_clusters_t`: the wrapper of kernel K3
  (csrc/fused_describe.cu). The JAX package's `_kernel_2d` and `_kernel`
  compute the same thing in other TPU layouts; the port has this one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.config import ModelConfig


def _f32(x) -> torch.Tensor:
    """A float32 tensor from a tensor or (possibly read-only) numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _fold(params, stats, name, eps):
    k, b = _f32(params[name]["conv2d"]["kernel"]), _f32(params[name]["conv2d"]["bias"])
    scale = _f32(params[name]["bn"]["scale"]) * torch.rsqrt(_f32(stats[name]["bn"]["var"]) + eps)
    beta, mean = _f32(params[name]["bn"]["bias"]), _f32(stats[name]["bn"]["mean"])
    return k * scale[None, :], (b - mean) * scale + beta


def folded_weights(variables: Dict[str, Any], cfg: ModelConfig) -> List[torch.Tensor]:
    """Flatten a variable tree (numpy or tensors, flax layout) into the
    kernel's weight list, BN folded. Kernels stay (Cin, Cout).

    Order: detector convs, detector post convs, attention, orientation,
    descriptor convs, conv_mid_0, conv_post_0.
    """
    p, s = variables["params"], variables["batch_stats"]
    eps = cfg.bn_epsilon
    out: List[torch.Tensor] = []
    det_p, det_s = p["detection"], s["detection"]
    for i in range(len(cfg.detector_mlp)):
        out.extend(_fold(det_p, det_s, f"conv{i}", eps))
    for i in range(len(cfg.detector_mlp2)):
        out.extend(_fold(det_p, det_s, f"conv_post_{i}", eps))
    for head in ("attention", "orientation"):
        out.extend([_f32(det_p[head]["kernel"]), _f32(det_p[head]["bias"])])
    desc_p, desc_s = p["description"], s["description"]
    for i in range(len(cfg.descriptor_mlp)):
        out.extend(_fold(desc_p, desc_s, f"conv{i}", eps))
    out.extend(_fold(desc_p, desc_s, "conv_mid_0", eps))
    out.extend(_fold(desc_p, desc_s, "conv_post_0", eps))
    return out


def transpose_folded_weights(weights: List[torch.Tensor]) -> List[torch.Tensor]:
    """folded_weights() -> kernels (Cout, Cin) with K=3 inputs zero-padded to
    K=8 (the 8-row slot blocks); biases -> (Cout, 1) columns."""
    out: List[torch.Tensor] = []
    for i in range(0, len(weights), 2):
        kt = weights[i].t()
        if kt.shape[1] == 3:
            kt = torch.nn.functional.pad(kt, (0, 5))
        out.append(kt.contiguous())
        out.append(weights[i + 1][:, None].contiguous())
    return out


def pack_clusters_lanes(clusters: np.ndarray) -> np.ndarray:
    """Host packer: (B, ns, 3) float32 -> (ns·8, B); slot s occupies rows
    8s..8s+7, rows 0-2 = x/y/z, rows 3-7 zero."""
    b, ns, _ = clusters.shape
    out = np.zeros((ns, 8, b), np.float32)
    out[:, :3, :] = np.transpose(clusters[:, :, :3], (1, 2, 0))
    return out.reshape(ns * 8, b)


def pack_clusters_lanes_torch(clusters: torch.Tensor) -> torch.Tensor:
    """Device packer with the same layout: (B, ns, 3) -> (ns·8, B)."""
    b, ns, _ = clusters.shape
    out = torch.zeros((ns, 8, b), dtype=torch.float32, device=clusters.device)
    out[:, :3, :] = clusters[:, :, :3].permute(1, 2, 0)
    return out.reshape(ns * 8, b)


def _n_layers(cfg: ModelConfig) -> Tuple[int, int, int]:
    return len(cfg.detector_mlp), len(cfg.detector_mlp2), len(cfg.descriptor_mlp)


def fused_describe_clusters_t_plain(weights_t: List[torch.Tensor],
                                    clusters_p: torch.Tensor, cfg: ModelConfig
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (ns·8, B) packed clusters + transposed folded
    weights -> (descriptors (B, D), attention (B,)).

    Computes what the JAX `_kernel_t` computes, batched over slots: the
    activations are (ns, C, B) and every product is W (Cout, Cin) @ H.
    """
    rows, b = clusters_p.shape
    ns = rows // 8
    x = clusters_p.to(torch.float32).reshape(ns, 8, b)
    dev = x.device
    r = torch.tensor(cfg.base_scale, dtype=torch.float32, device=dev)
    r2 = r * r
    inv_r = 1.0 / r
    ws = iter(weights_t)

    def next_w():
        return next(ws), next(ws)

    # membership: d2 = (x*x + y*y) + z*z, strict d2 < r^2; an empty cluster
    # keeps the first slot at the minimum distance
    d2 = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
    d2 = d2 + x[:, 2] * x[:, 2]                                  # (ns, B)
    in_ball = (d2 < r2).to(torch.float32)
    empty = (in_ball.sum(0, keepdim=True) < 0.5).to(torch.float32)
    dmin = d2.min(0, keepdim=True).values
    slots = torch.arange(ns, device=dev)[:, None].expand(ns, b)
    first = torch.where(d2 <= dmin, slots, ns).min(0, keepdim=True).values
    mask = torch.clamp(in_ball + empty * (slots == first).to(torch.float32), max=1.0)
    mask3 = mask[:, None, :]                                     # (ns, 1, B)

    xs = x * inv_r                                               # (ns, 8, B)
    n_det, n_det2, n_desc = _n_layers(cfg)
    h = xs
    for _ in range(n_det):
        k, bias = next_w()
        h = torch.relu(torch.matmul(k, h) + bias)
    g = (h * mask3).amax(0)                                      # (C, B)
    for _ in range(n_det2):
        k, bias = next_w()
        g = torch.relu(k @ g + bias)
    ka, ba = next_w()
    att = torch.logaddexp(ka @ g + ba, torch.zeros((), dtype=torch.float32, device=dev))
    ko, bo = next_w()
    ori = ko @ g + bo                                            # (2, B)
    ori = ori * torch.rsqrt(torch.clamp((ori * ori).sum(0, keepdim=True), min=1e-8))
    c_r, s_r = ori[0:1], ori[1:2]

    xr = xs[:, 0] * c_r - xs[:, 1] * s_r
    yr = xs[:, 0] * s_r + xs[:, 1] * c_r
    h = torch.cat([xr[:, None], yr[:, None], xs[:, 2:]], dim=1)  # (ns, 8, B)
    for _ in range(n_desc):
        k, bias = next_w()
        h = torch.relu(torch.matmul(k, h) + bias)
    dpool = (h * mask3).amax(0, keepdim=True)                    # (1, C, B)
    cat = torch.cat([h, dpool.expand_as(h)], dim=1)              # (ns, 2C, B)
    km, bm = next_w()
    y = torch.matmul(km, cat) + bm                               # no ReLU
    y = torch.where(mask3 > 0.5, y, torch.tensor(-1.0e30, dtype=torch.float32, device=dev))
    m = y.amax(0)
    kp, bp = next_w()
    out = kp @ m + bp                                            # (D, B)
    out = out * torch.rsqrt(torch.clamp((out * out).sum(0, keepdim=True), min=1e-8))
    return out.t().contiguous(), att[0]


# per-slot layer widths the kernel is instantiated for (csrc/fused_describe.cu)
_SLOT_WIDTHS = (32, 64, 128, 256)


def _kernel_weights(weights_t: List[torch.Tensor], cfg: ModelConfig, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (Cin, Cout) weight buffer + (cin, cout, w_off, b_off) table for
    the kernel. K-padded first layers keep 4 input rows (x, y, z, 0). Every
    block starts on a 16-byte boundary (the kernel reads W as float4)."""
    n_det, n_det2, n_desc = _n_layers(cfg)
    if len(weights_t) != 2 * (n_det + n_det2 + 2 + n_desc + 2):
        raise ValueError(f"fused_describe: {len(weights_t)} weight tensors do not "
                         "match the config's tower")
    slot_layers = (set(range(n_det))
                   | set(range(n_det + n_det2 + 2, n_det + n_det2 + 2 + n_desc + 1)))
    pieces, table, off = [], [], 0
    for li in range(len(weights_t) // 2):
        kt, b = weights_t[2 * li], weights_t[2 * li + 1]
        w = kt.t()
        if w.shape[0] == 8:
            w = w[:4]                       # rows 3..7 are the zero pad
        cin, cout = w.shape
        if li in slot_layers and (cout not in _SLOT_WIDTHS or cin % 4):
            raise ValueError(f"fused_describe: per-slot layer {li} is {cin}->{cout}; "
                             f"the kernel takes Cout in {_SLOT_WIDTHS}, Cin % 4 == 0")
        if cout > 256:
            raise ValueError(f"fused_describe: layer {li} wider than 256")
        b_off = off + cin * cout                # a multiple of 4: Cout is, or Cin = 4
        table.append((cin, cout, off, b_off))
        pad = -cout % 4
        pieces += [w.reshape(-1), b.reshape(-1), w.new_zeros(pad)]
        off = b_off + cout + pad
    flat = torch.cat(pieces).to(device=device, dtype=torch.float32).contiguous()
    return flat, torch.tensor(table, dtype=torch.int32)


def fused_describe_clusters_t(weights_t: List[torch.Tensor], clusters_p: torch.Tensor,
                              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving forward through kernel K3: (ns·8, B) packed clusters
    (pack_clusters_lanes) + transpose_folded_weights(folded_weights(...))
    -> (descriptors (B, D), attention (B,)).

    CPU tensors take `fused_describe_clusters_t_plain`; CUDA tensors launch
    the kernel, and anything it does not take raises.
    """
    if clusters_p.device.type == "cpu":
        return fused_describe_clusters_t_plain(weights_t, clusters_p, cfg)
    if clusters_p.device.type != "cuda":
        raise ValueError(f"fused_describe_clusters_t: unsupported device "
                         f"{clusters_p.device}")
    if clusters_p.dtype != torch.float32 or clusters_p.dim() != 2:
        raise ValueError(f"fused_describe_clusters_t: want (ns*8, B) float32, got "
                         f"{tuple(clusters_p.shape)} {clusters_p.dtype}")
    if not clusters_p.is_contiguous():
        raise ValueError("fused_describe_clusters_t: clusters must be contiguous")
    rows, b = clusters_p.shape
    ns = rows // 8
    if rows != 8 * ns or ns != cfg.num_samples or not 1 <= ns <= 64:
        raise ValueError(f"fused_describe_clusters_t: {rows} rows is not 8 x "
                         f"num_samples={cfg.num_samples} (<= 64)")
    flat, table = _kernel_weights(weights_t, cfg, clusters_p.device)
    n_det, n_det2, n_desc = _n_layers(cfg)
    r = np.float32(cfg.base_scale)
    desc = torch.empty((b, cfg.feature_dim), dtype=torch.float32, device=clusters_p.device)
    att = torch.empty((b,), dtype=torch.float32, device=clusters_p.device)
    kernels.launch_fused_describe(clusters_p, ns, flat, table, n_det, n_det2, n_desc,
                                  float(r * r), float(np.float32(1.0) / r), desc, att)
    fused_describe_clusters_t.launches += 1
    return desc, att


fused_describe_clusters_t.launches = 0
fused_describe_clusters_t.plain = fused_describe_clusters_t_plain
