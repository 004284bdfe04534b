"""Fused cluster towers (port of feat3dnet_tpu/ops/fused_describe.py).

The serving path: batches of origin-centred clusters -> L2-normalised
descriptors and attention, the whole eval forward per cluster with eval BN
folded into the weights (BN(Wx+b) is affine: W' = W·γ·rsqrt(σ²+ε),
b' = (b−μ)·γ·rsqrt(σ²+ε)+β).

* `folded_weights` / `transpose_folded_weights`: the JAX package's weight
  lists, same order and the same K=3 -> 8 zero pad.
* `pack_clusters_lanes`: the (ns·8, B) host layout (numpy).
* `fused_describe_clusters_t_plain`: the plain version in that layout, the
  CPU path and the oracle for kernel K3, in f32, in bf16 activations
  (`bf16_act`) and as the stream-only / matmul-only decomposition bodies
  of `_ablate_kernel_t` and `_ablate_kernel_2d` (`ablate`).
* `fused_describe_clusters_t`: the wrapper of kernel K3
  (csrc/fused_describe.cu), the same modes. The JAX package's `_kernel_2d`
  and `_kernel` compute the same thing in other TPU layouts (their
  `bf16_matmul` equals `bf16_act`); the port has this one.
* `fused_describe_clusters`: the JAX entry on (B, ns, 3) clusters and
  untransposed weights; it packs both and calls `fused_describe_clusters_t`.
* `detector_weights_unfolded` / `transpose_unfolded_detector`: the
  detector's weights with BN NOT folded (the extraction's attention pass
  must round like the model path), and `fused_detect_clusters`, the
  wrapper of kernel K6 (csrc/fused_detect.cu), with its plain version, on
  folded weights (the default), unfolded ones, or unfolded ones with bf16
  operands.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models.layers import fold_bn
from feat3dnet_tpu_torch.utils.profiling import spanned


def _f32(x) -> torch.Tensor:
    """A float32 tensor from a tensor or (possibly read-only) numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _fold(params, stats, name, eps):
    conv, bn = params[name]["conv2d"], params[name]["bn"]
    return fold_bn(_f32(conv["kernel"]), _f32(conv["bias"]), _f32(bn["scale"]),
                   _f32(bn["bias"]), _f32(stats[name]["bn"]["mean"]),
                   _f32(stats[name]["bn"]["var"]), eps)


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


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 (ties to even) and back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


_ABLATE = ("stream", "matmul", "matmul_2d")


def _describe_mode(bf16_act: bool, ablate: Optional[str]) -> str:
    """K3's mode: 'f32', 'bf16', 'stream', 'matmul' or 'matmul_2d'. Raises on
    an unknown `ablate` and on bf16_act together with ablate."""
    if ablate is not None and ablate not in _ABLATE:
        raise ValueError(f"fused_describe_clusters_t: ablate must be None or one of "
                         f"{_ABLATE}, got {ablate!r}")
    if ablate is not None and bf16_act:
        raise ValueError("fused_describe_clusters_t: bf16_act and ablate exclude each other")
    return ablate or ("bf16" if bf16_act else "f32")


def fused_describe_clusters_t_plain(weights_t: List[torch.Tensor],
                                    clusters_p: torch.Tensor, cfg: ModelConfig,
                                    bf16_act: bool = False, ablate: Optional[str] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (ns·8, B) packed clusters + transposed folded
    weights -> (descriptors (B, D), attention (B,)).

    Computes what the JAX `_kernel_t` computes, batched over slots: the
    activations are (ns, C, B) and every product is W (Cout, Cin) @ H.
    bf16_act: every kernel matrix, the scaled input, every ReLU output, the
    rotated coordinates and the mid conv's output are rounded to bf16, so
    each product takes bf16 operands and sums in f32 (`_kernel_t`'s
    bf16_act). ablate: the time-decomposition bodies, whose outputs are not
    descriptors: 'stream' (what `_ablate_kernel_t` and `_ablate_kernel_2d`
    both compute), 'matmul' (`_ablate_kernel_t`'s) and 'matmul_2d'
    (`_ablate_kernel_2d`'s), their two pooled convs on TF32-rounded
    operands as the kernel runs them (`_describe_ablate_plain`).
    """
    mode = _describe_mode(bf16_act, ablate)
    rows, b = clusters_p.shape
    ns = rows // 8
    x = clusters_p.to(torch.float32).reshape(ns, 8, b)
    if mode in _ABLATE:
        return _describe_ablate_plain(weights_t, x, cfg, mode)
    dev = x.device
    act = _round_bf16 if bf16_act else _identity
    r = torch.tensor(cfg.base_scale, dtype=torch.float32, device=dev)
    r2 = r * r
    inv_r = 1.0 / r
    ws = iter(weights_t)

    def next_w():
        return act(next(ws)), next(ws)

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
    h = act(xs)
    for _ in range(n_det):
        k, bias = next_w()
        h = act(torch.relu(torch.matmul(k, h) + bias))
    g = (h * mask3).amax(0)                                      # (C, B)
    for _ in range(n_det2):
        k, bias = next_w()
        g = act(torch.relu(k @ g + bias))
    ka, ba = next_w()
    att = torch.logaddexp(ka @ g + ba, torch.zeros((), dtype=torch.float32, device=dev))
    ko, bo = next_w()
    ori = ko @ g + bo                                            # (2, B)
    ori = ori * torch.rsqrt(torch.clamp((ori * ori).sum(0, keepdim=True), min=1e-8))
    c_r, s_r = ori[0:1], ori[1:2]

    xr = xs[:, 0] * c_r - xs[:, 1] * s_r
    yr = xs[:, 0] * s_r + xs[:, 1] * c_r
    h = act(torch.cat([xr[:, None], yr[:, None], xs[:, 2:]], dim=1))  # (ns, 8, B)
    for _ in range(n_desc):
        k, bias = next_w()
        h = act(torch.relu(torch.matmul(k, h) + bias))
    dpool = (h * mask3).amax(0, keepdim=True)                    # (1, C, B)
    cat = torch.cat([h, dpool.expand_as(h)], dim=1)              # (ns, 2C, B)
    km, bm = next_w()
    y = act(torch.matmul(km, cat) + bm)                          # no ReLU
    y = torch.where(mask3 > 0.5, y, torch.tensor(-1.0e30, dtype=torch.float32, device=dev))
    m = y.amax(0)
    kp, bp = next_w()
    out = kp @ m + bp                                            # (D, B)
    out = out * torch.rsqrt(torch.clamp((out * out).sum(0, keepdim=True), min=1e-8))
    return out.t().contiguous(), att[0]


# The matmul bodies against the same function in f32 (`_describe_ablate_plain`
# with tf32=False, what the JAX bodies compute on the CPU), as a share of
# max|ref| over each output: a product of two TF32-rounded operands lies
# within 2^-10 of the exact product, every output of a body passes through
# one pooled conv, and the factor 2 leaves room for cancellation. On the
# CPU, seeded weights at the paper widths and at the tests' small widths
# read 2.2e-4 - 7.1e-4; the trained weights, on which no check runs the
# bodies, cancel more (4.5e-3).
ABLATE_F32_LIMIT = 2.0 ** -9


def _describe_ablate_plain(weights_t: List[torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                           mode: str, tf32: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decomposition bodies on (ns, 8, B) slot blocks. 'stream': desc[b,
    :] = x of slot 0, att[b] = y of slot 0. 'matmul' (`_ablate_kernel_t`):
    every product of the forward on the raw coordinates, with no
    membership, ReLU, mask or rotation and the pools as sums over the
    slots (each slot's bias counted); the descriptor's pool is summed in
    slot order, as the kernel sums it. 'matmul_2d' (`_ablate_kernel_2d`):
    the same products, each pool taken as slot 0's row and the mid conv fed
    [d_s ; d_s].
    tf32: both operands of the two pooled convs (the detector's top conv,
    the mid conv) rounded to TF32 (`_tf32_rna`) and summed in f32, as the
    kernel runs them on the forward's 1xTF32 tensor-core tiles; False: all
    f32 (what the JAX bodies compute on the CPU)."""
    b = x.shape[2]
    if mode == "stream":
        return x[0, 0][:, None].expand(b, cfg.feature_dim).contiguous(), x[0, 1].clone()
    ws = iter(weights_t)
    rnd = _tf32_rna if tf32 else _identity

    def next_w():
        return next(ws), next(ws)

    n_det, n_det2, n_desc = _n_layers(cfg)
    h = x
    for i in range(n_det):
        k, bias = next_w()
        h = (torch.matmul(rnd(k), rnd(h)) if i == n_det - 1 else torch.matmul(k, h)) + bias
    g = h[0] if mode == "matmul_2d" else h.sum(0)                # (C, B)
    for _ in range(n_det2):
        k, bias = next_w()
        g = k @ g + bias
    ka, ba = next_w()
    att = ka @ g + ba                                            # (1, B)
    ko, bo = next_w()
    ori = ko @ g + bo                                            # (2, B)
    d = x
    for _ in range(n_desc):
        k, bias = next_w()
        d = torch.matmul(k, d) + bias
    km, bm = next_w()
    if mode == "matmul_2d":
        m = (torch.matmul(rnd(km), rnd(torch.cat([d[:1], d[:1]], dim=1))) + bm)[0]
    else:
        dpool = d[0]
        for s in range(1, d.shape[0]):
            dpool = dpool + d[s]
        cat = torch.cat([d, dpool.expand_as(d)], dim=1)
        m = (torch.matmul(rnd(km), rnd(cat)) + bm).sum(0)
    kp, bp = next_w()
    out = kp @ m + bp                                            # (D, B), unnormalised
    return out.t().contiguous(), (att + ori[0:1] * 1e-30)[0]


# per-slot layer widths the kernel is instantiated for (csrc/slot_layer.cuh)
_SLOT_WIDTHS = (32, 64, 128, 256)


def _kernel_weights(weights_t: List[torch.Tensor], cfg: ModelConfig, device,
                    bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (Cin, Cout) weight buffer + (cin, cout, w_off, b_off) table for
    the kernel. K-padded first layers keep 4 input rows (x, y, z, 0). Every
    block starts on a 16-byte boundary (the kernel reads W as float4).
    bf16: the kernel matrices (not the biases) rounded to bf16 values."""
    n_det, n_det2, n_desc = _n_layers(cfg)
    if len(weights_t) != 2 * (n_det + n_det2 + 2 + n_desc + 2):
        raise ValueError(f"fused_describe: {len(weights_t)} weight tensors do not "
                         "match the config's tower")
    slot_layers = (set(range(n_det))
                   | set(range(n_det + n_det2 + 2, n_det + n_det2 + 2 + n_desc + 1)))
    rnd = _round_bf16 if bf16 else _identity
    pieces, table, off = [], [], 0
    for li in range(len(weights_t) // 2):
        kt, b = weights_t[2 * li], weights_t[2 * li + 1]
        w = rnd(kt.t())
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


def _describe_kernel_weights(weights_t: List[torch.Tensor], cfg: ModelConfig, device,
                             mode: str = "f32") -> tuple:
    """Kernel K3's weights for `mode` (a key of kernels.DESCRIBE_MODES):
    `_kernel_weights`' buffer (kernel matrices as bf16 values in 'bf16') and
    table, and per layer the offsets of its W fragments for the tensor cores
    and of its column norms, (n, 2), -1 where it has none. The buffer then
    also holds, for the two pooled convs (the detector's top conv and the
    mid conv), their fragments (`_tf32_fragments`, or `_bf16_fragments` in
    'bf16') and their column 2-norms rounded up (the slack of the forward's
    max-pool candidates), the mid conv's followed by those of its rows below
    cin / 2 (the rows that multiply the [h | pool] input's h). Every mode
    but 'bf16' takes the 'f32' buffers (the decomposition bodies run the
    pooled convs on the f32 forward's TF32 tiles).
    A caller that launches K3 often makes this once and passes it to
    `fused_describe_clusters_t` (the server and the pipeline do)."""
    bf16 = mode == "bf16"
    flat, table = _kernel_weights(weights_t, cfg, device, bf16=bf16)
    n_det, n_det2, n_desc = _n_layers(cfg)
    pooled = (n_det - 1, n_det + n_det2 + 2 + n_desc)
    extra = torch.full((table.shape[0], 2), -1, dtype=torch.int32)
    pieces, off = [flat], flat.numel()

    def put(t):
        nonlocal off
        start = off
        pieces.extend([t, t.new_zeros(-t.numel() % 4)])
        off += t.numel() + pieces[-1].numel()
        return start

    for li in pooled:
        cin, cout, w_off = table[li, :3].tolist()
        if li == 0 or cin % 32 or cout % 16:
            raise ValueError(f"fused_describe: pooled layer {li} is {cin}->{cout}; the kernel "
                             "takes Cin % 32 == 0, Cout % 16 == 0 after a per-slot conv")
        w = flat[w_off:w_off + cin * cout].reshape(cin, cout)
        extra[li, 0] = put((_bf16_fragments if bf16 else _tf32_fragments)(w))
        norms = w.norm(dim=0)
        if li != pooled[0]:                 # the mid conv: also its rows below cin / 2
            norms = torch.cat([norms, w[:cin // 2].norm(dim=0)])
        extra[li, 1] = put(norms * 1.0001)
    return torch.cat(pieces).contiguous(), table, extra


def _launch_describe(clusters_p: torch.Tensor, packed: tuple, cfg: ModelConfig, mode: str,
                     desc: torch.Tensor, att: torch.Tensor, stop: Optional[str] = None) -> None:
    """K3 on (ns·8, B) CUDA clusters with `_describe_kernel_weights`' buffers
    into desc (B, D) and att (B,). stop: the time split
    (kernels.launch_fused_describe)."""
    n_det, n_det2, n_desc = _n_layers(cfg)
    r = np.float32(cfg.base_scale)
    kernels.launch_fused_describe(clusters_p, cfg.num_samples, *packed, n_det, n_det2, n_desc,
                                  mode, float(r * r), float(np.float32(1.0) / r), desc, att,
                                  stop=stop)


@spanned("f3d.k3.describe")
def fused_describe_clusters_t(weights_t: List[torch.Tensor], clusters_p: torch.Tensor,
                              cfg: ModelConfig, bf16_act: bool = False,
                              ablate: Optional[str] = None, packed: Optional[tuple] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving forward through kernel K3: (ns·8, B) packed clusters
    (pack_clusters_lanes) + transpose_folded_weights(folded_weights(...))
    -> (descriptors (B, D), attention (B,)).

    bf16_act: the towers' products take bf16 operands and sum in f32, the
    activations are bf16 values (see the plain version). ablate ('stream' |
    'matmul' | 'matmul_2d'): the time-decomposition bodies, whose outputs
    are not descriptors; not with bf16_act. packed:
    `_describe_kernel_weights(weights_t, cfg, clusters_p.device, mode)`,
    made once by a caller that calls often; None packs here, on every call.
    Each launch counts in `launches` and in `mode_launches[mode]` (mode
    'f32', 'bf16' or the ablate value).

    CPU tensors take `fused_describe_clusters_t_plain`; CUDA tensors launch
    the kernel in the mode asked for, and anything it does not take raises.
    """
    mode = _describe_mode(bf16_act, ablate)
    if clusters_p.device.type == "cpu":
        return fused_describe_clusters_t_plain(weights_t, clusters_p, cfg,
                                               bf16_act=bf16_act, ablate=ablate)
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
    if packed is None:
        packed = _describe_kernel_weights(weights_t, cfg, clusters_p.device, mode)
    desc = torch.empty((b, cfg.feature_dim), dtype=torch.float32, device=clusters_p.device)
    att = torch.empty((b,), dtype=torch.float32, device=clusters_p.device)
    _launch_describe(clusters_p, packed, cfg, mode, desc, att)
    fused_describe_clusters_t.launches += 1
    fused_describe_clusters_t.mode_launches[mode] += 1
    return desc, att


fused_describe_clusters_t.launches = 0
fused_describe_clusters_t.mode_launches = dict.fromkeys(kernels.DESCRIBE_MODES, 0)
fused_describe_clusters_t.plain = fused_describe_clusters_t_plain


def fused_describe_clusters(weights: List[torch.Tensor], clusters: torch.Tensor,
                            cfg: ModelConfig, bf16_matmul: bool = False,
                            bf16_act: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, ns, 3) origin-centred clusters + folded_weights() (untransposed)
    -> (descriptors (B, D), attention (B,)), as the JAX package's entry of
    the same name.

    It packs the clusters (`pack_clusters_lanes_torch`), transposes the
    weights and calls `fused_describe_clusters_t`: kernel K3 on a CUDA
    tensor, its plain version on a CPU tensor. bf16_matmul and bf16_act
    both select K3's bf16 mode: rounding each product's operands to bf16
    gives the values that storing bf16 activations gives, since rounding
    commutes with ReLU and max. JAX's `tile`, `lane_pack`, `vpu_k3` and
    `interpret` schedule its kernel on the TPU (the clusters of a grid
    step; clusters packed into one MXU pass, bit-exact with unpacked; the
    K = 3 product on the VPU; Pallas interpret mode), so they are not
    taken. A caller that serves often packs the weights once and calls
    `fused_describe_clusters_t` with `packed=`.
    """
    if clusters.dim() != 3 or clusters.shape[1:] != (cfg.num_samples, 3):
        raise ValueError(f"fused_describe_clusters: clusters {tuple(clusters.shape)} are not "
                         f"(B, num_samples={cfg.num_samples}, 3)")
    return fused_describe_clusters_t(transpose_folded_weights(weights),
                                     pack_clusters_lanes_torch(clusters), cfg,
                                     bf16_act=bf16_matmul or bf16_act)


# ---- detector-only tower (kernel K6) -----------------------------------------

def detector_weights_unfolded(variables: Dict[str, Any], cfg: ModelConfig
                              ) -> List[torch.Tensor]:
    """Detector weights WITHOUT BN folding, in flax's layout: per detector
    conv and post conv (kernel (Cin, Cout), bias, mean, mul, bn_bias) with
    mul = rsqrt(var + eps) * scale in flax's op order; then attention
    (kernel, bias) and orientation (kernel, bias). The tower replays
    y = (Wx + b - mean) * mul + bn_bias, rounding as the model path does."""
    p, s = variables["params"], variables["batch_stats"]
    det_p, det_s = p["detection"], s["detection"]
    names = ([f"conv{i}" for i in range(len(cfg.detector_mlp))]
             + [f"conv_post_{i}" for i in range(len(cfg.detector_mlp2))])
    out: List[torch.Tensor] = []
    for name in names:
        mul = torch.rsqrt(_f32(det_s[name]["bn"]["var"]) + cfg.bn_epsilon) \
            * _f32(det_p[name]["bn"]["scale"])
        out.extend([_f32(det_p[name]["conv2d"]["kernel"]), _f32(det_p[name]["conv2d"]["bias"]),
                    _f32(det_s[name]["bn"]["mean"]), mul, _f32(det_p[name]["bn"]["bias"])])
    for head in ("attention", "orientation"):
        out.extend([_f32(det_p[head]["kernel"]), _f32(det_p[head]["bias"])])
    return out


def transpose_unfolded_detector(weights: List[torch.Tensor]) -> List[torch.Tensor]:
    """detector_weights_unfolded() -> kernels (Cout, Cin) with K=3 inputs
    zero-padded to K=8, every per-channel vector a (Cout, 1) column: 5
    entries per conv layer, then the two head (kernel, bias) pairs."""
    n_conv = len(weights) - 4
    if n_conv % 5:
        raise ValueError("transpose_unfolded_detector: unexpected weight list")
    out: List[torch.Tensor] = []
    i = 0
    while i < len(weights):
        k = weights[i].t()
        if k.shape[1] == 3:
            k = torch.nn.functional.pad(k, (0, 5))
        out.append(k.contiguous())
        n_vec = 4 if i < n_conv else 1
        out.extend(v[:, None].contiguous() for v in weights[i + 1:i + 1 + n_vec])
        i += 1 + n_vec
    return out


def _detect_mode(unfolded: bool, bf16_operands: bool) -> str:
    """K6's mode: 'unfolded', 'folded' or 'bf16_operands' (unfolded only)."""
    if bf16_operands and not unfolded:
        raise ValueError("fused_detect_clusters: bf16_operands needs unfolded=True")
    return "bf16_operands" if bf16_operands else ("unfolded" if unfolded else "folded")


def _detector_layers(weights_t: List[torch.Tensor], cfg: ModelConfig, unfolded: bool):
    """Split the detector's weights into conv layers (k, b, mu, mul, beta)
    and the two heads (k, b). unfolded: transpose_unfolded_detector()'s
    list; else transpose_folded_weights(folded_weights(...)), whole or its
    detector prefix, with no BN (mu, mul, beta None). Raises on a list of
    another tower."""
    n_conv = len(cfg.detector_mlp) + len(cfg.detector_mlp2)
    if unfolded:
        if len(weights_t) != 5 * n_conv + 4:
            raise ValueError(f"fused_detect_clusters: {len(weights_t)} weight tensors do not "
                             "match the config's unfolded detector (BN layers need use_bn)")
        convs = [tuple(weights_t[5 * i:5 * i + 5]) for i in range(n_conv)]
        head0 = 5 * n_conv
    else:
        n_prefix = 2 * (n_conv + 2)
        if len(weights_t) not in (n_prefix, n_prefix + 2 * (len(cfg.descriptor_mlp) + 2)):
            raise ValueError(f"fused_detect_clusters: {len(weights_t)} weight tensors do not "
                             "match the config's folded tower")
        convs = [(weights_t[2 * i], weights_t[2 * i + 1], None, None, None)
                 for i in range(n_conv)]
        head0 = 2 * n_conv
    heads = (tuple(weights_t[head0:head0 + 2]), tuple(weights_t[head0 + 2:head0 + 4]))
    cins = [8] + [k.shape[0] for k, *_ in convs]        # the K-padded input, then each Cout
    if not all(k.dim() == 2 and k.shape[1] == cin and tuple(b.shape) == (k.shape[0], 1)
               for (k, b, *_), cin in zip(convs + list(heads), cins + cins[-1:])):
        raise ValueError("fused_detect_clusters: the weight tensors do not chain as the "
                         f"config's {'unfolded' if unfolded else 'folded'} detector")
    return convs, heads


def fused_detect_clusters_plain(weights_t: List[torch.Tensor], clusters: torch.Tensor,
                                cfg: ModelConfig, unfolded: bool = False,
                                bf16_operands: bool = False, chunk: int = 8192
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: (B, ns, 3) origin-centred clusters ->
    (attention (B,), orientation (B,) angle), in chunks of `chunk` clusters.

    Membership d2 = (x·x + y·y) + z·z < r² (an empty cluster keeps its
    first slot at the minimum d2); per slot Dense then ReLU; masked max
    pool; post layers the same way; attention logaddexp(x, 0); orientation
    atan2 of the rsqrt(max(|o|², 1e-8))-normalised 2-vector. For the
    repeat-padded clusters a ball query gives, the membership mask selects
    the same points as slot < cnt. Modes, as `_detect_kernel_2d`'s:
    unfolded: input divided by r, each Dense followed by the replayed BN
    (v - mean)·mul + bn_bias; folded (default): BN folded into the weights,
    input times 1/r; bf16_operands (unfolded only): each product's
    activation and kernel rounded to bf16, sums and BN in f32.
    """
    _detect_mode(unfolded, bf16_operands)
    convs, ((ka, ba), (ko, bo)) = _detector_layers(weights_t, cfg, unfolded)
    rnd = _round_bf16 if bf16_operands else _identity
    n_det = len(cfg.detector_mlp)
    r = torch.tensor(cfg.base_scale, dtype=torch.float32)
    r2 = (r * r).item()
    inv_r = 1.0 / r
    atts, oris = [], []
    for c0 in range(0, clusters.shape[0], chunk):
        x = clusters[c0:c0 + chunk].to(torch.float32)                # (b, ns, 3)
        ns = x.shape[1]
        d2 = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
        d2 = d2 + x[..., 2] * x[..., 2]                              # (b, ns)
        in_ball = d2 < r2
        empty = ~in_ball.any(dim=1, keepdim=True)
        slots = torch.arange(ns, device=x.device).expand_as(d2)
        first = torch.where(d2 <= d2.min(dim=1, keepdim=True).values, slots, ns)
        first = first.min(dim=1, keepdim=True).values
        mask = (in_ball | (empty & (slots == first))).to(torch.float32)
        h = x / r.to(x.device) if unfolded else x * inv_r.to(x.device)
        for li, (k, b, mu, mul, beta) in enumerate(convs):
            if li == n_det:
                h = (h * mask[..., None]).amax(dim=1)                # (b, C)
            kk = k[:, :h.shape[-1]]
            v = torch.matmul(rnd(h), rnd(kk).t()) + b[:, 0]
            if mu is not None:
                v = (v - mu[:, 0]) * mul[:, 0] + beta[:, 0]
            h = torch.relu(v)
        if len(convs) == n_det:
            h = (h * mask[..., None]).amax(dim=1)
        a = torch.matmul(rnd(h), rnd(ka).t()) + ba[:, 0]
        atts.append(torch.logaddexp(a[:, 0], torch.zeros((), device=x.device)))
        o = torch.matmul(rnd(h), rnd(ko).t()) + bo[:, 0]
        o = o * torch.rsqrt(torch.clamp((o * o).sum(dim=1, keepdim=True), min=1e-8))
        oris.append(torch.atan2(o[:, 1], o[:, 0]))
    if not atts:
        empty_out = torch.zeros((0,), dtype=torch.float32, device=clusters.device)
        return empty_out, empty_out.clone()
    return torch.cat(atts), torch.cat(oris)


def _tf32_rna(w: torch.Tensor) -> torch.Tensor:
    """f32 w rounded to TF32 as `cvt.rna.tf32.f32` rounds it on the card: to
    10 mantissa bits, ties away from zero (half the dropped bits' weight
    added to the magnitude, then cleared)."""
    return ((w.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_fragments(w: torch.Tensor) -> torch.Tensor:
    """K6's B operand for mma.sync m16n8k8 (TF32), from a (cin, cout) f32
    matrix (cin % 8 == cout % 8 == 0): per 8 x 8 block (k block major, then
    n block), per lane 4 g + t, the TF32 values of (k0 + t, n0 + g) and (k0
    + t + 4, n0 + g); flat f32."""
    cin, cout = w.shape
    b = _tf32_rna(w).reshape(cin // 8, 2, 4, cout // 8, 8)
    return b.permute(0, 3, 4, 2, 1).reshape(-1)             # kb, nb, g, t, h


def _bf16_fragments(w: torch.Tensor) -> torch.Tensor:
    """K6's B operand for mma.sync m16n8k16 (bf16), from a (cin, cout)
    matrix of bf16 values (cin % 16 == cout % 8 == 0): per 16 x 8 block,
    per lane 4 g + t, the bf16 of (k0 + 2t, n0 + g), (k0 + 2t + 1, n0 + g),
    (k0 + 2t + 8, n0 + g), (k0 + 2t + 9, n0 + g), two to a 32-bit word, the
    lower k in the low half; returned as the f32 bit patterns of the words."""
    cin, cout = w.shape
    b = w.to(torch.bfloat16).reshape(cin // 16, 2, 4, 2, cout // 8, 8)
    return b.permute(0, 4, 5, 2, 1, 3).contiguous().reshape(-1).view(torch.float32)


def _detect_kernel_weights(weights_t: List[torch.Tensor], cfg: ModelConfig, device,
                           unfolded: bool, bf16: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K6's weights: a flat f32 buffer; the (cin, cout, w, b, mu,
    mul, beta) offset table into it (-1 where a layer has no BN: the heads,
    and every layer of the folded tower); and per layer the offsets of its
    W fragments for the tensor cores and of its column norms, (n, 2), -1
    where it has none. The buffer holds each layer's (Cin, Cout) kernel and
    vectors, the first layer cut to 4 input rows (x, y, z, 0); then, for
    the top per-slot conv, its fragments (`_tf32_fragments`, or
    `_bf16_fragments` under bf16) and its column 2-norms rounded up (the
    slack of its pool's candidates). Every block starts on a 16-byte
    boundary. bf16: the kernel matrices rounded to bf16 values. A caller
    that launches K6 often makes this once and passes it to
    `fused_detect_clusters` (the pipeline does)."""
    convs, heads = _detector_layers(weights_t, cfg, unfolded)
    n_det = len(cfg.detector_mlp)
    if n_det < 2:
        raise ValueError("fused_detect_clusters: the kernel takes at least 2 detector convs")
    rnd = _round_bf16 if bf16 else _identity
    pieces, table, mats, off = [], [], [], 0

    def put(t):
        nonlocal off
        t = t.reshape(-1)
        start = off
        pad = -t.numel() % 4
        pieces.extend([t, t.new_zeros(pad)])
        off += t.numel() + pad
        return start

    for li, layer in enumerate(list(convs) + [h + (None, None, None) for h in heads]):
        k, b, mu, mul, beta = layer
        w = rnd(k.t())
        if w.shape[0] == 8:
            w = w[:4]                       # rows 3..7 are the zero pad
        cin, cout = w.shape
        if li < n_det and (cout not in _SLOT_WIDTHS or cin % 4):
            raise ValueError(f"fused_detect_clusters: per-slot layer {li} is {cin}->{cout}; "
                             f"the kernel takes Cout in {_SLOT_WIDTHS}, Cin % 4 == 0")
        if cout > 256 or cin > 256:
            raise ValueError(f"fused_detect_clusters: layer {li} wider than 256")
        row = [cin, cout, put(w), put(b)]
        row += [-1, -1, -1] if mu is None else [put(mu), put(mul), put(beta)]
        table.append(row)
        mats.append(w)
    extra = [[-1, -1] for _ in table]
    top = mats[n_det - 1]
    extra[n_det - 1] = [put((_bf16_fragments if bf16 else _tf32_fragments)(top)),
                        put(top.norm(dim=0) * 1.0001)]
    flat = torch.cat(pieces).to(device=device, dtype=torch.float32).contiguous()
    return (flat, torch.tensor(table, dtype=torch.int32),
            torch.tensor(extra, dtype=torch.int32))


def _launch_detect(clusters: torch.Tensor, packed, cfg: ModelConfig, unfolded: bool,
                   bf16: bool, out: torch.Tensor, stop: Optional[str] = None) -> None:
    """K6 on (B, ns, 3) CUDA clusters with `_detect_kernel_weights`' buffers
    into out (B, 3): attention, c, s. stop: the time split
    (kernels.launch_fused_detect)."""
    r = np.float32(cfg.base_scale)
    kernels.launch_fused_detect(clusters, *packed, len(cfg.detector_mlp), len(cfg.detector_mlp2),
                                not unfolded, bf16, float(r), float(np.float32(1.0) / r),
                                float(r * r), out, stop=stop)


@spanned("f3d.k6.detect")
def fused_detect_clusters(weights_t: List[torch.Tensor], clusters: torch.Tensor,
                          cfg: ModelConfig, unfolded: bool = False,
                          bf16_operands: bool = False, packed: Optional[tuple] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detector-only tower through kernel K6: (B, ns, 3) origin-centred
    clusters -> (attention (B,), orientation (B,) angle).

    weights_t: transpose_folded_weights(folded_weights(...)) (whole, or its
    detector prefix) for the default folded mode; with unfolded=True,
    transpose_unfolded_detector(detector_weights_unfolded(...)), the
    model path's rounding; bf16_operands (unfolded only) rounds each
    product's operands to bf16. packed: `_detect_kernel_weights(weights_t,
    cfg, clusters.device, unfolded, bf16_operands)`, made once by a caller
    that calls often; None packs here, on every call. Each launch counts in
    `launches` and in `mode_launches[mode]` (mode 'unfolded', 'folded' or
    'bf16_operands').

    CPU tensors take `fused_detect_clusters_plain`; CUDA tensors launch the
    kernel, and anything it does not take raises.
    """
    mode = _detect_mode(unfolded, bf16_operands)
    if clusters.device.type == "cpu":
        return fused_detect_clusters_plain(weights_t, clusters, cfg, unfolded=unfolded,
                                           bf16_operands=bf16_operands)
    if clusters.device.type != "cuda":
        raise ValueError(f"fused_detect_clusters: unsupported device {clusters.device}")
    if clusters.dtype != torch.float32 or clusters.dim() != 3 or clusters.shape[2] != 3:
        raise ValueError(f"fused_detect_clusters: want (B, ns, 3) float32, got "
                         f"{tuple(clusters.shape)} {clusters.dtype}")
    b, ns, _ = clusters.shape
    if ns != cfg.num_samples or not 1 <= ns <= 64:
        raise ValueError(f"fused_detect_clusters: {ns} samples, num_samples="
                         f"{cfg.num_samples} (<= 64)")
    clusters = clusters.contiguous()
    if packed is None:
        packed = _detect_kernel_weights(weights_t, cfg, clusters.device, unfolded,
                                        bf16=bf16_operands)
    out = torch.empty((b, 3), dtype=torch.float32, device=clusters.device)
    _launch_detect(clusters, packed, cfg, unfolded, bf16_operands, out)
    fused_detect_clusters.launches += 1
    fused_detect_clusters.mode_launches[mode] += 1
    return out[:, 0], torch.atan2(out[:, 2], out[:, 1])


fused_detect_clusters.launches = 0
fused_detect_clusters.mode_launches = dict.fromkeys(("unfolded", "folded", "bf16_operands"), 0)
fused_detect_clusters.plain = fused_detect_clusters_plain
