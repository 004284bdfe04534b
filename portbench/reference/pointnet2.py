"""PointNet++ MSG segmentation (Qi et al., arXiv:1706.02413) in plain
PyTorch, f32, eval: the network of Pointnet2.PyTorch's
tools/pointnet2_msg.py, PointRCNN's stage-1 backbone and segmentation head
(arXiv:1812.04244), written from those sources. Products in f32 with TF32
off (`precision`); the control turns TF32 on.

Per cloud of N points (xyz only; `cfg` is a configuration file's `model`
section):

* SA level k: `npoints[k]` centres by farthest point sampling of the
  level's input points (start at index 0, each next centre the argmax of
  the running minimum squared distance, first index on ties), brute force;
  per scale the first `nsample` points in index order with d2 < r^2 (r^2
  rounded in f32), padded with the first hit, read off a distance matrix;
  each member's [xyz - centre | features] through 1x1 convs without bias,
  each followed by eval BN (eps `bn_epsilon`) and ReLU; the max over the
  slots; the scales concatenated.
* FP levels from the coarsest: each finer point's 3 nearest coarser
  points by a stable sort of d2 (first index on ties), weights (1 / (d +
  1e-8)) normalised over the three, d the Euclidean distance; [the
  weighted sum | the finer level's features] through convs, BN, ReLU.
* head: conv 128 -> 128, BN, ReLU; dropout (the identity in eval); conv
  128 -> 1 with bias.

Departures from the sources, all outside the arithmetic compared:
* FPS breaks ties to the lowest index; the source's CUDA kernel takes
  whichever its reduction tree meets, and skips points with |p| <= 1e-3
  as candidates (none of the cell's frames have such a point once moved).
* The input is the frame sampled uniformly to N points (the cell's
  traffic), not PointRCNN's camera field-of-view crop and its near/far
  sampling rule: the repo holds no calibration files.
* Weights are seeded (`make_weights`), not trained.
* The 3-NN's weight normaliser is a sum over the three (torch.sum, as the
  source) and squared distances are summed ((dx*dx) + dy*dy) + dz*dz.

Weights are a flat dict under the port's state-dict names (see
`layer_specs`), kernels (Cout, Cin).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.model import precision  # noqa: F401  (the same switch)

Weights = Dict[str, torch.Tensor]


def sa_widths(cfg: dict) -> List[int]:
    return [sum(m[-1] for m in level) for level in cfg["sa_mlps"]]


def layer_specs(cfg: dict) -> List[Tuple[str, int, int, bool]]:
    """(scope, cin, cout, has_bn) of every conv, in the forward's order."""
    out = []
    cin = 0
    for k, level in enumerate(cfg["sa_mlps"]):
        for s, widths in enumerate(level):
            c = 3 + cin
            for j, w in enumerate(widths):
                out.append((f"sa.{k}.branches.{s}.{j}", c, w, True))
                c = w
        cin = sum(m[-1] for m in level)
    skips = [0] + sa_widths(cfg)
    fp = cfg["fp_mlps"]
    for k in range(len(fp) - 1, -1, -1):
        c = (fp[k + 1][-1] if k + 1 < len(fp) else skips[-1]) + skips[k]
        for j, w in enumerate(fp[k]):
            out.append((f"fp.{k}.mlp.{j}", c, w, True))
            c = w
    c = fp[0][-1]
    for j, w in enumerate(cfg["cls_fc"]):
        out.append((f"head.{j}", c, w, True))
        c = w
    out.append(("logit", c, 1, False))
    return out


def make_weights(cfg: dict, seed: int, device) -> Weights:
    """Seeded weights from one numpy generator: every conv Kaiming-normal
    (std sqrt(2 / fan_in); the logit conv sqrt(1 / fan_in), bias N(0,
    0.1^2)), each BN with scale 1 + N(0, 0.1^2), bias and running mean
    N(0, 0.02^2) and running variance U(0.5, 1.5): layers keep their
    activations' scale, so the logits vary from point to point and stay
    far from overflow."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 28])
    w: Dict[str, np.ndarray] = {}
    for scope, cin, cout, bn in layer_specs(cfg):
        gain = 2.0 if bn else 1.0
        w[f"{scope}.conv2d.weight" if bn else f"{scope}.weight"] = (
            rng.standard_normal((cout, cin)) * math.sqrt(gain / cin))
        if bn:
            w[f"{scope}.bn.scale"] = 1.0 + 0.1 * rng.standard_normal(cout)
            w[f"{scope}.bn.bias"] = 0.02 * rng.standard_normal(cout)
            w[f"{scope}.bn.mean"] = 0.02 * rng.standard_normal(cout)
            w[f"{scope}.bn.var"] = rng.uniform(0.5, 1.5, cout)
        else:
            w[f"{scope}.bias"] = 0.1 * rng.standard_normal(cout)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in w.items()}


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 3) x (N, 3) -> (M, N), ((dx*dx) + dy*dy) + dz*dz, dx = a - b."""
    d = None
    for c in range(3):
        dc = a[:, None, c] - b[None, :, c]
        dc = dc * dc
        d = dc if d is None else d + dc
    return d


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
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(mind, dim=1, keepdim=True)
        out[:, j] = last[:, 0]
    return out


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float, ns: int,
               chunk: int = 4096) -> torch.Tensor:
    """(N, 3) points, (M, 3) centres (each one of the points) -> (M, ns)
    int64: the first ns indices with d2 < r^2, slots past the count
    repeating the first."""
    r2 = float(np.float32(radius) * np.float32(radius))
    out = []
    for c0 in range(0, centers.shape[0], chunk):
        inside = sqdist(centers[c0:c0 + chunk], xyz) < r2
        count = torch.cumsum(inside.to(torch.int32), dim=1)
        cnt = count[:, -1].clamp(max=ns)
        want = torch.arange(1, ns + 1, device=xyz.device, dtype=torch.int32)
        idx = torch.searchsorted(count, want.expand(count.shape[0], ns).contiguous())
        slot = torch.arange(ns, device=xyz.device)
        out.append(torch.where(slot[None, :] < cnt[:, None], idx, idx[:, :1]))
    return torch.cat(out)


def three_nn(unknown: torch.Tensor, known: torch.Tensor, chunk: int = 4096
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, 3), (m, 3) -> (d2 (n, 3), idx (n, 3) int64): the three nearest
    known points by a stable sort, nearest first."""
    ds, idxs = [], []
    for c0 in range(0, unknown.shape[0], chunk):
        d2, idx = torch.sort(sqdist(unknown[c0:c0 + chunk], known), dim=1, stable=True)
        ds.append(d2[:, :3])
        idxs.append(idx[:, :3])
    return torch.cat(ds), torch.cat(idxs)


def interp_weights(d2: torch.Tensor) -> torch.Tensor:
    recip = 1.0 / (torch.sqrt(d2) + 1e-8)
    return recip / torch.sum(recip, dim=1, keepdim=True)


def conv_bn_relu(w: Weights, scope: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    v = torch.matmul(x, w[f"{scope}.conv2d.weight"].t())
    y = (v - w[f"{scope}.bn.mean"]) / torch.sqrt(w[f"{scope}.bn.var"] + eps) \
        * w[f"{scope}.bn.scale"] + w[f"{scope}.bn.bias"]
    return torch.relu(y)


def _mlp(w: Weights, prefix: str, widths, x: torch.Tensor, eps: float) -> torch.Tensor:
    for j in range(len(widths)):
        x = conv_bn_relu(w, f"{prefix}.{j}", x, eps)
    return x


@torch.no_grad()
def forward(w: Weights, cfg: dict, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) f32 clouds -> (logits (B, N), FP1's features (B, N, C)),
    one cloud at a time but for the FPS, which takes the batch."""
    eps = float(cfg["bn_epsilon"])
    xyzs, feats = [xyz], [None]
    for k, npoint in enumerate(cfg["npoints"]):
        src, f = xyzs[-1], feats[-1]
        centers = torch.stack([src[i][j] for i, j in enumerate(fps(src, int(npoint)))])
        pooled = []
        for i in range(xyz.shape[0]):
            per = []
            for s, (r, ns) in enumerate(zip(cfg["radii"][k], cfg["nsamples"][k])):
                idx = ball_query(src[i], centers[i], float(r), int(ns))
                g = src[i][idx] - centers[i][:, None, :]
                if f is not None:
                    g = torch.cat([g, f[i][idx]], dim=-1)
                per.append(_mlp(w, f"sa.{k}.branches.{s}", cfg["sa_mlps"][k][s], g, eps)
                           .amax(dim=1))
            pooled.append(torch.cat(per, dim=-1))
        xyzs.append(centers)
        feats.append(torch.stack(pooled))
    for k in range(len(cfg["fp_mlps"]) - 1, -1, -1):
        rows = []
        for i in range(xyz.shape[0]):
            d2, idx = three_nn(xyzs[k][i], xyzs[k + 1][i])
            wt = interp_weights(d2)
            h = (feats[k + 1][i][idx] * wt[..., None]).sum(dim=1)
            if feats[k] is not None:
                h = torch.cat([h, feats[k][i]], dim=-1)
            rows.append(_mlp(w, f"fp.{k}.mlp", cfg["fp_mlps"][k], h, eps))
        feats[k] = torch.stack(rows)
    h = _mlp(w, "head", cfg["cls_fc"], feats[0], eps)
    logits = torch.matmul(h, w["logit.weight"].t()) + w["logit.bias"]
    return logits[..., 0], feats[0]
