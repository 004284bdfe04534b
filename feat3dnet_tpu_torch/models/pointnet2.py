"""PointNet++ with multi-scale grouping (Qi et al., arXiv:1706.02413), at
the widths of Pointnet2.PyTorch's tools/pointnet2_msg.py: the backbone and
segmentation head of PointRCNN's stage 1 (arXiv:1812.04244), one
foreground logit per point. Eval forward only.

Layout: points and features channel-last, (B, N, C), as the rest of the
port. Layer by layer (config.PointNet2Config):

* set abstraction, levels 1-4: FPS centres of the level's input points
  (kernel K1, from index 0); per scale one ball query (K2: the first
  nsample points in index order with d2 < r^2, padded with the first
  hit), the members' [xyz - centre | features] (`ops.pointnet.
  group_relative`), a shared MLP of `ConvBN`s (1x1 conv without bias,
  BN, ReLU) and the max over the slots; the scales' pools concatenated
  in order;
* feature propagation, from the coarsest: each point of the finer level
  takes the inverse-distance weighted features of its 3 nearest points of
  the coarser level (K11, `ops.interpolate.three_interpolate`), then its
  own features are concatenated, then a shared MLP;
* head: ConvBN 128 -> 128, dropout (identity in eval), a 1x1 conv
  128 -> 1 with bias.

The forward is a list of named steps (`steps`: sa1 ... sa4, fp4 ... fp1,
head) over a state of the levels' tensors, each run inside its span
(`f3d.seg.<step>`), so that the segmentation pipeline's unit shows its
stages under a profiler and can capture each step as a CUDA graph.

The state dict's names (`sa.<k>.branches.<s>.<l>.conv2d.weight`,
`...bn.{scale,bias,mean,var}`, `fp.<k>.mlp.<l>...`, `head.<l>...`,
`logit.{weight,bias}`) are those the benchmark's plain reference
(portbench/reference/pointnet2.py) makes its seeded weights under.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from feat3dnet_tpu_torch.config import PointNet2Config
from feat3dnet_tpu_torch.models.layers import ConvBN, Dense
from feat3dnet_tpu_torch.ops.fps import farthest_point_sample
from feat3dnet_tpu_torch.ops.interpolate import three_interpolate
from feat3dnet_tpu_torch.ops.neighborhoods import ball_query, gather_points
from feat3dnet_tpu_torch.ops.pointnet import group_relative
from feat3dnet_tpu_torch.utils.profiling import span


def _mlp(cin: int, widths: Sequence[int], eps: float) -> nn.ModuleList:
    layers = []
    for c in widths:
        layers.append(ConvBN(cin, c, bn_epsilon=eps, use_bias=False))
        cin = c
    return nn.ModuleList(layers)


def _run(layers: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        h = layer(h)
    return h


class SetAbstractionMSG(nn.Module):
    """One multi-scale set-abstraction level: `cin` feature channels in
    (0 for bare xyz), the sum of the scales' last widths out."""

    def __init__(self, npoint: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], cin: int, eps: float):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(s) for s in nsamples)
        self.branches = nn.ModuleList(_mlp(3 + cin, widths, eps) for widths in mlps)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3), (B, N, C) or None -> (centres (B, npoint, 3), (B,
        npoint, C_out))."""
        centers = gather_points(xyz, farthest_point_sample(xyz, self.npoint))
        points = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        pooled = []
        for r, ns, mlp in zip(self.radii, self.nsamples, self.branches):
            idx, _ = ball_query(xyz, centers, r, ns)
            pooled.append(_run(mlp, group_relative(points, centers, idx)).amax(dim=2))
        return centers, torch.cat(pooled, dim=-1)


class FeaturePropagation(nn.Module):
    """One feature-propagation level: the coarser level's features
    interpolated onto the finer points, then [interpolated | own] through
    a shared MLP."""

    def __init__(self, cin: int, widths: Sequence[int], eps: float):
        super().__init__()
        self.mlp = _mlp(cin, widths, eps)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: Optional[torch.Tensor], known_feats: torch.Tensor
                ) -> torch.Tensor:
        h = three_interpolate(unknown, known, known_feats)[0]
        if unknown_feats is not None:
            h = torch.cat([h, unknown_feats], dim=-1)
        return _run(self.mlp, h)


@dataclasses.dataclass
class PointNet2Output:
    logits: torch.Tensor       # (B, N) foreground logits
    features: torch.Tensor     # (B, N, fp_mlps[0][-1]): FP1's output, the head's input


class PointNet2MSG(nn.Module):
    """PointNet++ MSG segmentation network (eval)."""

    def __init__(self, cfg: PointNet2Config = PointNet2Config()):
        super().__init__()
        self.cfg = cfg
        eps = cfg.bn_epsilon
        cin, skips = 0, [0]
        sa = []
        for npoint, radii, nsamples, mlps in zip(cfg.npoints, cfg.radii, cfg.nsamples,
                                                 cfg.sa_mlps):
            sa.append(SetAbstractionMSG(npoint, radii, nsamples, mlps, cin, eps))
            cin = sum(m[-1] for m in mlps)
            skips.append(cin)
        self.sa = nn.ModuleList(sa)
        fp = []
        for k, widths in enumerate(cfg.fp_mlps):
            coarse = cfg.fp_mlps[k + 1][-1] if k + 1 < len(cfg.fp_mlps) else skips[-1]
            fp.append(FeaturePropagation(coarse + skips[k], widths, eps))
        self.fp = nn.ModuleList(fp)
        self.head = _mlp(cfg.fp_mlps[0][-1], cfg.cls_fc, eps)
        self.logit = Dense(cfg.cls_fc[-1] if cfg.cls_fc else cfg.fp_mlps[0][-1], 1)

    @staticmethod
    def start(xyz: torch.Tensor) -> Dict[str, list]:
        """The state the steps work on: each level's points and features."""
        return {"xyz": [xyz], "feats": [None]}

    def steps(self) -> List[Tuple[str, Callable[[Dict[str, list]], None]]]:
        """The forward as named steps over `start`'s state, in order: sa1 ...
        sa4 (each appends a level), fp4 ... fp1 (each replaces the finer
        level's features), head (adds `logits`)."""
        out = [(f"sa{k + 1}", functools.partial(self._sa, k)) for k in range(len(self.sa))]
        out += [(f"fp{k + 1}", functools.partial(self._fp, k))
                for k in range(len(self.fp) - 1, -1, -1)]
        return out + [("head", self._head)]

    def _sa(self, k: int, state: Dict[str, list]) -> None:
        c, f = self.sa[k](state["xyz"][k], state["feats"][k])
        state["xyz"].append(c)
        state["feats"].append(f)

    def _fp(self, k: int, state: Dict[str, list]) -> None:
        xyz, feats = state["xyz"], state["feats"]
        feats[k] = self.fp[k](xyz[k], xyz[k + 1], feats[k], feats[k + 1])

    def _head(self, state: Dict[str, list]) -> None:
        # the dropout between the head's convs is the identity in eval
        state["logits"] = self.logit(_run(self.head, state["feats"][0]))[..., 0]

    @torch.no_grad()
    def forward(self, xyz: torch.Tensor) -> PointNet2Output:
        """(B, N, 3) contiguous f32 points -> logits (B, N) and FP1's features."""
        state = self.start(xyz)
        for name, step in self.steps():
            with span(f"f3d.seg.{name}"):
                step(state)
        return PointNet2Output(state["logits"], state["feats"][0])
