"""Feat3DNet detector + descriptor (port of feat3dnet_tpu/models/feat3dnet.py).

Eval and training forward:
* detector: FPS centres -> radius neighbourhoods (first ns in index order,
  repeat-pad, nearest fallback) centred and radius-normalised -> shared
  MLP -> max pool -> MLP -> attention logaddexp(x, 0) and orientation
  atan2 of the L2-normalised 2-vector;
* descriptor: the detector's grouping rotated into the canonical
  z-orientation -> MLP -> max pool -> [pointwise | pooled] -> MLP (last
  layer BN, no ReLU) -> max pool -> MLP (no ReLU) -> L2 normalise.

`cfg.compute_dtype` is flax's compute dtype, as in the JAX model: the
towers' convs, BN outputs, pools and heads run in it (parameters and BN
statistics stay f32) and the outputs are cast back to f32.

Training (`training=True`) takes flax BatchNorm's batch moments and writes
their EMA into the BN buffers. With `cfg.fused_towers` (f32) the pre-pool
segments of both towers run through ops/fused_train.tower_prepool_fused
(kernels K7-K10 on CUDA), otherwise through torch autograd over `ConvBN`.
On the autograd route the memory modes wrap those segments (JAX's
`_maybe_remat`): under `cfg.residual_dtype` autograd saves the segment's
bf16-exact tensors as bf16 (models/layers.residual_saving: the ConvBN
squash points, with ReLU masks and BN's small vectors), with no
recompute; `cfg.remat_towers` saves only the segment's input and
recomputes it in the backward (models/layers.remat). `residual_dtype`
takes precedence, and its squash points apply to every ConvBN in
training, the post-pool ones too.
On CUDA tensors FPS and the ball query run kernels K1 and K2; the other
tower products are torch matmuls (the JAX package leaves them to XLA).
`bn_group` (the JAX model's `bn_axis_name`): a torch.distributed process
group over whose ranks every BatchNorm takes its training moments, on both
routes (models/layers.BatchNorm, ops/fused_train's `group=`).
Module attribute names are the flax scope names ('detection',
'description', 'conv0', ...) so the weight bridge is mechanical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models.layers import (ConvBN, Dense, from_compute, keep_low,
                                              l2_normalize, remat, residual_saving,
                                              to_compute)
from feat3dnet_tpu_torch.ops import (ball_query, farthest_point_sample,
                                     gather_points, group_points)
from feat3dnet_tpu_torch.ops.fused_train import (descriptor_plan, detector_plan,
                                                 tower_prepool_fused)


@dataclasses.dataclass
class Feat3DNetOutput:
    keypoints: torch.Tensor               # (B, M, 3)
    features: torch.Tensor                # (B, M, feature_dim), L2-normalised
    attention: Optional[torch.Tensor]     # (B, M), None if disabled
    orientation: Optional[torch.Tensor]   # (B, M) radians, None if NoRegress
    end_points: Dict[str, torch.Tensor]


def _rotate_z(grouped: torch.Tensor, orientations: torch.Tensor) -> torch.Tensor:
    """x' = x·c − y·s, y' = x·s + y·c (row vector @ [[c, s, 0], [-s, c, 0], [0, 0, 1]])."""
    c = torch.cos(orientations)[:, :, None]
    s = torch.sin(orientations)[:, :, None]
    x, y, z = grouped[..., 0], grouped[..., 1], grouped[..., 2]
    return torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)


def _group_normalized(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                      nsample: int, valid_mask: Optional[torch.Tensor],
                      orientations: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ball query + gather + centre + radius-normalise (+ optional rotation)
    -> (grouped (B, M, ns, 3), idx (B, M, ns), cnt (B, M))."""
    idx, cnt = ball_query(xyz, centers, radius, nsample, valid_mask=valid_mask)
    grouped = group_points(xyz, idx) - centers[:, :, None, :]
    grouped = grouped / radius
    if orientations is not None:
        grouped = _rotate_z(grouped, orientations)
    return grouped, idx, cnt


def _convs(module: nn.Module, prefix: str, cin: int, widths, cfg: ModelConfig,
           final_act: bool = True, bn_group=None) -> int:
    """Register ConvBN layers `{prefix}{i}`; returns the last width."""
    for i, f in enumerate(widths):
        act = torch.relu if (final_act or i < len(widths) - 1) else None
        module.add_module(f"{prefix}{i}", ConvBN(cin, f, use_bn=cfg.use_bn,
                                                 activation=act,
                                                 bn_epsilon=cfg.bn_epsilon,
                                                 bn_momentum=cfg.bn_momentum,
                                                 dtype=cfg.compute_dtype,
                                                 bn_group=bn_group,
                                                 residual_dtype=cfg.residual_dtype))
        cin = f
    return cin


def _run(module: nn.Module, prefix: str, n: int, x: torch.Tensor,
         training: bool) -> torch.Tensor:
    for i in range(n):
        x = getattr(module, f"{prefix}{i}")(x, training)
    return x


def _maybe_remat(per_point, cfg: ModelConfig, training: bool):
    """A tower's pre-pool segment under the config's memory mode (training
    only): residual_dtype saves its bf16-exact tensors as bf16;
    remat_towers saves only the input and recomputes the rest."""
    if not training:
        return per_point
    if cfg.residual_dtype is not None:
        def packed(h):
            with residual_saving():
                return per_point(h)

        return packed
    if cfg.remat_towers:
        return lambda h: remat(per_point, h)
    return per_point


def _use_fused_towers(cfg: ModelConfig, training: bool) -> bool:
    """The fused tower pipeline applies to f32 training only."""
    use = cfg.fused_towers and training and cfg.compute_dtype == torch.float32
    if use and not cfg.use_bn:
        raise ValueError("fused_towers needs use_bn=True (the kernels train ConvBN)")
    return use


def _fused_prepool(module: nn.Module, grouped: torch.Tensor, names, plan,
                   cfg: ModelConfig, bn_group=None) -> torch.Tensor:
    """A tower's pre-pool segment through tower_prepool_fused: (B, M, ns, C)
    grouped -> (B, M, 1, C_top) pooled. The parameters and BN buffers are
    the ConvBN layers' own; their EMA takes the pipeline's batch moments."""
    b, m, ns, cin = grouped.shape
    blocks = [getattr(module, nm) for nm in names]
    flat = []
    for blk in blocks:
        flat += [blk.conv2d.weight.t(), blk.conv2d.bias, blk.bn.scale, blk.bn.bias]
    x_sm = grouped.to(blocks[0].conv2d.weight.dtype).permute(2, 0, 1, 3).reshape(
        ns, b * m, cin).contiguous()
    pooled, (means, vars_) = tower_prepool_fused(
        x_sm, flat, plan, [blk.conv2d.out_features for blk in blocks], ns, b * m,
        cfg.bn_epsilon, cfg.fused_cot_dtype, bn_group)
    for blk, mean, var in zip(blocks, means, vars_):
        blk.bn.update_stats(mean, var)
    return pooled.reshape(b, m, 1, -1)


class Detector(nn.Module):
    """Attention + orientation heads over grouped clusters."""

    def __init__(self, cfg: ModelConfig, bn_group=None):
        super().__init__()
        self.cfg = cfg
        self.bn_group = bn_group
        c = _convs(self, "conv", 3, cfg.detector_mlp, cfg, bn_group=bn_group)
        c = _convs(self, "conv_post_", c, cfg.detector_mlp2, cfg, bn_group=bn_group)
        self.attention = Dense(c, 1, cfg.compute_dtype)
        self.orientation = Dense(c, 2, cfg.compute_dtype)

    def forward(self, grouped: torch.Tensor, training: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        n = len(cfg.detector_mlp)
        grouped = to_compute(grouped, cfg.compute_dtype)
        if _use_fused_towers(cfg, training):
            x = _fused_prepool(self, grouped, [f"conv{i}" for i in range(n)],
                               detector_plan(n), cfg, self.bn_group)
        else:
            def per_point(h):
                h = _run(self, "conv", n, h, training)
                return torch.amax(h, dim=2, keepdim=True)        # pool over samples

            x = _maybe_remat(per_point, cfg, training)(grouped)
        x = _run(self, "conv_post_", len(cfg.detector_mlp2), x, training)
        att = self.attention(x)[..., 0, 0]
        attention = from_compute(torch.logaddexp(att, torch.zeros((), dtype=att.dtype,
                                                                  device=att.device)),
                                 cfg.compute_dtype)
        ori = l2_normalize(from_compute(self.orientation(x)[..., 0, :], cfg.compute_dtype),
                           dim=-1, epsilon=1e-8)
        orientation = torch.atan2(ori[..., 1], ori[..., 0])
        return attention, orientation


class Descriptor(nn.Module):
    """MLP -> pool -> [pointwise | pooled] -> MLP2 -> pool -> MLP3 -> L2."""

    def __init__(self, cfg: ModelConfig, bn_group=None):
        super().__init__()
        self.cfg = cfg
        self.bn_group = bn_group
        c = _convs(self, "conv", 3, cfg.descriptor_mlp, cfg, bn_group=bn_group)
        c = _convs(self, "conv_mid_", 2 * c, cfg.descriptor_mlp2, cfg, final_act=False,
                   bn_group=bn_group)
        _convs(self, "conv_post_", c, cfg.descriptor_mlp3, cfg, final_act=False,
               bn_group=bn_group)

    def forward(self, grouped: torch.Tensor, training: bool = False) -> torch.Tensor:
        cfg = self.cfg
        n_pre, n_mid = len(cfg.descriptor_mlp), len(cfg.descriptor_mlp2)
        if _use_fused_towers(cfg, training):
            names = [f"conv{i}" for i in range(n_pre)] + [f"conv_mid_{i}" for i in range(n_mid)]
            x = _fused_prepool(self, grouped, names, descriptor_plan(n_pre, n_mid), cfg,
                               self.bn_group)
        else:
            def per_point(h):
                h = _run(self, "conv", n_pre, h, training)
                pooled = torch.amax(h, dim=2, keepdim=True).expand_as(h)
                h = torch.cat([h, pooled], dim=-1)
                rd = cfg.residual_dtype
                if training and rd is not None and h.dtype != rd:
                    h = keep_low(h, h.to(rd))       # squashed values: exact in rd
                h = _run(self, "conv_mid_", n_mid, h, training)
                return torch.amax(h, dim=2, keepdim=True)

            x = _maybe_remat(per_point, cfg, training)(to_compute(grouped, cfg.compute_dtype))
        x = _run(self, "conv_post_", len(cfg.descriptor_mlp3), x, training)
        return l2_normalize(from_compute(x[..., 0, :], cfg.compute_dtype), dim=-1, epsilon=1e-8)


class Feat3DNet(nn.Module):
    """Full model; `training=True` uses batch moments and updates the BN
    buffers (the caller differentiates the outputs). bn_group: the process
    group whose ranks share the BN training moments (data parallelism), or
    None.

    Call modes:
      * keypoints=None, cfg.num_clusters > 0 — FPS centres;
      * keypoints=None, cfg.num_clusters <= 0 — every point is a keypoint;
      * keypoints given — detector + descriptor at those points.
    """

    def __init__(self, cfg: ModelConfig, bn_group=None):
        super().__init__()
        self.cfg = cfg
        self.bn_group = bn_group
        self.detection = Detector(cfg, bn_group)
        self.description = Descriptor(cfg, bn_group)

    def detect_clusters(self, grouped: torch.Tensor, training: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Detector tower on normalised clusters (B, M, ns, 3)."""
        return self.detection(grouped, training)

    def describe_clusters(self, grouped: torch.Tensor, training: bool = False
                          ) -> torch.Tensor:
        """Descriptor tower on rotated clusters -> (B, M, D)."""
        return self.description(grouped, training)

    def forward(self, cloud: torch.Tensor, training: bool = False,
                keypoints: Optional[torch.Tensor] = None,
                valid_mask: Optional[torch.Tensor] = None) -> Feat3DNetOutput:
        cfg = self.cfg
        xyz = cloud[..., :3].to(torch.float32).contiguous()
        end_points: Dict[str, torch.Tensor] = {}

        if keypoints is not None:
            centers = keypoints.to(torch.float32).contiguous()
        elif cfg.num_clusters > 0:
            fps_idx = farthest_point_sample(xyz, cfg.num_clusters, valid_mask=valid_mask)
            centers = gather_points(xyz, fps_idx).contiguous()
        else:
            centers = xyz

        grouped, _, det_cnt = _group_normalized(
            xyz, centers, cfg.base_scale, cfg.num_samples, valid_mask)
        if cfg.compute_dtype == torch.float32:
            # a model moved to float64 (a reference) runs its towers on the
            # f32 grouping in float64; for f32 weights this casts nothing
            grouped = grouped.to(self.detection.attention.weight.dtype)
        attention, orientation = self.detection(grouped, training)
        end_points["keypoints"] = centers
        end_points["attention"] = attention
        end_points["orientation"] = orientation
        end_points["det_cnt"] = det_cnt

        # the descriptor reuses the detector's neighbourhoods, rotated
        grouped2 = _rotate_z(grouped, orientation) if cfg.regress_orientation else grouped
        features = self.description(grouped2, training)
        end_points["desc_cnt"] = det_cnt

        return Feat3DNetOutput(
            keypoints=centers,
            features=features,
            attention=attention if cfg.attention else None,
            orientation=orientation if cfg.regress_orientation else None,
            end_points=end_points,
        )
