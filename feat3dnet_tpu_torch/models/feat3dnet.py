"""Feat3DNet detector + descriptor (port of feat3dnet_tpu/models/feat3dnet.py).

Eval forward only in this slice:
* detector: FPS centres -> radius neighbourhoods (first ns in index order,
  repeat-pad, nearest fallback) centred and radius-normalised -> shared
  MLP -> max pool -> MLP -> attention logaddexp(x, 0) and orientation
  atan2 of the L2-normalised 2-vector;
* descriptor: the detector's grouping rotated into the canonical
  z-orientation -> MLP -> max pool -> [pointwise | pooled] -> MLP (last
  layer BN, no ReLU) -> max pool -> MLP (no ReLU) -> L2 normalise.

On CUDA tensors FPS and the ball query run kernels K1 and K2; the tower
products are torch matmuls (the JAX package leaves them to XLA).
Module attribute names are the flax scope names ('detection',
'description', 'conv0', ...) so the weight bridge is mechanical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models.layers import ConvBN, l2_normalize
from feat3dnet_tpu_torch.ops import (ball_query, farthest_point_sample,
                                     gather_points, group_points)


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
           final_act: bool = True) -> int:
    """Register ConvBN layers `{prefix}{i}`; returns the last width."""
    for i, f in enumerate(widths):
        act = torch.relu if (final_act or i < len(widths) - 1) else None
        module.add_module(f"{prefix}{i}", ConvBN(cin, f, use_bn=cfg.use_bn,
                                                 activation=act,
                                                 bn_epsilon=cfg.bn_epsilon))
        cin = f
    return cin


def _run(module: nn.Module, prefix: str, n: int, x: torch.Tensor,
         training: bool) -> torch.Tensor:
    for i in range(n):
        x = getattr(module, f"{prefix}{i}")(x, training)
    return x


class Detector(nn.Module):
    """Attention + orientation heads over grouped clusters."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = _convs(self, "conv", 3, cfg.detector_mlp, cfg)
        c = _convs(self, "conv_post_", c, cfg.detector_mlp2, cfg)
        self.attention = nn.Linear(c, 1)
        self.orientation = nn.Linear(c, 2)

    def forward(self, grouped: torch.Tensor, training: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = _run(self, "conv", len(cfg.detector_mlp), grouped, training)
        x = torch.amax(x, dim=2, keepdim=True)                    # pool over samples
        x = _run(self, "conv_post_", len(cfg.detector_mlp2), x, training)
        att = self.attention(x)[..., 0, 0]
        attention = torch.logaddexp(att, torch.zeros((), dtype=att.dtype,
                                                     device=att.device))
        ori = l2_normalize(self.orientation(x)[..., 0, :], dim=-1, epsilon=1e-8)
        orientation = torch.atan2(ori[..., 1], ori[..., 0])
        return attention, orientation


class Descriptor(nn.Module):
    """MLP -> pool -> [pointwise | pooled] -> MLP2 -> pool -> MLP3 -> L2."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = _convs(self, "conv", 3, cfg.descriptor_mlp, cfg)
        c = _convs(self, "conv_mid_", 2 * c, cfg.descriptor_mlp2, cfg, final_act=False)
        _convs(self, "conv_post_", c, cfg.descriptor_mlp3, cfg, final_act=False)

    def forward(self, grouped: torch.Tensor, training: bool = False) -> torch.Tensor:
        cfg = self.cfg
        h = _run(self, "conv", len(cfg.descriptor_mlp), grouped, training)
        pooled = torch.amax(h, dim=2, keepdim=True).expand_as(h)
        h = torch.cat([h, pooled], dim=-1)
        h = _run(self, "conv_mid_", len(cfg.descriptor_mlp2), h, training)
        x = torch.amax(h, dim=2, keepdim=True)
        x = _run(self, "conv_post_", len(cfg.descriptor_mlp3), x, training)
        return l2_normalize(x[..., 0, :], dim=-1, epsilon=1e-8)


class Feat3DNet(nn.Module):
    """Full model, eval forward.

    Call modes:
      * keypoints=None, cfg.num_clusters > 0 — FPS centres;
      * keypoints=None, cfg.num_clusters <= 0 — every point is a keypoint;
      * keypoints given — detector + descriptor at those points.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.detection = Detector(cfg)
        self.description = Descriptor(cfg)

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
