"""Model configuration (mirror of feat3dnet_tpu/config.py:ModelConfig).

Same fields, defaults and derived widths as the JAX dataclass, with torch
dtypes in place of jnp ones. The training-only fields (remat, residual
dtype, fused towers) are kept so that configurations round-trip between
the two packages; this slice runs only the eval forward and ignores them.
`TrainConfig` and `InferenceConfig` arrive with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (reference: feat3dnet.py:192-209, train.py:36-44).

    num_clusters: FPS clusters (-1 = every point is a keypoint).
    base_scale: cluster radius in metres. num_samples: points per cluster.
    feature_dim: descriptor width. attention / regress_orientation /
    use_bn: the reference switches. bn_momentum / bn_epsilon: flax's
    BatchNorm constants (momentum 0.9 is flax's decay convention).
    """

    num_clusters: int = 512
    base_scale: float = 2.0
    num_samples: int = 64
    feature_dim: int = 32
    attention: bool = True
    regress_orientation: bool = True
    use_bn: bool = True
    margin: float = 0.2
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-3
    compute_dtype: Any = torch.float32
    remat_towers: bool = False
    residual_dtype: Any = None
    fused_towers: bool = False
    fused_cot_dtype: Any = torch.bfloat16

    detector_mlp: Sequence[int] = (64, 128, 256)
    detector_mlp2: Sequence[int] = (128, 64)
    descriptor_mlp: Sequence[int] = (32, 64)

    @property
    def descriptor_mlp2(self) -> Sequence[int]:
        return (256,) if self.feature_dim > 64 else (128,)

    @property
    def descriptor_mlp3(self) -> Sequence[int]:
        return (self.feature_dim,)
