"""Model and inference configuration (mirror of feat3dnet_tpu/config.py).

Same fields, defaults and derived widths as the JAX dataclasses, with torch
dtypes in place of jnp ones. `compute_dtype` is the model's compute dtype
in eval and training, as flax's `dtype`: the towers' convs, BN outputs and
heads run in it, parameters and BN statistics stay f32, and the outputs
are f32. The training-only fields (memory modes, fused towers) round-trip
between the two packages; the eval forward ignores them. The training
forward reads `fused_towers` (f32 only, as in JAX: other compute dtypes
train through autograd), `fused_cot_dtype` and the two memory modes of the
autograd route (see ModelConfig). The extraction pipeline's fused
detector and the cluster server read their own modes, not `compute_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (reference: feat3dnet.py:192-209, train.py:36-44).

    num_clusters: FPS clusters (-1 = every point is a keypoint).
    base_scale: cluster radius in metres. num_samples: points per cluster.
    feature_dim: descriptor width. attention / regress_orientation /
    use_bn: the reference switches. bn_momentum / bn_epsilon: flax's
    BatchNorm constants (momentum 0.9 is flax's decay convention).
    remat_towers: in training on the autograd route, each tower's per-point
    segment saves only its input and is recomputed in the backward
    (torch.utils.checkpoint; bit-equal, the BN EMA applied once).
    residual_dtype: e.g. torch.bfloat16; in training every ConvBN rounds
    its Dense output and its activation's output to it (their cotangents
    too), and on the autograd route the per-point segments keep those
    rounded copies, in that dtype, as what autograd saves (with ReLU masks;
    no recompute); not bit-equal to f32 training. It takes precedence over
    remat_towers; fused_towers still takes the pre-pool segments.
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: train.py:20-67, config.py, train.sh).

    batch_size: triplets per step. num_points: points per cloud after crop
    and resample. learning_rate: Adam's (fixed, or the cosine peak).
    lr_schedule: 'constant' or 'cosine' (linear warmup over warmup_steps,
    cosine decay to 0 at decay_steps, counted in optimiser updates).
    augmentations: reference CLI names (data/augment.resolve_augmentations).
    crop_radius: metres around the origin kept before resampling.
    freeze_scopes: top-level scopes ('detection', 'description') left out
    of the optimiser. The *_every_n_steps fields are the training loop's cadences.
    """

    batch_size: int = 6
    num_points: int = 4096
    learning_rate: float = 1e-5
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    num_epochs: int = 1000
    augmentations: Sequence[str] = ("Jitter", "RotateSmall", "Shift", "Rotate1D")
    upright_axis: int = 2
    crop_radius: float = 20.0
    freeze_scopes: Optional[Sequence[str]] = None
    checkpoint_every_n_steps: int = 500
    validate_every_n_steps: int = 250
    summary_every_n_steps: int = 20
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Extraction / NMS parameters (reference: inference.py:25-59).

    nms_radius, min_response_ratio, max_keypoints: the NMS and selection
    rule (ops/nms.py). keypoint_chunk: clusters per detector pass, which
    bounds the (chunk, ns, C) tower activations. num_points (-1 = all) and
    randomize_points: the reference's cloud preprocessing.
    use_hashed_grouping: the attention pass through the Morton-culled ball
    query (K4) and ball-max NMS (K5); None = on for CUDA tensors, as the
    JAX package turns it on for the TPU. hash_block / hash_tile: points per
    culling block (0 = chosen per cloud by density) and centres per tile;
    outputs do not depend on them. use_csr_kernels: accepted for parity with
    the JAX flags; the port's kernels always walk a per-tile hit list, so
    the two settings run the same code. use_fused_detector: the attention
    pass through the detector-only kernel (K6) and the descriptor tail
    through the fused describe kernel (K3).
    """

    nms_radius: float = 0.5
    min_response_ratio: float = 1e-2
    max_keypoints: int = 1024
    keypoint_chunk: int = 8192
    num_points: int = -1
    randomize_points: bool = False
    use_hashed_grouping: Optional[bool] = None
    hash_block: int = 256
    hash_tile: int = 256
    use_csr_kernels: bool = False
    use_fused_detector: bool = False



@dataclasses.dataclass(frozen=True)
class PointNet2Config:
    """PointNet++ with multi-scale grouping (Qi et al., arXiv:1706.02413) at
    the widths of Pointnet2.PyTorch's tools/pointnet2_msg.py, PointRCNN's
    stage-1 backbone (arXiv:1812.04244): per-point foreground logits of a
    cloud sampled to `num_points` (xyz only, no input features).

    npoints / radii / nsamples / sa_mlps: the four set-abstraction levels,
    each FPS centres of the level before, one ball query and shared MLP per
    scale (radius, nsample, widths), the scales' max pools concatenated.
    fp_mlps[k]: the feature-propagation MLP that brings level k+1's
    features onto level k's points (run from the coarsest). cls_fc: the
    head's hidden convs before the one-logit conv (the source's dropout of
    0.5 after the first is the identity in eval). bn_epsilon: torch's
    BatchNorm default.
    """

    num_points: int = 16384
    npoints: Sequence[int] = (4096, 1024, 256, 64)
    radii: Sequence[Sequence[float]] = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
    nsamples: Sequence[Sequence[int]] = ((16, 32), (16, 32), (16, 32), (16, 32))
    sa_mlps: Sequence[Sequence[Sequence[int]]] = (
        ((16, 16, 32), (32, 32, 64)), ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)), ((256, 256, 512), (256, 384, 512)))
    fp_mlps: Sequence[Sequence[int]] = ((128, 128), (256, 256), (512, 512), (512, 512))
    cls_fc: Sequence[int] = (128,)
    bn_epsilon: float = 1e-5


# Padded cloud sizes: clouds are padded (with a validity mask) to the
# smallest bucket that holds them, as the JAX pipeline does.
POINT_BUCKETS = (4096, 8192, 16384, 32768, 65536, 131072)


def bucket_for(n: int) -> int:
    """Smallest bucket that holds n points."""
    for b in POINT_BUCKETS:
        if n <= b:
            return b
    return ((n + POINT_BUCKETS[-1] - 1) // POINT_BUCKETS[-1]) * POINT_BUCKETS[-1]
