"""Shared-MLP building blocks (port of feat3dnet_tpu/models/layers.py).

`ConvBN` is a per-point Dense (the reference's 1x1 conv2d) with its bias
kept under BN, then batch norm with flax's semantics, then the
activation. Submodule and variable names mirror the flax tree
(`conv2d/{kernel,bias}`, `bn/{scale,bias}`, batch_stats `bn/{mean,var}`)
so utils/convert.py maps them mechanically.

`dtype` is flax's compute dtype; parameters and BN buffers stay f32.
Dense follows flax's nn.Dense: input, kernel and bias cast to `dtype`,
the product in `dtype` (rounded), then the bias added in `dtype`. The f32
default casts nothing: the layers compute in their tensors' own dtype, so
a model moved to float64 (a reference) stays float64.

BatchNorm follows flax.linen.BatchNorm (`force_float32_reductions`) in
both modes:
* eval: `(x - mean) * (rsqrt(var + eps) * scale) + bias` on the running
  statistics, in f32, cast to `dtype` once at the end (another `dtype`
  than f32);
* training: the batch moments of the f32 input over every non-channel
  axis, with the fast biased variance `max(0, mean(x^2) - mean(x)^2)`,
  the same normalise formula (the loss differentiates through the
  moments), and the f32 EMA `ra = m * ra + (1 - m) * batch` (m = 0.9)
  written to the buffers without grad.
`nn.BatchNorm*` / `F.batch_norm` are not used: their momentum runs the
other way (flax's 0.9 is torch's 0.1) and their running variance is the
unbiased one.

Data parallelism (flax's `axis_name`): a BatchNorm given a
torch.distributed `group` takes its training moments over the whole
group's batch. Each rank's [mean(x), mean(x^2)] is summed over the ranks
in one differentiable all-reduce (utils/collectives.all_reduce_sum, whose
backward sums the cotangents) and divided by the group's size: every rank
holds as many rows (the data-parallel step's shards are equal), so that is
the global mean. Averaging the ranks' means, not dividing a summed sum by
the summed count, keeps a group of one bit-equal to no group on CUDA too,
where `mean` multiplies the sum by 1/n. The EMA takes the global moments.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from feat3dnet_tpu_torch.utils.collectives import all_reduce_sum


class Dense(nn.Linear):
    """flax nn.Dense with compute dtype `dtype` (f32 parameters)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            # one f32 rounding apart from flax's product-then-add; the bias
            # rides the GEMM
            return F.linear(x, self.weight, self.bias)
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class BatchNorm(nn.Module):
    """flax BatchNorm: params scale/bias, buffers mean/var (all f32); the
    output in `dtype`. group: the process group whose ranks share the
    training moments, or None."""

    def __init__(self, features: int, epsilon: float = 1e-3, momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32, group=None):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.group = group
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def update_stats(self, batch_mean: torch.Tensor, batch_var: torch.Tensor) -> None:
        """flax's EMA of the batch moments into the running statistics."""
        m = self.momentum
        self.mean.copy_(m * self.mean + (1.0 - m) * batch_mean)
        self.var.copy_(m * self.var + (1.0 - m) * batch_var)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        low = self.dtype != torch.float32
        if low:
            x = x.to(torch.float32)
        if not training:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            mean2 = (x * x).mean(dim=axes)
            if self.group is not None:
                both = all_reduce_sum(torch.stack([mean, mean2]), self.group) \
                    / dist.get_world_size(self.group)
                mean, mean2 = both[0], both[1]
            var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
            self.update_stats(mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean) * mul + self.bias
        return y.to(self.dtype) if low else y


class ConvBN(nn.Module):
    """Dense (= 1x1 conv) + optional BN + activation (after BN), computed in
    `dtype`."""

    def __init__(self, cin: int, features: int, use_bn: bool = True,
                 activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = torch.relu,
                 bn_epsilon: float = 1e-3, bn_momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__()
        self.conv2d = Dense(cin, features, dtype)
        self.bn = BatchNorm(features, bn_epsilon, bn_momentum, dtype, bn_group) \
            if use_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        x = self.conv2d(x)
        if self.bn is not None:
            x = self.bn(x, training)
        if self.activation is not None:
            x = self.activation(x)
        return x


class FullyConnected(nn.Module):
    """Dense + optional BN + activation (after BN), the reference's
    `fully_connected` (layers.py:131-167), which 3DFeat-Net does not call.
    Submodules `dense` and `bn` (momentum 0.9, epsilon 1e-3) are flax's
    names, so utils/convert maps a flax FullyConnected's variables onto it."""

    def __init__(self, cin: int, features: int, use_bn: bool = False,
                 activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = torch.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(cin, features, dtype)
        self.bn = BatchNorm(features, 1e-3, 0.9, dtype) if use_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        x = self.dense(x)
        if self.bn is not None:
            x = self.bn(x, training)
        if self.activation is not None:
            x = self.activation(x)
        return x


def dropout(x: torch.Tensor, generator: torch.Generator, keep_prob: float = 0.5,
            training: bool = True) -> torch.Tensor:
    """Functional dropout (reference layers.py:107-128): each element kept
    with probability keep_prob (a draw of `generator`, on x's device) and
    scaled by 1 / keep_prob, else 0; x itself when not training or
    keep_prob >= 1."""
    if not training or keep_prob >= 1.0:
        return x
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def to_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in the compute dtype; f32, the default, leaves x's own dtype."""
    return x if dtype == torch.float32 else x.to(dtype)


def from_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An output back in f32 from another compute dtype."""
    return x if dtype == torch.float32 else x.to(torch.float32)


def l2_normalize(x: torch.Tensor, dim: int = -1, epsilon: float = 1e-8) -> torch.Tensor:
    """tf.nn.l2_normalize semantics: x * rsqrt(max(sum(x^2), epsilon))."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=epsilon))


def pairwise_sqdist_features(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, D) x (B, M, D) -> (B, N, M) squared L2 between descriptor sets:
    the |a|^2 + |b|^2 - 2ab expansion clamped at 0 (safe for L2-normalised
    descriptors), with jnp.maximum's even gradient split at the clamp."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    ab = torch.einsum("bnd,bmd->bnm", a, b)
    d = a2 + b2 - 2.0 * ab
    return torch.maximum(d, torch.zeros_like(d))
