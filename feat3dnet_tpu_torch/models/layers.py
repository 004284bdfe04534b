"""Shared-MLP building blocks (port of feat3dnet_tpu/models/layers.py).

`ConvBN` is a per-point Dense (the reference's 1x1 conv2d) with its bias
kept under BN, then eval-mode batch norm in flax's own op order, then the
activation. Submodule and variable names mirror the flax tree
(`conv2d/{kernel,bias}`, `bn/{scale,bias}`, batch_stats `bn/{mean,var}`)
so utils/convert.py maps them mechanically.

`nn.BatchNorm*` is not used: its momentum runs the other way (flax's 0.9
is torch's 0.1) and its eval formula rounds differently from flax's
`(x - mean) * (rsqrt(var + eps) * scale) + bias`. Training-mode BN arrives
with the training slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


class EvalBatchNorm(nn.Module):
    """flax BatchNorm at eval: params scale/bias, buffers mean/var."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        return (x - self.mean) * mul + self.bias


class ConvBN(nn.Module):
    """Dense (= 1x1 conv) + optional eval BN + activation (after BN)."""

    def __init__(self, cin: int, features: int, use_bn: bool = True,
                 activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = torch.relu,
                 bn_epsilon: float = 1e-3):
        super().__init__()
        self.conv2d = nn.Linear(cin, features)
        self.bn = EvalBatchNorm(features, bn_epsilon) if use_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if training:
            raise NotImplementedError("training-mode BN arrives with the training slice")
        x = self.conv2d(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


def l2_normalize(x: torch.Tensor, dim: int = -1, epsilon: float = 1e-8) -> torch.Tensor:
    """tf.nn.l2_normalize semantics: x * rsqrt(max(sum(x^2), epsilon))."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=epsilon))
