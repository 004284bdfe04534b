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

Memory modes of training:
* `remat` (flax's nn.remat): a segment run under torch.utils.checkpoint
  saves only its inputs and is recomputed in the backward, bit-equal.
  BatchNorm writes its EMA in the forward only, never in the recompute, so
  a step applies it once, as flax does.
* residual_dtype (JAX's squash points, `ConvBN(residual_dtype=)`): in
  training the Dense output and the activation's output are rounded to
  that dtype and back; autograd's ToCopyBackward rounds the cotangent
  there the same way, as JAX's transpose of the cast does. Inside
  `residual_saving()` every tensor autograd saves that is exact in the low
  dtype (a squash point's output, BN's f32 view of a low-precision input,
  the descriptor's concat of squashed tensors) is kept as its low-precision
  copy, and BN's normalise and the ReLU save nothing else full-size (the
  input and a bool mask): the bytes JAX's save_only_these_names policy
  keeps, with no recompute. Gradients equal those of the same squash
  points without the packing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from feat3dnet_tpu_torch.utils.collectives import all_reduce_sum

_recompute = threading.local()


def recomputing() -> bool:
    """Whether this thread is recomputing a `remat` segment for the backward."""
    return getattr(_recompute, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_context():
    _recompute.depth = getattr(_recompute, "depth", 0) + 1
    try:
        yield
    finally:
        _recompute.depth -= 1


def remat(fn: Callable, *args):
    """fn(*args) under torch.utils.checkpoint (non-reentrant): the backward
    recomputes the segment from its inputs (flax nn.remat), bit-equal to the
    forward; BatchNorm skips its EMA while recomputing."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute_context()))


def keep_low(t: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """Mark t as exactly `low` (a lower-precision tensor of the same values):
    residual_saving() saves `low` in its place."""
    t._residual_low = low
    return t


class _Low:
    __slots__ = ("low", "dtype")

    def __init__(self, low: torch.Tensor, dtype: torch.dtype):
        self.low, self.dtype = low, dtype


def _pack(t: torch.Tensor):
    low = getattr(t, "_residual_low", None)
    base = t._base
    if low is None and base is not None and base.is_contiguous():
        # a view of a marked tensor (e.g. Dense's 2-D view of its input)
        base_low = getattr(base, "_residual_low", None)
        if base_low is not None:
            low = base_low.as_strided(t.size(), t.stride(), t.storage_offset())
    return t if low is None else _Low(low, t.dtype)


def _unpack(p):
    return p.low.to(p.dtype) if isinstance(p, _Low) else p


def residual_saving():
    """Context in which autograd saves each keep_low-marked tensor as its
    low-precision copy (residual_dtype's memory saving)."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


def squash_residual(x: torch.Tensor, dtype: Any, active: bool) -> torch.Tensor:
    """x rounded to `dtype` and back when active (a squash point), marked so
    that residual_saving() keeps the rounded copy."""
    if not active or x.dtype == dtype:
        return x
    low = x.to(dtype)
    return keep_low(low.to(x.dtype), low)


class _Normalize(torch.autograd.Function):
    """(x - mean) * mul + bias over the last axis's channels, saving x, mean
    and mul (not x - mean); the gradients of that expression."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias):
        ctx.save_for_backward(x, mean, mul)
        return (x - mean) * mul + bias

    @staticmethod
    def backward(ctx, g):
        x, mean, mul = ctx.saved_tensors
        axes = tuple(range(g.dim() - 1))
        gd = g * mul
        return gd, (-gd).sum(axes), (g * (x - mean)).sum(axes), g.sum(axes)


class _Relu(torch.autograd.Function):
    """relu(z), saving the bool mask z > 0 (not the f32 output)."""

    @staticmethod
    def forward(ctx, z):
        mask = z > 0
        ctx.save_for_backward(mask)
        return torch.where(mask, z, torch.zeros((), dtype=z.dtype, device=z.device))

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))


class Dense(nn.Linear):
    """flax nn.Dense with compute dtype `dtype` (f32 parameters); use_bias
    False: no bias (a conv followed by BN, as PointNet++'s)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.float32,
                 use_bias: bool = True):
        super().__init__(cin, features, bias=use_bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            # one f32 rounding apart from flax's product-then-add; the bias
            # rides the GEMM
            return F.linear(x, self.weight, self.bias)
        dt = self.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


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
        """flax's EMA of the batch moments into the running statistics (not
        while a `remat` segment recomputes: once a step)."""
        if recomputing():
            return
        m = self.momentum
        self.mean.copy_(m * self.mean + (1.0 - m) * batch_mean)
        self.var.copy_(m * self.var + (1.0 - m) * batch_var)

    def forward(self, x: torch.Tensor, training: bool = False,
                residual: bool = False) -> torch.Tensor:
        """residual: residual_dtype's training forward (the same values; the
        f32 view of a low-precision input marked for residual_saving, the
        normalise saving its input, not x - mean)."""
        low = self.dtype != torch.float32
        if low:
            x = keep_low(x.to(torch.float32), x) if residual else x.to(torch.float32)
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
        y = _Normalize.apply(x, mean, mul, self.bias) if residual \
            else (x - mean) * mul + self.bias
        return y.to(self.dtype) if low else y


def weights_key(tensors: Iterable[Optional[torch.Tensor]]) -> tuple:
    """Each tensor's (`_version`, `data_ptr()`), None skipped: it changes on
    a load, an in-place update or a move, without reading a value."""
    return tuple((t._version, t.data_ptr()) for t in tensors if t is not None)


def fold_bn(kernel: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
            beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN folded into the Dense before it: BN(x @ kernel + bias) =
    x @ kernel' + bias' for a (Cin, Cout) kernel, with mul = scale *
    rsqrt(var + eps): kernel' = kernel * mul, bias' = (bias - mean) * mul +
    beta (an affine map on fixed statistics)."""
    mul = scale * torch.rsqrt(var + eps)
    return kernel * mul[None, :], (bias - mean) * mul + beta


class ConvBN(nn.Module):
    """Dense (= 1x1 conv; use_bias False drops its bias) + optional BN +
    activation (after BN), computed in `dtype`. residual_dtype (training
    only): squash points after the Dense output and after the activation;
    BN's moments are taken over the squashed values.

    Eval with BN in f32 and autograd off runs as one GEMM: BN folded into
    the Dense (`fold_bn`), the ReLU in the product's epilogue
    (`torch._addmm_activation`: cuBLASLt's bias+ReLU on CUDA), on the
    input's own 2-D shape. The fold is kept on the layer and made anew
    when any of the Dense's and BN's tensors changes (`weights_key`: a
    load, an in-place update, a move), never under CUDA graph
    capture. Training, autograd-on eval (the cached fold carries no
    graph back to BN's parameters) and another compute dtype (bf16 rounds
    the product before BN) run the layers one by one. Class-wide
    counters, as the kernel wrappers' `.launches`: `folded_calls` (GEMMs
    run folded) and `fold_refreshes` (folds made)."""

    folded_calls = 0
    fold_refreshes = 0

    def __init__(self, cin: int, features: int, use_bn: bool = True,
                 activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = torch.relu,
                 bn_epsilon: float = 1e-3, bn_momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32, bn_group=None,
                 residual_dtype: Any = None, use_bias: bool = True):
        super().__init__()
        self.conv2d = Dense(cin, features, dtype, use_bias)
        self.bn = BatchNorm(features, bn_epsilon, bn_momentum, dtype, bn_group) \
            if use_bn else None
        self.activation = activation
        self.residual_dtype = residual_dtype
        self._fold = None           # (key, kernel', bias')

    def _folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The folded (Cin, Cout) kernel and bias of the current tensors."""
        dense, bn = self.conv2d, self.bn
        key = weights_key((dense.weight, dense.bias, bn.scale, bn.bias, bn.mean, bn.var))
        if self._fold is None or self._fold[0] != key:
            if dense.weight.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("ConvBN: eval fold missing under CUDA graph capture; "
                                   "run the layer once outside the capture first")
            bias = torch.zeros_like(bn.mean) if dense.bias is None else dense.bias
            self._fold = (key, *fold_bn(dense.weight.t(), bias, bn.scale, bn.bias,
                                        bn.mean, bn.var, bn.epsilon))
            ConvBN.fold_refreshes += 1
        return self._fold[1], self._fold[2]

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if not training and self.bn is not None and not torch.is_grad_enabled() \
                and self.conv2d.dtype == self.bn.dtype == torch.float32:
            kernel, bias = self._folded()
            x2d = x.reshape(-1, x.shape[-1])
            if self.activation is torch.relu:
                y = torch._addmm_activation(bias, x2d, kernel)
            else:
                y = torch.addmm(bias, x2d, kernel)
                if self.activation is not None:
                    y = self.activation(y)
            ConvBN.folded_calls += 1
            return y.reshape(*x.shape[:-1], y.shape[-1])
        squash = self.residual_dtype is not None and training
        x = squash_residual(self.conv2d(x), self.residual_dtype, squash)
        if self.bn is not None:
            x = self.bn(x, training, residual=squash)
        if self.activation is not None:
            act = _Relu.apply if squash and self.activation is torch.relu else self.activation
            x = squash_residual(act(x), self.residual_dtype, squash)
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
