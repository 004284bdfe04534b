"""Train state, train steps and the epoch loop (port of
feat3dnet_tpu/train/trainer.py).

  * triplet concat: anchors, positives and negatives stacked on the batch
    axis, one shared forward (shared BN moments across the three roles),
    split in three for the loss;
  * Adam (b1 0.9, b2 0.999, eps 1e-8) at a fixed lr or optax's
    warmup-cosine schedule, counted in optimiser updates;
  * `freeze_scopes`: those top-level scopes are left out of the optimiser;
    their BN buffers still take the EMA, as in the JAX step;
  * the fused step takes one stacked (3B, N, 3) batch, or the int16 upload
    `(q, scale)` of data/quant.py, which it dequantizes on the device as
    `q.to(float32) * scale`, and augments it there from a generator seeded
    by (aug_seed, step);
  * the chained step runs k fused steps on (k, 3B, N, 3) stacked batches
    (or `((k, 3B, N, 3) int16, (k,) f32)`) with no host synchronisation
    between them and returns every metric with a leading k axis, stacked on
    the device: bit-equal to k fused calls, since each draws its
    augmentation from (aug_seed, step);
  * `remat=True` runs the whole training forward under
    torch.utils.checkpoint (models/layers.remat): the backward recomputes
    it, bit-equal, and BatchNorm's EMA is applied once.

Everything runs where the state's model lies; `Trainer` and `init_state`
put it on `cuda` unless the caller names another device. A step's metrics
are device tensors: loss, sum_positive, sum_negative and the histograms
`hist_det_cnt` (and with attention `hist_normalized_attention`), as in the
JAX step. The fused step reads nothing back to the host. Under a profiler
each step shows as the span `f3d.train.step#<step>` around
`f3d.train.augment` (fused step), `.forward`, `.loss`, `.backward`,
`.adam` and `.metrics` (utils/profiling.py).

Data parallelism (`group=`, a torch.distributed process group; the JAX
step's `grad_reduce_axis`): each rank holds its role-aligned share of the
combined batch (rows [r B/d, (r+1) B/d) of each of anchors, positives and
negatives) and a model built with `bn_group` = the group, so every BN
moment is the combined batch's. After `loss.backward()` one flat
all-reduce averages every optimised gradient leaf, the loss and
sum_positive / sum_negative over the ranks, and one all-gather gives the
histograms the combined batch's det_cnt and normalized_attention in the
single process's row order. Each leaf is reduced once: the fused towers
return the rank's own share (ops/fused_train.py). The step then equals the
single-process step on the combined batch, to the sums' order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
from feat3dnet_tpu_torch.data.augment import augment_clouds, augment_rows
from feat3dnet_tpu_torch.data.quant import quantize_clouds
from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet
from feat3dnet_tpu_torch.models.layers import remat as remat_segment
from feat3dnet_tpu_torch.train.loss import alignment_triplet_loss
from feat3dnet_tpu_torch.utils.collectives import all_gather_rows, all_reduce_
from feat3dnet_tpu_torch.utils.convert import load_variables
from feat3dnet_tpu_torch.utils.device import resolve_device
from feat3dnet_tpu_torch.utils.init import init_variables
from feat3dnet_tpu_torch.utils.metrics_writer import device_histogram
from feat3dnet_tpu_torch.utils.profiling import span

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """step: train steps taken. count: optimiser updates taken, the lr
    schedule's count (both restore with a checkpoint)."""

    step: int
    model: Feat3DNet
    optimizer: torch.optim.Adam
    schedule: Schedule
    count: int = 0


def cosine_schedule(learning_rate: float, warmup_steps: int, decay_steps: int,
                    end_lr_ratio: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule as make_optimizer builds it: from 0
    (or from the peak without warmup) linearly to the peak over
    warmup_steps, then cosine decay to peak * end_lr_ratio at decay_steps."""
    init = 0.0 if warmup_steps > 0 else learning_rate
    end = learning_rate * end_lr_ratio
    alpha = 0.0 if learning_rate == 0.0 else end / learning_rate
    span = decay_steps - warmup_steps

    def lr(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init - learning_rate) * frac + learning_rate
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return learning_rate * ((1.0 - alpha) * cosine + alpha)

    return lr


def _frozen(name: str, freeze_scopes: Optional[Sequence[str]]) -> bool:
    scope = name.split(".")[0]
    return bool(freeze_scopes) and any(scope == s or scope.startswith(s) for s in freeze_scopes)


def make_optimizer(model: torch.nn.Module, learning_rate: float = 1e-5,
                   freeze_scopes: Optional[Sequence[str]] = None,
                   lr_schedule: str = "constant", warmup_steps: int = 0,
                   decay_steps: int = 0, end_lr_ratio: float = 0.0
                   ) -> Tuple[torch.optim.Adam, Schedule]:
    """Adam over the parameters outside `freeze_scopes`, and the lr per
    optimiser update: 'constant' or 'cosine' (see cosine_schedule)."""
    if lr_schedule == "cosine":
        if decay_steps <= 0:
            raise ValueError("cosine lr_schedule needs decay_steps > 0")
        schedule = cosine_schedule(learning_rate, warmup_steps, decay_steps, end_lr_ratio)
    elif lr_schedule == "constant":
        def schedule(count: int) -> float:
            return learning_rate
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    params = [p for n, p in model.named_parameters() if not _frozen(n, freeze_scopes)]
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8), schedule


def init_state(model: Feat3DNet, cfg: TrainConfig, model_cfg: ModelConfig, seed: int = 0,
               variables: Optional[Mapping[str, Any]] = None, device=None,
               decay_steps: Optional[int] = None) -> TrainState:
    """Weights from `variables` (a flax-layout tree, e.g. the JAX init through
    the bridge) or utils/init.py's seeded init; the model on `device`
    (`cuda` unless named); Adam from `cfg` (decay_steps overrides cfg's)."""
    load_variables(model, variables if variables is not None
                   else init_variables(model_cfg, seed=seed))
    model.to(resolve_device(device))
    opt, schedule = make_optimizer(
        model, cfg.learning_rate, cfg.freeze_scopes, cfg.lr_schedule, cfg.warmup_steps,
        cfg.decay_steps if decay_steps is None else decay_steps)
    return TrainState(step=0, model=model, optimizer=opt, schedule=schedule)


def role_rows(local_batch: int, rank: int, world: int, device=None) -> torch.Tensor:
    """The rows of the combined (3 B, ...) stacked batch, B = local_batch *
    world, that rank `rank` holds: its role-aligned share, anchors rows
    [r b, (r+1) b), then the positives' and the negatives' same rows."""
    total = local_batch * world
    own = torch.arange(rank * local_batch, (rank + 1) * local_batch, device=device)
    return torch.cat([own + role * total for role in range(3)])


def _average_grads(optimizer: torch.optim.Optimizer, scalars, group):
    """One all-reduce: every optimised gradient leaf and the scalars,
    summed over the ranks and divided by their count. Returns the scalars."""
    params = [p for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    dtype = params[0].grad.dtype if params else scalars[0].dtype
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [s.reshape(1).to(dtype) for s in scalars])
    flat = all_reduce_(flat, group) / dist.get_world_size(group)
    off = 0
    for p in params:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
        off += p.numel()
    return [flat[off + i].to(s.dtype) for i, s in enumerate(scalars)]


def _gather_histogram_inputs(det_cnt: torch.Tensor, norm_att: Optional[torch.Tensor], group):
    """One all-gather: the combined batch's det_cnt (3 B, M) in the single
    process's row order (anchors, positives, negatives of every rank) and
    normalized_attention (B, M), both f32 as device_histogram takes them."""
    w = dist.get_world_size(group)
    parts = [det_cnt.reshape(-1)]
    if norm_att is not None:
        parts.append(norm_att.reshape(-1).to(torch.float32))
    gathered = all_gather_rows(torch.cat(parts), group)
    n_det = det_cnt.numel()
    rows = det_cnt.shape[0] // 3
    det = gathered[:, :n_det].reshape((w, 3, rows) + tuple(det_cnt.shape[1:]))
    det = det.transpose(0, 1).reshape((3 * w * rows,) + tuple(det_cnt.shape[1:]))
    if norm_att is None:
        return det, None
    return det, gathered[:, n_det:].reshape((w * norm_att.shape[0],) + tuple(norm_att.shape[1:]))


def _train_core(state: TrainState, clouds: torch.Tensor, margin: float,
                use_attention: bool, group=None, remat: bool = False
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    model = state.model
    with span("f3d.train.forward"):
        model.zero_grad(set_to_none=True)
        if remat:
            out = remat_segment(lambda c: model(c, training=True), clouds)
        else:
            out = model(clouds, training=True)
    with span("f3d.train.loss"):
        a_feat, p_feat, n_feat = torch.chunk(out.features, 3, dim=0)
        a_att = torch.chunk(out.attention, 3, dim=0)[0] if use_attention else None
        loss, aux = alignment_triplet_loss(a_feat, p_feat, n_feat, a_att, margin)
    with span("f3d.train.backward"):
        loss.backward()
        scalars = [loss.detach(), aux["sum_positive"].mean().detach(),
                   aux["sum_negative"].mean().detach()]
        if group is not None:
            scalars = _average_grads(state.optimizer, scalars, group)
    with span("f3d.train.adam"):
        for pg in state.optimizer.param_groups:
            pg["lr"] = state.schedule(state.count)
        state.optimizer.step()
        state.count += 1
        state.step += 1
    with span("f3d.train.metrics"):
        # the reference's TensorBoard histograms (pts_cnt, normalized_attention),
        # on the device
        det_cnt = out.end_points["det_cnt"].detach().float()
        norm_att = (aux["normalized_attention"].detach() if "normalized_attention" in aux
                    else None)
        if group is not None:
            det_cnt, norm_att = _gather_histogram_inputs(det_cnt, norm_att, group)
        metrics = {"loss": scalars[0], "sum_positive": scalars[1], "sum_negative": scalars[2],
                   "hist_det_cnt": device_histogram(det_cnt)}
        if norm_att is not None:
            metrics["hist_normalized_attention"] = device_histogram(norm_att)
    return state, metrics


def _check_group(model: Feat3DNet, group) -> None:
    if group is not None and getattr(model, "bn_group", None) is not group:
        raise ValueError("a data-parallel step needs the model built with bn_group= its "
                         "process group, so that BN moments reduce over the ranks")


def make_train_step(model: Feat3DNet, margin: float, use_attention: bool,
                    group=None, remat: bool = False) -> Callable:
    """step(state, anchors, positives, negatives) -> (state, metrics), each
    (B, N, >=3) on the model's device; state is updated in place. group:
    the process group of a data-parallel step (each rank passes its
    role-aligned share; the model built with bn_group=group), or None.
    remat: recompute the whole forward in the backward instead of saving
    its activations."""
    _check_group(model, group)

    def step(state: TrainState, anchors, positives, negatives):
        if state.model is not model:
            raise ValueError("train step: the state holds another model")
        with span("f3d.train.step", state.step):
            clouds = torch.cat([anchors, positives, negatives], dim=0)[..., :3]
            return _train_core(state, clouds.contiguous(), margin, use_attention, group,
                               remat)

    return step


def aug_generator(device: torch.device, aug_seed: int, step: int) -> torch.Generator:
    """The augmentation generator of one step: seeded by (aug_seed, step), so
    a resumed run draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed(
        (aug_seed * 0x9E3779B97F4A7C15 + step) % (1 << 63))


def dequantize(clouds):
    """The int16 upload `(q, scale)` -> q.to(float32) * scale on q's device;
    a float batch as it is."""
    if isinstance(clouds, tuple):
        q, scale = clouds
        return q.to(torch.float32) * scale
    return clouds


def make_fused_train_step(model: Feat3DNet, margin: float, use_attention: bool,
                          augmentations: Optional[Sequence[str]] = None,
                          aug_seed: int = 0, group=None, remat: bool = False) -> Callable:
    """step(state, clouds) with clouds the stacked (3B, N, >=3) f32 batch,
    anchors | positives | negatives, or its int16 upload `(q, scale)` (q
    (3B, N, 3) int16, scale a 0-d f32 tensor, both on the device),
    dequantized and then augmented on its device first. group: as
    make_train_step; clouds is then the rank's role-aligned share of the
    combined batch (parallel/data_parallel.shard_batch; quantized, its
    share of q with the combined batch's scale), and each rank draws the
    combined batch's augmentation and applies its rows' values. remat: as
    make_train_step."""
    _check_group(model, group)

    def step(state: TrainState, clouds):
        if state.model is not model:
            raise ValueError("train step: the state holds another model")
        with span("f3d.train.step", state.step):
            with span("f3d.train.augment"):
                clouds = dequantize(clouds)[..., :3]
                if augmentations:
                    gen = aug_generator(clouds.device, aug_seed, state.step)
                    if group is None:
                        clouds = augment_clouds(gen, clouds, augmentations)
                    else:
                        w = dist.get_world_size(group)
                        rows = role_rows(clouds.shape[0] // 3, dist.get_rank(group), w,
                                         clouds.device)
                        clouds = augment_rows(gen, clouds, augmentations, rows,
                                              clouds.shape[0] * w)
            return _train_core(state, clouds.contiguous(), margin, use_attention, group,
                               remat)

    return step


def stack_metrics(metrics: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-step metric trees -> one tree whose leaves gain a leading axis
    (torch.stack on their device)."""
    return {k: stack_metrics([m[k] for m in metrics]) if isinstance(v, dict)
            else torch.stack([m[k] for m in metrics]) for k, v in metrics[0].items()}


def make_chained_train_step(model: Feat3DNet, margin: float, use_attention: bool,
                            augmentations: Optional[Sequence[str]] = None,
                            aug_seed: int = 0, group=None, remat: bool = False) -> Callable:
    """k fused steps in one call: step(state, clouds_k) with clouds_k the
    (k, 3B, N, >=3) stack of k batches, or their int16 upload ((k, 3B, N, 3)
    int16, (k,) f32 scales). The steps are queued back to back with no host
    synchronisation; returns (state, metrics) with a leading k axis on every
    metric leaf. Bit-equal to k calls of make_fused_train_step's step.
    group, remat: as make_fused_train_step (each rank passes its share of
    each of the k batches)."""
    fused = make_fused_train_step(model, margin, use_attention, augmentations=augmentations,
                                  aug_seed=aug_seed, group=group, remat=remat)

    def step(state: TrainState, clouds_k):
        if isinstance(clouds_k, tuple):
            q_k, scale_k = clouds_k
            if scale_k.shape != q_k.shape[:1]:
                raise ValueError(f"chained step: {tuple(scale_k.shape)} scales for "
                                 f"{q_k.shape[0]} quantized batches")
            batches = [(q_k[j], scale_k[j]) for j in range(q_k.shape[0])]
        else:
            batches = list(clouds_k.unbind(0))
        if not batches:
            raise ValueError("chained step: no batch")
        per_step = []
        for clouds in batches:
            state, metrics = fused(state, clouds)
            per_step.append(metrics)
        return state, stack_metrics(per_step)

    return step


def _stacked(batch) -> np.ndarray:
    a, p, n = batch
    return np.concatenate([a[..., :3], p[..., :3], n[..., :3]], axis=0)


def upload(stacked: np.ndarray, device, quant: bool = False, chained: bool = False):
    """A host batch -> the step's input on `device`: the float32 stack, or
    with `quant` its int16 upload (data/quant.quantize_clouds): (q, 0-d
    scale); chained, a (k, 3B, N, 3) stack whose batches are quantized one
    by one, (q, (k,) scales), so a chunk carries what k single uploads
    would."""
    if not quant:
        return torch.from_numpy(np.ascontiguousarray(stacked, np.float32)).to(device)
    if chained:
        pairs = [quantize_clouds(s) for s in stacked]
        q = np.stack([p[0] for p in pairs])
        scale = np.array([p[1] for p in pairs], np.float32)
    else:
        q, scale = quantize_clouds(stacked)
        scale = np.asarray(scale, np.float32)
    return torch.from_numpy(q).to(device), torch.from_numpy(scale).to(device)


def stack_triplet(batch, device, quant: bool = False):
    """(anchors, positives, negatives) host arrays -> the stacked (3B, N, 3)
    batch on `device` (the prefetch thread's host-to-device copy; quant:
    its int16 upload)."""
    return upload(_stacked(batch), device, quant)


def stack_chunk(batches, device, quant: bool = False):
    """k triplets -> the chained step's (k, 3B, N, 3) stack on `device`
    (quant: its int16 upload, a scale a batch)."""
    return upload(np.stack([_stacked(b) for b in batches]), device, quant, chained=True)


class Trainer:
    """The epoch loop: the fused step over a triplet iterator, with the
    batch stacked and copied to the device by the prefetch thread.

    augmentations: resolved names applied on the device inside the step
    (generator per (seed + 1, step)); None trains on the batches as given.
    device: `cuda` unless the caller names another (raises without one).
    group: the process group of data-parallel training (the model built
    with bn_group=group; train_cfg.batch_size is the combined batch, and
    `fit` takes this rank's batches of batch_size / ranks triplets).
    """

    def __init__(self, model: Feat3DNet, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 log_fn=None, augmentations: Optional[Sequence[str]] = None, device=None,
                 group=None):
        if group is not None and train_cfg.batch_size % dist.get_world_size(group):
            raise ValueError(f"batch_size {train_cfg.batch_size} does not split over "
                             f"{dist.get_world_size(group)} ranks")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.step_fn = make_fused_train_step(
            model, model_cfg.margin, model_cfg.attention,
            augmentations=tuple(augmentations) if augmentations else None,
            aug_seed=train_cfg.seed + 1, group=group)
        self.log = log_fn or (lambda *a, **k: None)

    def init(self, seed: int = 0, variables: Optional[Mapping[str, Any]] = None) -> TrainState:
        return init_state(self.model, self.train_cfg, self.model_cfg, seed, variables,
                          self.device)

    def fit(self, state: TrainState, data_iter, num_steps: int,
            hooks: Optional[Dict[int, Callable]] = None):
        """Run up to `num_steps` steps; hooks maps a period to fn(state, metrics)."""
        from feat3dnet_tpu_torch.data.datagenerator import prefetch

        hooks = hooks or {}
        metrics = None

        def take(it, n):
            for _ in range(n):
                batch = next(it, None)
                if batch is None:
                    return
                yield batch

        for clouds in prefetch(take(iter(data_iter), num_steps),
                               transform=lambda b: stack_triplet(b, self.device)):
            state, metrics = self.step_fn(state, clouds)
            for period, fn in hooks.items():
                if state.step % period == 0:
                    fn(state, metrics)
        return state, metrics
