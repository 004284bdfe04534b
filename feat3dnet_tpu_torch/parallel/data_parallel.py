"""Data-parallel training over torch.distributed (port of
feat3dnet_tpu/parallel/data_parallel.py).

Each rank is one process with its own model replica on its own device
(`nccl`, one card a rank) or on a shared one (`gloo`: CPU ranks, or
several ranks on one card, each collective staged through the host). Rank
r holds its role-aligned share of the combined triplet batch
(`shard_batch`), and the step reduces explicitly, with plain
torch.distributed calls rather than DistributedDataParallel:

  * forward: every BatchNorm's moments over the group (the model built
    with bn_group=the group: models/layers.BatchNorm on the autograd route,
    ops/fused_train's all-reduces between K7's launches on the fused one);
  * backward: the moments' all-reduce sums the cotangents, and the fused
    towers all-reduce their BN-backward sums between K9's and K10's
    launches, so each rank's gradient is its share of the summed loss's;
  * the step: one flat all-reduce averages every gradient leaf (each
    reduced once), the loss and the scalar metrics; one all-gather feeds
    the histograms.

The contract of the JAX docstrings holds: a data-parallel step equals the
single-process step on the combined batch, in loss, metrics, every
gradient leaf before the optimiser, the BN statistics and the parameters,
to the order of the sums (tests/test_torch_parallel.py, float64 within
1e-9). `quantized=True` steps take the int16 upload (q, scale): each rank
its share of q with the combined batch's scale. The chained flavour runs
k such steps in one call (each rank its share of each of the k batches).
JAX's shard_map flavours are its second sharding mechanism for the same
step; torch.distributed has one, and both routes take it.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet
from feat3dnet_tpu_torch.train.trainer import (make_chained_train_step, make_fused_train_step,
                                               make_train_step, role_rows)


def shard_batch(batch, rank: int, world: int, axis: int = 0):
    """Rank r's role-aligned share of a batch: a stacked (3B, ...) array or
    tensor -> its (3B/world, ...) rows (anchors, positives, negatives rows
    [r B/world, (r+1) B/world)) along `axis` (1 for the chained step's (k,
    3B, ...) stack); a tuple of (B, ...) arrays -> the same rows of each.
    Raises when B does not split over the ranks."""
    if isinstance(batch, (tuple, list)):
        b = batch[0].shape[0]
        if b % world:
            raise ValueError(f"batch_size {b} does not split over {world} ranks")
        k = b // world
        return type(batch)(x[rank * k:(rank + 1) * k] for x in batch)
    if batch.shape[axis] % (3 * world):
        raise ValueError(f"a stacked batch of {batch.shape[axis]} clouds does not split into "
                         f"triplets over {world} ranks")
    rows = role_rows(batch.shape[axis] // (3 * world), rank, world)
    if isinstance(batch, torch.Tensor):
        return batch.index_select(axis, rows.to(batch.device)).contiguous()
    return np.ascontiguousarray(np.take(batch, rows.numpy(), axis=axis))


def _need_group(group) -> None:
    if group is None:
        raise ValueError("a data-parallel step needs a process group")


def make_dp_train_step(model: Feat3DNet, margin: float, use_attention: bool,
                       group) -> Callable:
    """step(state, anchors, positives, negatives), each this rank's
    (B/world, N, >=3) share (`shard_batch` of the triplet): the autograd
    route (or the fused towers, as the model's config says)."""
    _need_group(group)
    return make_train_step(model, margin, use_attention, group=group)


def _check_quantized(step: Callable, quantized: bool, chained: bool) -> Callable:
    """The step, refusing the other upload than the one it was built for."""
    def checked(state, clouds):
        if isinstance(clouds, tuple) != quantized:
            raise ValueError(f"a {'chained ' if chained else ''}data-parallel step built with "
                             f"quantized={quantized} was given "
                             f"{'(q, scale)' if isinstance(clouds, tuple) else 'a float batch'}")
        return step(state, clouds)

    return checked


def make_fused_dp_train_step(model: Feat3DNet, margin: float, use_attention: bool, group,
                             augmentations: Optional[Sequence[str]] = None,
                             aug_seed: int = 0, quantized: bool = False) -> Callable:
    """step(state, clouds) with clouds this rank's (3B/world, N, >=3) share
    of the stacked batch (`shard_batch`), or with `quantized` its share of
    q and the combined batch's scale: dequantization, augmentation from the
    combined batch's draws, then the step, on the fused towers (K7-K10) when
    the model's config has fused_towers, else on autograd."""
    _need_group(group)
    return _check_quantized(make_fused_train_step(
        model, margin, use_attention, augmentations=augmentations, aug_seed=aug_seed,
        group=group), quantized, False)


def make_chained_dp_train_step(model: Feat3DNet, margin: float, use_attention: bool, group,
                               augmentations: Optional[Sequence[str]] = None,
                               aug_seed: int = 0, quantized: bool = False) -> Callable:
    """k data-parallel fused steps in one call: step(state, clouds_k) with
    clouds_k this rank's share of each of k stacked batches, (k, 3B/world,
    N, >=3) (`shard_batch(..., axis=1)`), or with `quantized` (its share of
    the (k, 3B, N, 3) int16 q, the (k,) scales). Returns (state, metrics)
    with a leading k axis; each inner step reduces over the group as the
    fused data-parallel step does."""
    _need_group(group)
    return _check_quantized(make_chained_train_step(
        model, margin, use_attention, augmentations=augmentations, aug_seed=aug_seed,
        group=group), quantized, True)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn, world: int, backend: str, devices, init_file: str,
               out_dir: str, args, collective_timeout: float, threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(devices[rank]) if devices else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=collective_timeout))
    try:
        result = fn(rank, world, dist.group.WORLD, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, backend: str = "gloo",
              devices: Optional[Sequence] = None, init_file: Optional[str] = None,
              args: Sequence[Any] = (), timeout: Optional[float] = 600.0,
              collective_timeout: float = 600.0, threads: Optional[int] = None) -> List[Any]:
    """Run fn(rank, world_size, group, device, *args) in world_size spawned
    processes joined in one process group, and return their results in
    rank order (each saved with torch.save: return CPU tensors).

    backend: `nccl` for one card a rank, `gloo` for CPU ranks or several
    ranks on one card. devices: each rank's device (default: the CPU).
    init_file: the `file://` rendezvous, a path that does not exist yet
    (default: a fresh temporary directory's), beside which the results
    are written; no port is opened. Every
    process is joined: a rank that raises fails the call with its
    traceback (the others are ended), and past `timeout` seconds (None: no
    limit) every rank is killed and TimeoutError raised. A collective that
    waits longer than `collective_timeout` seconds raises in its rank.
    threads: torch's intra-op threads per rank (default: torch's own)."""
    if devices is not None and len(devices) != world_size:
        raise ValueError(f"run_ranks: {len(devices)} devices for {world_size} ranks")
    work = tempfile.mkdtemp(prefix="f3d_ranks_",
                            dir=os.path.dirname(init_file) if init_file else None)
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, backend,
                              None if devices is None else [str(d) for d in devices],
                              init_file or os.path.join(work, "store"), work, tuple(args),
                              collective_timeout, threads),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=None if deadline is None
                           else max(0.1, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"run_ranks: {world_size} ranks still running after "
                                   f"{timeout:.0f} s")
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
