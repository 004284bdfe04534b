"""Training CLI of the port (flags of feat3dnet_tpu/cli/train.py).

    python -m feat3dnet_tpu_torch.cli.train --data_dir data/oxford \\
        --noattention --noregress --num_epochs 2 \\
        --augmentation Jitter RotateSmall Shift --log_dir ckpt_stage1 --fused_towers

    python -m feat3dnet_tpu_torch.cli.train --data_dir data/oxford \\
        --checkpoint ckpt_stage1 --restore_exclude detection \\
        --augmentation Jitter RotateSmall Shift Rotate1D --num_epochs 70 --fused_towers

Runs on `--device` (default cuda; raises without a CUDA device, cpu only
when named). `--variables <npz>` gives initial weights as a flat npz of
the flax variable tree (e.g. the shipped ckpt4480, or a JAX run exported
by scripts/export_jax_train_state.py), with `--restore_exclude` applied to
it; when the npz holds an Adam state (opt_state/mu, nu, count and step),
the optimiser, the step and the schedule count are restored too, the
excluded scopes' moments from zero at that count (utils/convert.py's Adam
bridge). `--tf1_checkpoint <npz>` restores a TF1 export of the reference's
weights into the seeded init (utils/tf1_loader.py; `--restore_exclude`,
names the model lacks are skipped); `--checkpoint` restores a checkpoint
of this CLI. It logs to `<log_dir>/log.txt` and stdout, writes
`metrics.jsonl` (loss, sum_positive, sum_negative and the histograms
hist_det_cnt and, with attention, hist_normalized_attention every
summary_every_n_steps; read from the device only on those steps) and,
with `--tensorboard` (needs the `tensorboard` package), the same into
TensorBoard event files under `<log_dir>/tb`; `ckpt/ckpt_<step>.pt` every
checkpoint_every_n_steps and at the end; `--auto_resume` continues from
the latest one. When `<data_dir>/clusters/filenames.txt` exists, the
cluster-pair validator (eval/validate.py) runs after the first step and
every validate_every_n_steps (0 turns it off), logs `FP Rate` and writes
`fp_rate` rows to metrics.jsonl. `--compute_dtype bfloat16` computes the
model in bf16 (f32 parameters; the towers train through autograd, as in
JAX). The triplets come from TripletDataset's default reader, the native
C++ one where it builds (as the JAX CLI's do; log.txt names the reader).

`--steps_per_dispatch k` runs k steps a call (trainer.make_chained_train_step):
the prefetch thread stacks and uploads k batches at a time, an epoch's
ragged tail is a shorter chunk, and the metrics of a chunk are read to
the host once, after it; every inner step that falls on the summary
cadence writes its row, and a checkpoint or validation that falls inside
a chunk runs after it (on the chunk's last step). `--upload_quant int16`
uploads the batches as int16 with one f32 scale a batch (data/quant.py),
dequantized on the device; a chunk's batches keep their own scales, so
the rows do not depend on k. `--remat_towers` and `--residual_dtype
bfloat16` set the model's memory modes (models/feat3dnet.py; the
autograd route).

Data parallelism: `--num_devices N` spawns N ranks
(parallel/data_parallel.run_ranks): `nccl` on cuda:0 .. cuda:N-1 (raises
when fewer cards are found, naming how many), or `gloo` with `--device
cpu`. Under torchrun (its RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT are
set) the process joins that group instead, on cuda:LOCAL_RANK:

    torchrun --nproc_per_node 4 -m feat3dnet_tpu_torch.cli.train --fused_towers ...

--batch_size is the combined batch (it must split over the ranks); each
rank reads its slice of every epoch's order (multihost.shard_dataset) in
batches of batch_size / ranks, and every rank takes the same number of
steps. The model's BN moments and the gradients reduce over the ranks
(train/trainer.py), so a step equals one process's on the combined batch.
With `--upload_quant int16` each rank quantizes its own batches (a scale
a rank and batch); with `--steps_per_dispatch k` every rank runs the
chained data-parallel step.
Rank 0 alone writes the log, the metrics rows and the checkpoints and runs
the validation. In the spawning process `main` returns each rank's
{"rank", "step", "loss"}.
"""
from __future__ import annotations

import argparse
import itertools
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train 3DFeat-Net (PyTorch port)")
    p.add_argument("--data_dim", type=int, default=6)
    p.add_argument("--data_dir", type=str, default="data/oxford",
                   help='Should contain "train" (and "clusters" for validation)')
    p.add_argument("--model", type=str, default="3DFeatNet")
    p.add_argument("--noregress", action="store_true")
    p.add_argument("--noattention", action="store_true")
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--feature_dim", type=int, default=32, choices=[16, 32, 64, 128])
    p.add_argument("--num_points", type=int, default=4096)
    p.add_argument("--base_scale", type=float, default=2.0)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--num_clusters", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--lr_schedule", type=str, default="constant", choices=["constant", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--decay_steps", type=int, default=0,
                   help="cosine horizon in optimiser steps; 0 = this run's epochs x steps")
    p.add_argument("--augmentation", type=str, nargs="+",
                   default=["Jitter", "RotateSmall", "Shift", "Rotate1D"],
                   choices=["Jitter", "RotateSmall", "Rotate1D", "Scale", "Shift"])
    p.add_argument("--log_dir", type=str, default="./ckpt")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint dir of this CLI to restore (its ckpt/ or itself)")
    p.add_argument("--variables", type=str, default=None,
                   help="flat npz of the flax variable tree as initial weights")
    p.add_argument("--tf1_checkpoint", type=str, default=None,
                   help="npz export of a reference TF1 checkpoint")
    p.add_argument("--restore_exclude", type=str, nargs="+", default=None)
    p.add_argument("--freeze_scopes", type=str, nargs="+", default=None)
    p.add_argument("--num_epochs", type=int, default=1000)
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the latest checkpoint in --log_dir if one exists")
    p.add_argument("--summary_every_n_steps", type=int, default=20)
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror metrics into TensorBoard event files (log_dir/tb; needs "
                        "the tensorboard package)")
    p.add_argument("--validate_every_n_steps", type=int, default=250)
    p.add_argument("--checkpoint_every_n_steps", type=int, default=500)
    p.add_argument("--num_devices", type=int, default=1)
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="chain this many steps in one call, with no host round trip "
                        "between them; checkpoint and validation cadences round up to "
                        "chunk ends")
    p.add_argument("--upload_quant", type=str, default="none", choices=["none", "int16"],
                   help="upload the batches as fixed-point int16 with one scale a batch "
                        "(half the bytes; error at most max|x| / 65534)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat_towers", action="store_true",
                   help="recompute the towers' per-point segments in the backward instead "
                        "of saving their activations (bit-equal)")
    p.add_argument("--residual_dtype", type=str, default="none", choices=["none", "bfloat16"],
                   help="round the towers' ConvBN outputs to bf16 in training and save "
                        "only those for the backward (not bit-equal)")
    p.add_argument("--fused_towers", action="store_true",
                   help="the towers' pre-pool segments through the fused training "
                        "kernels (ops/fused_train.py), f32 only (bf16 trains through autograd)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:i] (the default; raises without a CUDA device) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from feat3dnet_tpu_torch.parallel import multihost

    if multihost.under_torchrun():
        dev = torch.device(args.device)
        multihost.initialize(backend="nccl" if dev.type == "cuda" else "gloo")
        try:
            if dev.type == "cuda":
                dev = torch.device("cuda", multihost.local_rank())
                torch.cuda.set_device(dev)
            return _train(args, multihost.world(), dev)[0]
        finally:
            torch.distributed.destroy_process_group()
    if args.num_devices > 1:
        from feat3dnet_tpu_torch.parallel import run_ranks

        cuda = torch.device(args.device).type == "cuda"
        if cuda:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if args.num_devices > found:
                raise RuntimeError(f"--num_devices {args.num_devices}: {found} CUDA devices "
                                   "found (pass --device cpu for CPU ranks)")
        return run_ranks(_rank_main, args.num_devices, "nccl" if cuda else "gloo",
                         [f"cuda:{i}" for i in range(args.num_devices)] if cuda else None,
                         args=(sys.argv[1:] if argv is None else list(argv),), timeout=None,
                         collective_timeout=3600.0)
    return _train(args, None, None)[0]


def _rank_main(rank, world, group, device, argv):
    """One spawned rank of `--num_devices N`."""
    state, metrics = _train(build_parser().parse_args(argv), group, device)
    return {"rank": rank, "step": state.step,
            "loss": None if metrics is None else metrics["loss"].item()}


def _train(args, group, device):
    """The training run of one process, the whole run without a group or
    one rank's share with one -> (state, the last step's metrics)."""
    import torch
    import torch.distributed as dist

    from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
    from feat3dnet_tpu_torch.data.augment import resolve_augmentations
    from feat3dnet_tpu_torch.data.datagenerator import prefetch
    from feat3dnet_tpu_torch.eval.validate import ClusterPairValidator
    from feat3dnet_tpu_torch.models import get_network
    from feat3dnet_tpu_torch.parallel.data_parallel import (make_chained_dp_train_step,
                                                            make_fused_dp_train_step)
    from feat3dnet_tpu_torch.parallel.multihost import shard_dataset
    from feat3dnet_tpu_torch.train.trainer import (init_state, make_chained_train_step,
                                                   make_fused_train_step, stack_chunk,
                                                   stack_triplet)
    from feat3dnet_tpu_torch.utils.checkpoint import CheckpointManager
    from feat3dnet_tpu_torch.utils.convert import (adam_state_from_optax, load_train_state_npz,
                                                   load_variables, load_variables_npz,
                                                   variables_from_module, zero_adam_moments)
    from feat3dnet_tpu_torch.utils.device import resolve_device
    from feat3dnet_tpu_torch.utils.init import init_variables
    from feat3dnet_tpu_torch.utils.logging import setup_logging
    from feat3dnet_tpu_torch.utils.metrics_writer import MetricsWriter

    device = resolve_device(args.device if device is None else device)
    rank, world = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))
    lead = rank == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if lead:
        setup_logging(os.path.join(args.log_dir, "log.txt"))
    logger = logging.getLogger("feat3dnet_tpu_torch.train")
    logger.info("Arguments: %s", vars(args))
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not split over {world} ranks")
    if world > 1:
        logger.info("Data parallel: %d ranks, %d triplets a rank", world,
                    args.batch_size // world)

    mcfg = ModelConfig(
        num_clusters=args.num_clusters, base_scale=args.base_scale,
        num_samples=args.num_samples, feature_dim=args.feature_dim,
        attention=not args.noattention, regress_orientation=not args.noregress,
        margin=args.margin, remat_towers=args.remat_towers,
        residual_dtype=torch.bfloat16 if args.residual_dtype == "bfloat16" else None,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
        fused_towers=args.fused_towers)
    tcfg = TrainConfig(
        batch_size=args.batch_size, num_points=args.num_points,
        learning_rate=args.learning_rate, num_epochs=args.num_epochs,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, augmentations=tuple(args.augmentation),
        freeze_scopes=tuple(args.freeze_scopes) if args.freeze_scopes else None,
        checkpoint_every_n_steps=args.checkpoint_every_n_steps,
        summary_every_n_steps=args.summary_every_n_steps, seed=args.seed)

    dataset = shard_dataset(os.path.join(args.data_dir, "train", "train.txt"),
                            num_cols=args.data_dim, seed=args.seed, group=group)
    logger.info("Loaded train metadata: %d instances", dataset.size)
    logger.info("Triplet reader: %s", "native" if dataset.use_native else "numpy")
    # every rank takes as many steps an epoch (the smallest slice's)
    local_batch = tcfg.batch_size // world
    epoch_steps = (dataset.size // world) // local_batch
    decay_steps = tcfg.decay_steps
    if tcfg.lr_schedule == "cosine" and decay_steps <= 0:
        decay_steps = max(1, (dataset.size // tcfg.batch_size) * tcfg.num_epochs)
        logger.info("cosine lr: auto decay_steps=%d", decay_steps)

    model = get_network(args.model)(mcfg, bn_group=group)
    excluded = tuple(args.restore_exclude or ())
    variables = adam = None
    if args.variables:
        variables = load_variables_npz(args.variables)
        adam, npz_step = load_train_state_npz(args.variables)
        if excluded:
            # the excluded scopes keep the seeded init
            fresh = init_variables(mcfg, seed=args.seed)
            for col in variables:
                for scope in excluded:
                    if scope in fresh.get(col, {}):
                        variables[col][scope] = fresh[col][scope]
    state = init_state(model, tcfg, mcfg, args.seed, variables, device, decay_steps)
    if adam is not None:
        state.count = adam_state_from_optax(adam, state.model, state.optimizer)
        zero_adam_moments(state.model, state.optimizer, state.count, excluded)
        state.step = npz_step
        logger.info("Restored the Adam state of %s at step %d (count %d)", args.variables,
                    state.step, state.count)

    # every rank restores; rank 0 alone writes
    ckpt = CheckpointManager(os.path.join(args.log_dir, "ckpt"))
    if args.auto_resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        logger.info("Auto-resumed from step %d", state.step)
    elif args.tf1_checkpoint:
        from feat3dnet_tpu_torch.utils.tf1_loader import (load_tf1_arrays,
                                                          restore_tf1_variables)
        new_vars, restored, skipped = restore_tf1_variables(
            variables_from_module(state.model), load_tf1_arrays(args.tf1_checkpoint),
            restore_exclude=excluded, ignore_missing=True)
        load_variables(state.model, new_vars)
        logger.info("TF1 restore: %d restored, %d skipped", len(restored), len(skipped))
    elif args.checkpoint:
        sub = os.path.join(args.checkpoint, "ckpt")
        src = CheckpointManager(sub if os.path.isdir(sub) else args.checkpoint)
        state = src.restore(state, restore_exclude=excluded)
        logger.info("Restored checkpoint at step %d", state.step)

    validator = None
    val_folder = os.path.join(args.data_dir, "clusters")
    if lead and args.validate_every_n_steps > 0 and os.path.exists(
            os.path.join(val_folder, "filenames.txt")):
        validator = ClusterPairValidator(state.model, mcfg, val_folder, args.data_dim,
                                         device=device)

    aug_names = tuple(resolve_augmentations(tcfg.augmentations, tcfg.upright_axis))
    spd = max(1, args.steps_per_dispatch)
    quant = args.upload_quant == "int16"
    if group is None:
        step_fn = (make_chained_train_step if spd > 1 else make_fused_train_step)(
            model, mcfg.margin, mcfg.attention, augmentations=aug_names or None,
            aug_seed=args.seed + 1)
    else:
        step_fn = (make_chained_dp_train_step if spd > 1 else make_fused_dp_train_step)(
            model, mcfg.margin, mcfg.attention, group, augmentations=aug_names or None,
            aug_seed=args.seed + 1, quantized=quant)

    writer = MetricsWriter(os.path.join(args.log_dir, "metrics.jsonl"),
                           tensorboard=args.tensorboard) if lead else None

    def run_hooks(prev, metrics, stacked):
        """Summary rows for the steps (prev, state.step] on the cadence (one
        read of the metrics to the host), then a checkpoint or validation
        whose cadence falls in that span."""
        hits = [s for s in range(prev + 1, state.step + 1)
                if s % args.summary_every_n_steps == 0]
        if lead and hits:
            host = to_host(metrics)
            for s in hits:
                row = pick(host, s - prev - 1) if stacked else host
                writer.write(step=s, **row)
                logger.info("Step %d, Loss: %.5f", s, row["loss"].item())
        if lead and (state.step // args.checkpoint_every_n_steps
                     > prev // args.checkpoint_every_n_steps):
            ckpt.save(state)
        if validator is not None and (
                state.step // args.validate_every_n_steps
                > prev // args.validate_every_n_steps or prev == 0):
            fpr = validator()
            writer.write(step=state.step, fp_rate=fpr)
            logger.info("Step %d. FP Rate: %f", state.step, fpr)

    metrics = None
    try:
        for epoch in range(args.num_epochs):
            logger.info("Starting epoch %d", epoch)
            batches = itertools.islice(
                dataset.epoch_triplets(epoch, local_batch, tcfg.num_points, tcfg.crop_radius),
                epoch_steps)
            if spd == 1:
                inputs = prefetch(batches, transform=lambda b: stack_triplet(b, device, quant))
            else:
                inputs = prefetch(chunked(batches, spd),
                                  transform=lambda c: stack_chunk(c, device, quant))
            for clouds in inputs:
                prev = state.step
                state, metrics = step_fn(state, clouds)
                run_hooks(prev, metrics, spd > 1)
        if lead:
            ckpt.save(state)
    finally:
        if writer is not None:
            writer.close()
    if spd > 1 and metrics is not None:
        metrics = pick(metrics, -1)
    return state, metrics


def chunked(it, k):
    """Lists of k items of `it`; the tail a shorter list."""
    while True:
        chunk = list(itertools.islice(it, k))
        if not chunk:
            return
        yield chunk


def to_host(tree):
    """A tree of device tensors on the host: every copy queued, then one wait."""
    import torch

    def copy(t):
        return ({k: copy(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to("cpu", non_blocking=True))

    out = copy(tree)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def pick(tree, j):
    """Entry j of every leaf's leading axis."""
    return {k: pick(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}


if __name__ == "__main__":
    main()
