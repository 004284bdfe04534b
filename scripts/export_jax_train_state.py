"""Export a training run of feat3dnet_tpu.cli.train (an Orbax checkpoint
directory) as the train-state npz that the PyTorch port reads:
{params, batch_stats} under their flax paths, optax's Adam moments as
`opt_state/mu/<param path>` and `opt_state/nu/<param path>`, its global
count as `opt_state/count`, and the train step as `step`
(feat3dnet_tpu_torch/utils/convert.py: save_train_state_npz). The port's
`cli.train --variables <npz>` then restores weights, moments and count.

    python scripts/export_jax_train_state.py \\
        --checkpoint examples/results/scaled_accuracy/ckpt \\
        --num_clusters 256 --out feat3dnet_tpu_torch/assets/ckpt4480_train_state.npz

With --init_seed S it writes instead the weights that `feat3dnet_tpu.cli.
train --seed S` starts from (init_state at PRNGKey(S), before any step) as
a variables npz, e.g. for the port's recipe from JAX's initial weights
(`feat3dnet_tpu_torch.examples.scaled_accuracy_run --init_variables`):

    python scripts/export_jax_train_state.py --init_seed 0 --num_clusters 256 \
        --out build/jax_init_seed0.npz

The model widths and the optimiser's layout must be the run's
(--feature_dim, --no_bn, --lr_schedule, --freeze_scopes): the restore
takes its structure from a fresh init_state. Layouts: 'constant' (adam,
empty), 'cosine' (adam, schedule count, which must equal adam's count),
and under --freeze_scopes optax.multi_transform, whose 'train' branch
holds the moments of the trained parameters only. Runs on the CPU; needs
JAX, flax, optax and orbax.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

import numpy as np  # noqa: E402


def restore_train_state(checkpoint, step=None, num_clusters=512, num_samples=64,
                        feature_dim=32, use_bn=True, lr_schedule="constant",
                        freeze_scopes=None):
    """The JAX TrainState of `checkpoint` (a cli.train log_dir, its ckpt/, or
    an Orbax directory) at `step` (None: the latest)."""
    from feat3dnet_tpu.config import ModelConfig, TrainConfig
    from feat3dnet_tpu.models import Feat3DNet
    from feat3dnet_tpu.train.trainer import init_state, make_optimizer
    from feat3dnet_tpu.utils.checkpoint import CheckpointManager

    cfg = ModelConfig(num_clusters=num_clusters, num_samples=num_samples,
                      feature_dim=feature_dim, use_bn=use_bn)
    # the schedule's horizon does not change the state's structure
    tx = make_optimizer(1e-5, freeze_scopes, lr_schedule,
                        decay_steps=1 if lr_schedule == "cosine" else 0)
    state, _ = init_state(Feat3DNet(cfg), TrainConfig(num_points=512), cfg,
                          jax.random.PRNGKey(0), tx=tx)
    sub = os.path.join(checkpoint, "ckpt")
    return CheckpointManager(sub if os.path.isdir(sub) else checkpoint).restore(state, step)


def _numpy_tree(tree):
    """A params-shaped tree as nested dicts of numpy arrays, optax's masked
    leaves (frozen parameters) left out."""
    import optax

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _numpy_tree(v)
            if sub:
                out[k] = sub
        elif not isinstance(v, optax.MaskedNode):
            out[k] = np.asarray(v, np.float32)
    return out


def init_variables_arrays(seed, num_clusters=512, num_samples=64, feature_dim=32,
                          use_bn=True, num_points=4096):
    """{params, batch_stats} of the JAX CLI's fresh init_state at
    PRNGKey(seed) (its dummy batch: 3 clouds of num_points)."""
    from feat3dnet_tpu.config import ModelConfig, TrainConfig
    from feat3dnet_tpu.models import Feat3DNet
    from feat3dnet_tpu.train.trainer import init_state

    cfg = ModelConfig(num_clusters=num_clusters, num_samples=num_samples,
                      feature_dim=feature_dim, use_bn=use_bn)
    state, _ = init_state(Feat3DNet(cfg), TrainConfig(num_points=num_points), cfg,
                          jax.random.PRNGKey(seed))
    return {"params": _numpy_tree(state.params), "batch_stats": _numpy_tree(state.batch_stats)}


def train_state_arrays(state):
    """(variables, adam {"mu", "nu", "count"}, step) of a JAX TrainState in
    any of make_optimizer's layouts."""
    import optax

    opt = state.opt_state
    if isinstance(opt, optax.MultiTransformState):      # freeze_scopes
        opt = opt.inner_states["train"].inner_state
    adam, sched = opt
    if not isinstance(adam, optax.ScaleByAdamState):
        raise ValueError(f"not an Adam state: {type(adam).__name__}")
    count = int(adam.count)
    if isinstance(sched, optax.ScaleByScheduleState) and int(sched.count) != count:
        raise ValueError(f"schedule count {int(sched.count)} != Adam count {count}")
    variables = {"params": _numpy_tree(state.params),
                 "batch_stats": _numpy_tree(state.batch_stats)}
    return (variables, {"mu": _numpy_tree(adam.mu), "nu": _numpy_tree(adam.nu),
                        "count": count}, int(state.step))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=os.path.join(
        ROOT, "examples", "results", "scaled_accuracy", "ckpt"))
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", default=os.path.join(
        ROOT, "feat3dnet_tpu_torch", "assets", "ckpt4480_train_state.npz"))
    p.add_argument("--num_clusters", type=int, default=256)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--feature_dim", type=int, default=32, choices=[16, 32, 64, 128])
    p.add_argument("--no_bn", action="store_true")
    p.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--freeze_scopes", nargs="+", default=None)
    p.add_argument("--init_seed", type=int, default=None,
                   help="write the CLI's initial weights at this seed (no checkpoint)")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")

    from feat3dnet_tpu_torch.utils.convert import save_train_state_npz, save_variables_npz

    if args.init_seed is not None:
        save_variables_npz(args.out, init_variables_arrays(
            args.init_seed, args.num_clusters, args.num_samples, args.feature_dim,
            not args.no_bn))
        print(f"{args.out}: the initial weights at seed {args.init_seed}, "
              f"{os.path.getsize(args.out)} bytes")
        return

    state = restore_train_state(args.checkpoint, args.step, args.num_clusters,
                                args.num_samples, args.feature_dim, not args.no_bn,
                                args.lr_schedule, args.freeze_scopes)
    variables, adam, step = train_state_arrays(state)
    save_train_state_npz(args.out, variables, adam, step)
    print(f"{args.out}: step {step}, count {adam['count']}, "
          f"{os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
