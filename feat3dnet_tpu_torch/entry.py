"""Entry points of the port: the counterparts of `__graft_entry__.entry()`
and `__graft_entry__.dryrun_multichip()`."""
from __future__ import annotations

import torch

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.utils.convert import load_variables
from feat3dnet_tpu_torch.utils.device import resolve_device
from feat3dnet_tpu_torch.utils.init import init_variables


def entry(device=None):
    """(fn, example_args): the eval forward of the paper config (FPS 512
    clusters, radius-2 m 64-sample neighbourhoods, detector attention and
    orientation, 32-D descriptors) on a zero (2, 4 096, 3) batch, with
    seeded weights, on `device` (`cuda` unless named; raises without one).
    `fn(model, cloud)` returns (keypoints, features, attention)."""
    dev = resolve_device(device)
    cfg = ModelConfig()
    model = load_variables(Feat3DNet(cfg), init_variables(cfg, seed=0)).eval().to(dev)
    cloud = torch.zeros((2, 4096, 3), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fn(model, cloud):
        out = model(cloud)
        return out.keypoints, out.features, out.attention

    return fn, (model, cloud)


# tests/test_parallel.py's tiny configuration
_DRYRUN_CFG = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
                   detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8),
                   fused_towers=True, fused_cot_dtype=torch.float32)
_DRYRUN_POINTS = 64


def _dryrun_batch(n_devices: int):
    import numpy as np

    rng = np.random.RandomState(0)
    a = rng.randn(2 * n_devices, _DRYRUN_POINTS, 3).astype(np.float32)
    return np.concatenate([a, a + 0.01 * rng.randn(*a.shape).astype(np.float32),
                           a + 0.2 * rng.randn(*a.shape).astype(np.float32)])


def _dryrun_step(rank, world, group, device, stacked):
    """One fused step (K7-K10's plain versions on the CPU) from the seeded
    weights -> (loss, {name: grad}), with a group this rank's share (a
    run_ranks body; the device is the CPU's)."""
    from feat3dnet_tpu_torch.config import TrainConfig
    from feat3dnet_tpu_torch.parallel.data_parallel import shard_batch
    from feat3dnet_tpu_torch.train.trainer import init_state, make_fused_train_step

    cfg = ModelConfig(**_DRYRUN_CFG)
    model = Feat3DNet(cfg, bn_group=group)
    state = init_state(model, TrainConfig(num_points=_DRYRUN_POINTS), cfg,
                       variables=init_variables(cfg, seed=0), device="cpu")
    clouds = torch.from_numpy(stacked)
    if group is not None:
        clouds = shard_batch(clouds, rank, world)
    step = make_fused_train_step(model, cfg.margin, cfg.attention,
                                 augmentations=("RotateSmall", "Jitter"), aug_seed=1, group=group)
    _, metrics = step(state, clouds)
    return metrics["loss"].item(), {k: p.grad.clone() for k, p in model.named_parameters()}


def dryrun_multichip(n_devices: int) -> None:
    """One fused data-parallel training step over n_devices gloo CPU ranks
    on tiny shapes (batch 2 x n_devices, 64 points), checked against one
    process on the combined batch: the loss within 1e-5 relative and every
    gradient leaf within 1e-4 of its largest |value| (1e-3 absolute for the
    analytically zero ones). The counterpart of
    `__graft_entry__.dryrun_multichip`; raises on a mismatch."""
    from feat3dnet_tpu_torch.parallel.data_parallel import run_ranks

    stacked = _dryrun_batch(n_devices)
    ranks = run_ranks(_dryrun_step, n_devices, "gloo", args=(stacked,), timeout=600,
                      threads=1)
    loss, grads = _dryrun_step(0, 1, None, None, stacked)
    top = max(g.abs().max().item() for g in grads.values())
    for r, (r_loss, r_grads) in enumerate(ranks):
        if abs(r_loss - loss) > 1e-5 * abs(loss):
            raise AssertionError(f"dryrun_multichip: rank {r} loss {r_loss} != {loss}")
        for k, g in grads.items():
            err = (r_grads[k] - g).abs().max().item()
            scale = g.abs().max().item()
            if err > (1e-3 if scale <= 1e-4 * top else 1e-4 * scale):
                raise AssertionError(f"dryrun_multichip: rank {r} grad {k} off by {err}")
