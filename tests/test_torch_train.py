"""Port of train/ (loss, Adam, steps, Trainer), utils/checkpoint and cli/train
against the JAX package, on the CPU.

Train steps start from the JAX init through the weight bridge and see the
same batch. The JAX step and grads run eagerly: at these sizes XLA's jit on
the CPU gives the JAX package's own grads up to 30 % away from its eager
grads on some leaves (the forward agrees to 1e-5), and the port agrees with
the eager ones. Tolerances: loss rtol 1e-5 (1e-4 after the first update),
sum_positive / sum_negative atol 1e-6 (squared distances of unit
descriptors from the |a|^2 + |b|^2 - 2ab expansion carry an absolute
rounding of a few 1e-7);
grads per leaf rtol 5e-3 with atol 5e-4 max|ref|, and the leaves whose grad
is analytically zero (the conv biases under BN and the descriptor's last
mid-conv beta: rounding noise on both sides) atol 1e-3; batch_stats after
the first step rtol 1e-4 / atol 1e-6. After Adam, whose first update is
about lr * sign(g), a noise grad's sign can differ between the frameworks:
those leaves are held to atol 2 lr per step + 1e-7, every other leaf to
>= 99.9 % of its elements within 1e-2 lr.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.config import TrainConfig as JaxTrainConfig
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu.train import trainer as jtr
from feat3dnet_tpu.train.loss import alignment_triplet_loss as jax_loss
from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.train import (Trainer, alignment_triplet_loss, init_state,
                                       make_fused_train_step, make_train_step)
from feat3dnet_tpu_torch.train.trainer import cosine_schedule
from feat3dnet_tpu_torch.utils import variables_from_module
from feat3dnet_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

CFG = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
           detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8))
LR = 1e-3


def _batch(rng, b=2, n=64):
    a = rng.randn(b, n, 3).astype(np.float32)
    return a, a + 0.01 * rng.randn(b, n, 3).astype(np.float32), \
        a + 0.2 * rng.randn(b, n, 3).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_grads(model):
    out = {}
    for name, p in model.named_parameters():
        *scope, leaf = name.split(".")
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        out["/".join(scope + ["kernel" if leaf == "weight" else leaf])] = \
            g.T if leaf == "weight" else g
    return out


CASES = {
    "default": (dict(), dict(), 3),
    "fused": (dict(fused_towers=True, fused_cot_dtype="float32"), dict(), 1),
    "fused_bf16": (dict(fused_towers=True, fused_cot_dtype="bfloat16"), dict(), 3),
    "stage1": (dict(attention=False, regress_orientation=False), dict(), 1),
    "freeze": (dict(), dict(freeze_scopes=("detection",)), 1),
    "cosine": (dict(), dict(lr_schedule="cosine", warmup_steps=2, decay_steps=6), 3),
}


# the fused towers' leaves: the detector's and descriptor's pre-pool convs
TOWER_LEAF = re.compile(r"(detection|description)/conv(\d+|_mid_\d+)/")


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(rng, case):
    """Each case's steps against the JAX package's. `fused` streams f32
    cotangents through the fused towers; `fused_bf16` takes both packages'
    default, bf16, for 3 steps. There a value that lands on the other side
    of a bf16 rounding boundary moves by one bf16 step and carries it into
    the layers below (tests/test_torch_fused_train.py), so each tower
    leaf's first-step gradient is held to a relative L2 error of 2^-8
    instead of elementwise; the noise leaves, the other leaves, the losses,
    sums and batch statistics keep the limits above."""
    mkw, tkw, steps = CASES[case]
    cot = mkw.get("fused_cot_dtype")
    jcfg = JaxModelConfig(**CFG, **dict(mkw, fused_cot_dtype=getattr(jnp, cot)) if cot else mkw)
    cfg = ModelConfig(**CFG, **dict(mkw, fused_cot_dtype=getattr(torch, cot)) if cot else mkw)
    jmodel = JaxFeat3DNet(jcfg)
    tx = jtr.make_optimizer(LR, tkw.get("freeze_scopes"), tkw.get("lr_schedule", "constant"),
                            tkw.get("warmup_steps", 0), tkw.get("decay_steps", 0))
    jstate, _ = jtr.init_state(jmodel, JaxTrainConfig(num_points=64), jcfg,
                               jax.random.PRNGKey(0), tx=tx)
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    model = Feat3DNet(cfg)
    state = init_state(model, TrainConfig(num_points=64, learning_rate=LR, **tkw), cfg,
                       variables=variables, device="cpu")
    a, p, n = _batch(rng)
    clouds = jnp.concatenate([a, p, n], axis=0)

    def loss_fn(params, batch_stats):
        out, _ = jmodel.apply({"params": params, "batch_stats": batch_stats}, clouds,
                              training=True, mutable=["batch_stats"])
        fa, fp, fn = jnp.split(out.features, 3, axis=0)
        att = jnp.split(out.attention, 3, axis=0)[0] if jcfg.attention else None
        return jax_loss(fa, fp, fn, att, 1.0)[0]

    want_grads = _flat(jax.grad(loss_fn)(jstate.params, jstate.batch_stats))
    # leaves whose grad is analytically zero (a shift that the next BN removes:
    # the conv biases, the descriptor's last mid-conv beta) carry rounding noise
    top = max(np.abs(g).max() for g in want_grads.values())
    noise = {k for k, g in want_grads.items() if np.abs(g).max() <= 1e-4 * top}
    assert {k for k in want_grads if k.endswith("conv2d/bias")} <= noise
    jstep = jtr.make_train_step(jmodel, tx, 1.0, jcfg.attention)
    step = make_train_step(model, 1.0, cfg.attention)
    for k in range(steps):
        jstate, jm = jstep(jstate, *map(jnp.asarray, (a, p, n)))
        state, m = step(state, *map(torch.from_numpy, (a, p, n)))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5 if k == 0 else 1e-4)
        for key in ("sum_positive", "sum_negative"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=0, atol=1e-6,
                                       err_msg=key)
        if k > 0:
            continue
        got = _port_grads(model)
        assert got.keys() == want_grads.keys()
        for path, g in got.items():
            w = want_grads[path]
            if path in noise:
                np.testing.assert_allclose(g, w, atol=1e-3, err_msg=path)
            elif cot == "bfloat16" and TOWER_LEAF.match(path):
                err = np.linalg.norm(g - w) / np.linalg.norm(w)
                assert err <= 2.0 ** -8, (path, err)
            else:
                np.testing.assert_allclose(g, w, rtol=5e-3,
                                           atol=5e-4 * max(np.abs(w).max(), 1e-3), err_msg=path)
        # batch_stats of the first forward (later ones see the noise leaves'
        # sign-driven drift through the batch means)
        mine = _flat(variables_from_module(model)["batch_stats"])
        for path, w in _flat(jax.tree.map(np.asarray, jstate.batch_stats)).items():
            np.testing.assert_allclose(mine[path], w, rtol=1e-4, atol=1e-6, err_msg=path)
    assert state.step == int(jstate.step) == steps
    mine = _flat(variables_from_module(model)["params"])
    for path, w in _flat(jax.tree.map(np.asarray, jstate.params)).items():
        if path in noise:
            np.testing.assert_allclose(mine[path], w, rtol=0, atol=2 * LR * steps + 1e-7,
                                       err_msg=path)
        else:
            assert np.mean(np.abs(mine[path] - w) <= 1e-2 * LR) >= 0.999, path
    if "freeze_scopes" in tkw:
        for path, w in _flat(variables["params"]["detection"]).items():
            np.testing.assert_array_equal(mine["detection/" + path], w)


@pytest.mark.parametrize("attention", [True, False])
def test_loss_matches_jax(rng, attention):
    f = [rng.randn(2, 12, 16).astype(np.float32) for _ in range(3)]
    f = [x / np.linalg.norm(x, axis=-1, keepdims=True) for x in f]
    f[1][:, :4] = f[0][:, :4]                           # exact zero distances (ties)
    att = np.abs(rng.randn(2, 12)).astype(np.float32) + 0.1 if attention else None

    def jl(fa, fp, fn, at):
        loss, aux = jax_loss(fa, fp, fn, at, 0.5)
        return loss, aux

    args = [jnp.asarray(x) for x in f] + [None if att is None else jnp.asarray(att)]
    argnums = (0, 1, 2, 3) if attention else (0, 1, 2)
    (jloss, jaux), jg = jax.value_and_grad(jl, argnums=argnums, has_aux=True)(*args)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in f]
    ta = None if att is None else torch.from_numpy(att).requires_grad_(True)
    loss, aux = alignment_triplet_loss(*ts, ta, 0.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("sum_positive", "sum_negative"):
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]), rtol=1e-5)
    for t, g in zip(ts + ([ta] if attention else []), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("warmup,end_ratio", [(0, 0.0), (4, 0.0), (3, 0.1)])
def test_cosine_schedule_matches_optax(warmup, end_ratio):
    """The lr of every update (optax counts from 0: with warmup the first
    update has lr 0); optax computes it in f32, hence rtol 1e-5."""
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup > 0 else 1e-3, peak_value=1e-3, warmup_steps=warmup,
        decay_steps=16, end_value=1e-3 * end_ratio)
    got = cosine_schedule(1e-3, warmup, 16, end_ratio)
    for k in range(22):
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-5, atol=1e-12, err_msg=k)
    assert (got(0) == 0.0) == (warmup > 0)


def _fresh(seed=0, **tkw):
    cfg = ModelConfig(**CFG)
    model = Feat3DNet(cfg)
    return cfg, model, init_state(model, TrainConfig(learning_rate=LR, **tkw), cfg, seed=seed,
                                  device="cpu")


def test_fused_step_matches_plain_step_and_augments(rng):
    a, p, n = map(torch.from_numpy, _batch(rng))
    cfg, m1, s1 = _fresh()
    _, m2, s2 = _fresh()
    step = make_train_step(m1, 1.0, True)
    fused = make_fused_train_step(m2, 1.0, True)
    for _ in range(2):
        _, l1 = step(s1, a, p, n)
        _, l2 = fused(s2, torch.cat([a, p, n]))
        assert l1["loss"].item() == l2["loss"].item()
    for x, y in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(x, y)
    losses = []
    for _ in range(2):
        _, m3, s3 = _fresh()
        aug = make_fused_train_step(m3, 1.0, True, augmentations=("RotateSmall", "Jitter"),
                                    aug_seed=7)
        losses.append(aug(s3, torch.cat([a, p, n]))[1]["loss"].item())
    assert losses[0] == losses[1] != l2["loss"].item() or losses[0] != \
        fused(_fresh()[2], torch.cat([a, p, n]))[1]["loss"].item()


def test_trainer_fit(rng):
    cfg = ModelConfig(**CFG)
    trainer = Trainer(Feat3DNet(cfg), cfg, TrainConfig(learning_rate=LR),
                      augmentations=("Jitter",), device="cpu")
    state = trainer.init(seed=1)
    seen = []
    state, metrics = trainer.fit(state, iter([_batch(rng) for _ in range(3)]), num_steps=5,
                                 hooks={2: lambda s, m: seen.append(s.step)})
    assert state.step == 3 and seen == [2] and np.isfinite(metrics["loss"].item())


def test_checkpoint_roundtrip_retention_and_exclude(rng, tmp_path):
    a, p, n = map(torch.from_numpy, _batch(rng))
    cfg, model, state = _fresh()
    step = make_train_step(model, 1.0, True)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for _ in range(3):
        step(state, a, p, n)
        mgr.save(state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3

    _, fresh_model, fresh = _fresh(seed=5)
    init_vars = variables_from_module(fresh_model)
    init_vars = jax.tree.map(lambda t: t.clone(), init_vars)
    restored = mgr.restore(fresh)
    assert (restored.step, restored.count) == (3, 3)
    for (k, x), (_, y) in zip(model.state_dict().items(), fresh_model.state_dict().items()):
        assert torch.equal(x, y), k
    opt_a, opt_b = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i, s in opt_a["state"].items():
        assert torch.equal(s["exp_avg"], opt_b["state"][i]["exp_avg"])

    _, ex_model, ex = _fresh(seed=5)
    ex = mgr.restore(ex, step=2, restore_exclude=["detection"])
    sd, ref = ex_model.state_dict(), model.state_dict()
    got = variables_from_module(ex_model)
    for col in ("params", "batch_stats"):
        for path, v in _flat(jax.tree.map(lambda t: t.numpy(), got[col]["detection"])).items():
            np.testing.assert_array_equal(
                v, _flat(jax.tree.map(lambda t: t.numpy(), init_vars[col]["detection"]))[path])
    # optax's rule: the excluded scope's moments restart from zero at the
    # restored (global) count; the others come from the checkpoint
    names = [nm for nm, _ in ex_model.named_parameters()]
    opt = ex.optimizer.state_dict()["state"]
    assert sorted(opt) == list(range(len(names))) and ex.count == 2
    for i, st in opt.items():
        assert st["step"].item() == 2.0, names[i]
        if names[i].startswith("detection"):
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any(), names[i]
        else:
            assert st["exp_avg_sq"].any(), names[i]
    assert not torch.equal(sd["description.conv0.conv2d.weight"],
                           fresh_model.state_dict()["description.conv0.conv2d.weight"])
    assert ref is not None


def _write_dataset(root, rs, n=4):
    os.makedirs(root / "train")
    lines = []
    for i in range(n):
        (rs.randn(200, 6) * 3.0).astype(np.float32).tofile(str(root / "train" / f"c{i}.bin"))
        others = [j for j in range(n) if j != i]
        lines.append(f"c{i}.bin | {others[0]} | {others[1]}")
    (root / "train" / "train.txt").write_text("\n".join(lines) + "\n")


def test_cli_train_and_resume(tmp_path):
    from feat3dnet_tpu_torch.cli import train

    _write_dataset(tmp_path / "data", np.random.RandomState(3))
    args = ["--data_dir", str(tmp_path / "data"), "--log_dir", str(tmp_path / "log"),
            "--num_points", "64", "--num_clusters", "8", "--num_samples", "8",
            "--batch_size", "2", "--num_epochs", "1", "--summary_every_n_steps", "1",
            "--checkpoint_every_n_steps", "1", "--device", "cpu", "--fused_towers"]
    state = train.main(args)
    assert state.step == 2
    state = train.main(args + ["--auto_resume"])
    assert state.step == 4
    rows = [json.loads(x) for x in open(tmp_path / "log" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and "sum_positive" in r for r in rows)
    assert CheckpointManager(str(tmp_path / "log" / "ckpt")).latest_step() == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(args[:-3])


def test_entry_points_default_to_cuda():
    """Without a device argument every entry point asks for `cuda`, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    from feat3dnet_tpu_torch.config import InferenceConfig
    from feat3dnet_tpu_torch.inference import ClusterDescriptorServer, InferencePipeline

    cfg = ModelConfig(**CFG)
    for make in (lambda: InferencePipeline(Feat3DNet(cfg), None, cfg, InferenceConfig()),
                 lambda: ClusterDescriptorServer(Feat3DNet(cfg)),
                 lambda: Trainer(Feat3DNet(cfg), cfg, TrainConfig()),
                 lambda: init_state(Feat3DNet(cfg), TrainConfig(), cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
