"""The optax <-> torch Adam bridge (utils/convert.py), the train-state npz,
and the port's restore under `restore_exclude`, against optax on the CPU.

JAX states come from a few optax updates on seeded numpy grads (no forward
needed) in each layout of feat3dnet_tpu.train.trainer.make_optimizer:
constant, cosine and freeze_scopes (optax.multi_transform, whose masked
'train' branch holds the trained parameters' moments only). Each reaches
the port through scripts/export_jax_train_state.py's `train_state_arrays`.
Tolerances: moments bit-equal after the transpose; one update from the
same grads within 1e-5 relative per element, or 1e-5 of the step size lr
where that is larger (the update is read as the parameter's value after a
step from zero, so the parameters' own rounding does not enter; lr 1e-2).
The absolute part covers elements whose first moment nearly cancels in
0.9 m + 0.1 g: the float32 rounding of that sum, ~1e-8 lr, is large
against such a tiny update (measured up to 1.2e-10 = 1.2e-8 lr, 2.7e-4
relative). The reference update is optax's own `tx.update` on the same
state, evaluated under jax.enable_x64 on the float32 values cast to
float64: in float32, optax's bias correction 1 - b2**count cancels and
carries ~1e-5 relative error at small counts by itself (its float32
update misses the float64 one by up to 1.004e-5 relative here), while
torch's Adam takes its bias corrections in Python floats.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import optax

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.config import TrainConfig as JaxTrainConfig
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu.train import trainer as jtr
from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.train import init_state
from feat3dnet_tpu_torch.utils.checkpoint import CheckpointManager
from feat3dnet_tpu_torch.utils.convert import (adam_state_from_optax, adam_state_to_optax,
                                               load_train_state_npz, load_variables_npz,
                                               save_train_state_npz, variables_from_module)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
           detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8))
LR = 1e-2
LAYOUTS = {"constant": dict(),
           "cosine": dict(lr_schedule="cosine", warmup_steps=1, decay_steps=10),
           "freeze": dict(freeze_scopes=("detection",))}


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_jax_train_state", os.path.join(ROOT, "scripts", "export_jax_train_state.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXPORT = _export_module()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif not isinstance(v, optax.MaskedNode):
            out[prefix + k] = np.asarray(v)
    return out


def _grads(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32), params)


def _jax_state(layout, steps=3, seed=0, widths=CFG):
    """(TrainState after `steps` optax updates on seeded grads, tx)."""
    kw = LAYOUTS[layout]
    tx = jtr.make_optimizer(LR, kw.get("freeze_scopes"), kw.get("lr_schedule", "constant"),
                            kw.get("warmup_steps", 0), kw.get("decay_steps", 0))
    cfg = JaxModelConfig(**widths)
    state, _ = jtr.init_state(JaxFeat3DNet(cfg), JaxTrainConfig(num_points=64), cfg,
                              jax.random.PRNGKey(seed), tx=tx)
    params, opt = state.params, state.opt_state
    for k in range(steps):
        updates, opt = tx.update(_grads(params, 100 + k), opt, params)
        params = optax.apply_updates(params, updates)
    return state.replace(step=state.step + steps, params=params, opt_state=opt), tx


def _port_state(variables, layout):
    kw = LAYOUTS[layout]
    cfg = ModelConfig(**CFG)
    model = Feat3DNet(cfg)
    return init_state(model, TrainConfig(learning_rate=LR, **kw), cfg, variables=variables,
                      device="cpu")


def _bridged(layout, steps=3):
    jstate, tx = _jax_state(layout, steps)
    variables, adam, step = EXPORT.train_state_arrays(jstate)
    state = _port_state(variables, layout)
    state.count = adam_state_from_optax(adam, state.model, state.optimizer)
    state.step = step
    return jstate, tx, state, adam


def _port_update(state, grads):
    """One Adam update of the port from `grads` (a flax-layout tree), read
    as the parameters' values after a step from zero."""
    g = _flat(grads)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            *scope, leaf = name.split(".")
            x = g["/".join(scope + ["kernel" if leaf == "weight" else leaf])]
            p.zero_()
            p.grad = torch.from_numpy(np.ascontiguousarray(x.T if leaf == "weight" else x))
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.count)
    state.optimizer.step()
    state.count += 1
    return _flat(jax.tree.map(lambda t: t.numpy(), variables_from_module(state.model)["params"]))


def _optax_update(tx, grads, opt_state, params):
    """optax's update of `params` from `grads`, in float64 (see above)."""
    def f64(tree):
        return jax.tree.map(lambda x: np.asarray(x, np.float64)
                            if np.asarray(x).dtype == np.float32 else x, tree)

    with jax.enable_x64(True):
        updates, _ = tx.update(f64(grads), f64(opt_state), f64(params))
        return _flat(jax.tree.map(lambda x: np.asarray(x, np.float64), updates))


def _assert_updates_match(state, jstate, tx, grads):
    want = _optax_update(tx, grads, jstate.opt_state, jstate.params)
    got = _port_update(state, grads)
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-5 * LR, err_msg=path)


def test_restore_exclude_keeps_the_global_count(tmp_path):
    """Stage 2 of the recipe: a 3-step state restored without 'detection'.
    optax keeps its global count and gives the detector zero moments, so its
    first update is m^/sqrt(v^) at count 3 (0.58 lr), not lr * sign(g)."""
    from feat3dnet_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager

    jstate, tx = _jax_state("constant")
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"))
    jax_mgr.save(jstate)
    fresh, _ = _jax_state("constant", steps=0, seed=5)
    jrest = jax_mgr.restore(fresh, restore_exclude=["detection"])
    assert int(jrest.opt_state[0].count) == 3

    variables, adam, step = EXPORT.train_state_arrays(jstate)
    src = _port_state(variables, "constant")
    src.count = adam_state_from_optax(adam, src.model, src.optimizer)
    src.step = step
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(src)
    init = _port_state(jax.tree.map(np.asarray, {"params": fresh.params,
                                                 "batch_stats": fresh.batch_stats}),
                       "constant")
    rest = mgr.restore(init, restore_exclude=["detection"])
    assert (rest.step, rest.count) == (3, 3)
    _assert_updates_match(rest, jrest, tx, _grads(jrest.params, 7))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bridged_moments_equal_optax(layout):
    jstate, _, state, _ = _bridged(layout)
    inner = jstate.opt_state
    if layout == "freeze":
        inner = inner.inner_states["train"].inner_state
    mu, nu, count = _flat(inner[0].mu), _flat(inner[0].nu), int(inner[0].count)
    assert state.count == count == 3
    names = {id(p): n for n, p in state.model.named_parameters()}
    seen = set()
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            *scope, leaf = names[id(p)].split(".")
            path = "/".join(scope + ["kernel" if leaf == "weight" else leaf])
            seen.add(path)
            st = state.optimizer.state[p]
            assert st["step"].item() == count
            for slot, want in (("exp_avg", mu[path]), ("exp_avg_sq", nu[path])):
                got = st[slot].numpy()
                np.testing.assert_array_equal(got.T if leaf == "weight" else got, want,
                                              err_msg=f"{slot} {path}")
    assert seen == mu.keys() == nu.keys()
    if layout == "freeze":
        assert not any(k.startswith("detection/") for k in seen)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_one_update_from_bridged_state_matches_optax(layout):
    jstate, tx, state, _ = _bridged(layout)
    grads = _grads(jstate.params, 11)
    want = _optax_update(tx, grads, jstate.opt_state, jstate.params)
    got = _port_update(state, grads)
    for path, w in want.items():
        if layout == "freeze" and path.startswith("detection/"):
            assert not w.any() and not got[path].any(), path     # frozen: no update
        else:
            np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-5 * LR, err_msg=path)


@pytest.mark.parametrize("layout", ["constant", "freeze"])
def test_round_trip_torch_optax_torch(layout, tmp_path):
    """A port state after two steps -> optax layout (through the train-state
    npz) -> a fresh optimiser: the same state. The layout has optax's own
    structure, and moments of a parameter the optimiser lacks raise."""
    jstate, _, state, _ = _bridged(layout, steps=0)
    for k in range(2):
        _port_update(state, _grads(jstate.params, 20 + k))
    adam = adam_state_to_optax(state.model, state.optimizer, state.count)
    variables = jax.tree.map(lambda t: t.numpy(), variables_from_module(state.model))
    path = str(tmp_path / "ts.npz")
    save_train_state_npz(path, variables, adam, step=2)
    adam_back, step = load_train_state_npz(path)
    assert step == 2 and adam_back["count"] == 2
    assert load_variables_npz(path).keys() == {"params", "batch_stats"}
    other = _port_state(load_variables_npz(path), layout)
    assert adam_state_from_optax(adam_back, other.model, other.optimizer) == 2
    for p, q in zip(state.optimizer.param_groups[0]["params"],
                    other.optimizer.param_groups[0]["params"]):
        for slot in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][slot], other.optimizer.state[q][slot])
    inner = jstate.opt_state
    if layout == "freeze":
        inner = inner.inner_states["train"].inner_state
    assert _flat(adam["mu"]).keys() == _flat(inner[0].mu).keys()
    for k, w in _flat(inner[0].mu).items():
        assert _flat(adam["mu"])[k].shape == w.shape, k
    bigger = dict(adam, mu=dict(adam["mu"], extra={"kernel": np.zeros(2, np.float32)}))
    with pytest.raises(KeyError, match="lacks"):
        adam_state_from_optax(bigger, other.model, other.optimizer)


def test_asset_equals_a_fresh_restore():
    """assets/ckpt4480_train_state.npz against ckpt/4480 restored by the JAX
    package (the widths of examples/eval_inference_sweep.py), leaf for leaf."""
    state = EXPORT.restore_train_state(
        os.path.join(ROOT, "examples", "results", "scaled_accuracy", "ckpt"), num_clusters=256)
    with np.load(os.path.join(ROOT, "feat3dnet_tpu_torch", "assets",
                              "ckpt4480_train_state.npz")) as data:
        got = {k: data[k] for k in data.files}
    adam = state.opt_state[0]
    want = {"step": np.asarray(state.step), "opt_state/count": np.asarray(adam.count)}
    for prefix, tree in (("params/", state.params), ("batch_stats/", state.batch_stats),
                         ("opt_state/mu/", adam.mu), ("opt_state/nu/", adam.nu)):
        want.update({prefix + k: v for k, v in _flat(tree).items()})
    assert got.keys() == want.keys()
    assert int(got["step"]) == int(got["opt_state/count"]) == 4480
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        if k.startswith(("params", "batch_stats", "opt_state/mu", "opt_state/nu")):
            assert got[k].dtype == np.float32, k


@pytest.mark.parametrize("exclude", [False, True])
def test_cli_train_variables_with_moments(tmp_path, exclude):
    """cli.train --variables <train-state npz>: weights, moments, step and
    count restored (no epochs run); with --restore_exclude detection the
    detector keeps its seeded init with zero moments at the npz's count."""
    from feat3dnet_tpu_torch.cli import train
    from feat3dnet_tpu_torch.utils.init import init_variables
    from tests.test_torch_train import _write_dataset

    widths = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0)
    jstate, _ = _jax_state("constant", widths=widths)
    variables, adam, step = EXPORT.train_state_arrays(jstate)
    npz = str(tmp_path / "ts.npz")
    save_train_state_npz(npz, variables, adam, step)
    _write_dataset(tmp_path / "data", np.random.RandomState(3))
    args = ["--data_dir", str(tmp_path / "data"), "--log_dir", str(tmp_path / "log"),
            "--num_points", "64", "--num_clusters", "8", "--num_samples", "8",
            "--feature_dim", "16", "--base_scale", "10", "--batch_size", "2",
            "--device", "cpu", "--variables", npz, "--num_epochs", "0"]
    state = train.main(args + (["--restore_exclude", "detection"] if exclude else []))
    assert (state.step, state.count) == (3, 3)
    seeded = _flat(init_variables(ModelConfig(**widths), seed=0)["params"])
    want_params = _flat(variables["params"])
    got_params = _flat(jax.tree.map(lambda t: t.numpy(),
                                    variables_from_module(state.model)["params"]))
    mu, nu = _flat(adam["mu"]), _flat(adam["nu"])
    names = {id(p): n for n, p in state.model.named_parameters()}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            *scope, leaf = name.split(".")
            path = "/".join(scope + ["kernel" if leaf == "weight" else leaf])
            st = state.optimizer.state[p]
            assert st["step"].item() == 3.0, name
            m, v = (st[k].numpy() for k in ("exp_avg", "exp_avg_sq"))
            m, v = (m.T, v.T) if leaf == "weight" else (m, v)
            if exclude and name.startswith("detection"):
                assert not m.any() and not v.any(), name
                np.testing.assert_array_equal(got_params[path], seeded[path], err_msg=name)
            else:
                np.testing.assert_array_equal(m, mu[path], err_msg=name)
                np.testing.assert_array_equal(v, nu[path], err_msg=name)
                np.testing.assert_array_equal(got_params[path], want_params[path],
                                              err_msg=name)
