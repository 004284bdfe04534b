"""The training modes of the port (train/trainer.py, parallel/data_parallel.py,
models/layers.py, models/feat3dnet.py, cli/train.py) on the CPU: the chained
step, the int16 upload, the memory modes (remat_towers, the trainer's remat,
residual_dtype) and the CLI flags that reach them.

Within the port the chained step equals k fused calls, and remat_towers and
remat equal the plain step, bit for bit: loss, metrics, every gradient, the
BN buffers (the EMA applied once) and Adam's state. Against the JAX package
(its step eager: XLA's jit on the CPU moves its own grads, see
tests/test_torch_train.py) the tolerances are test_torch_train.py's: loss
rtol 1e-5 on the first step and 1e-4 after, sum_positive / sum_negative atol
1e-6, gradients per leaf rtol 5e-3 with atol 5e-4 max|ref| (the analytic
zeros atol 1e-3), batch_stats after one step rtol 1e-4 / atol 1e-6, and
after Adam the noise leaves within 2 lr a step, every other leaf's elements
>= 99.9 % within 1e-2 lr. residual_dtype rounds to bf16 at every ConvBN:
where the two frameworks' f32 Dense outputs differ by an ulp the rounding
can flip, one bf16 ulp (2^-8 relative) apart, and the flips travel. Its
forward is held to a cosine >= 0.999 for every descriptor, attention
within 1e-2 relative, the loss rtol 2e-2 and batch_stats rtol 2e-2 / atol
2e-3; its gradients to a cosine >= 0.99 per leaf and >= 0.999 over all of
them, but for the leaves that are analytically zero (the conv biases under
BN, the last mid conv's beta): the cotangent rounded to bf16 at the squash
point leaves them bf16 noise, held within 1e-2 of the largest gradient.
The chained data-parallel
step on 2 gloo ranks equals one process in float64 within 1e-9, as in
tests/test_torch_parallel.py.

JAX is imported inside the tests that use it: the spawned ranks import this
module.
"""
import json
import os

import numpy as np
import pytest
import torch

from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
from feat3dnet_tpu_torch.data.quant import quantize_clouds
from feat3dnet_tpu_torch.models import Feat3DNet, feat3dnet, layers
from feat3dnet_tpu_torch.parallel import (make_chained_dp_train_step, make_fused_dp_train_step,
                                          run_ranks, shard_batch)
from feat3dnet_tpu_torch.train.loss import alignment_triplet_loss
from feat3dnet_tpu_torch.train.trainer import (dequantize, init_state, make_chained_train_step,
                                               make_fused_train_step, stack_chunk,
                                               stack_triplet)
from feat3dnet_tpu_torch.utils import init_variables, load_variables, variables_from_module

torch.set_num_threads(2)

CFG = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
           detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8))
SMALL = dict(num_clusters=16, num_samples=8, feature_dim=16, base_scale=10.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))
N = 64
LR = 1e-3
AUG = ("RotateSmall", "Jitter")


def _triplets(seed, k, b=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        a = rng.randn(b, N, 3).astype(np.float32) * 3.0
        out.append((a, a + 0.01 * rng.randn(b, N, 3).astype(np.float32),
                    a + 0.2 * rng.randn(b, N, 3).astype(np.float32)))
    return out


def _cfg(route, **kw):
    if route == "fused":
        kw = dict(kw, fused_towers=True, fused_cot_dtype=torch.float32)
    return ModelConfig(**CFG, **kw)


def _state(cfg, variables=None, dtype=torch.float32, group=None, **tkw):
    model = Feat3DNet(cfg, bn_group=group)
    state = init_state(model, TrainConfig(num_points=N, learning_rate=LR, **tkw), cfg,
                       variables=variables or init_variables(cfg, seed=0), device="cpu")
    model.to(dtype)
    return state


def _numpy(t):
    if isinstance(t, dict):
        return {k: _numpy(v) for k, v in t.items()}
    return t.detach().cpu().numpy().copy()


def _snapshot(state):
    model = state.model
    names = {id(p): n for n, p in model.named_parameters()}
    return {"params": {k: _numpy(p) for k, p in model.named_parameters()},
            "grads": {k: _numpy(p.grad) for k, p in model.named_parameters()},
            "buffers": {k: _numpy(b) for k, b in model.named_buffers()},
            "adam": {names[id(p)]: {k: _numpy(v) for k, v in st.items()}
                     for p, st in state.optimizer.state.items()},
            "step": (state.step, state.count)}


def _assert_tree_equal(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


# ---- the chained step and the int16 upload --------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("route", ["autograd", "fused"])
def test_chained_step_equals_fused_calls(route, quant):
    """k = 3 augmented steps in one chained call against 3 fused calls, from
    one state: bit-equal in every metric of every step, the parameters, the
    gradients of the last step, the BN buffers and Adam's moments."""
    batches = _triplets(1, 3)
    cfg = _cfg(route)
    chained = _state(cfg)
    looped = _state(cfg)
    step_k = make_chained_train_step(chained.model, 1.0, cfg.attention, augmentations=AUG,
                                     aug_seed=5)
    step_1 = make_fused_train_step(looped.model, 1.0, cfg.attention, augmentations=AUG,
                                   aug_seed=5)
    chained, metrics_k = step_k(chained, stack_chunk(batches, "cpu", quant))
    for j, b in enumerate(batches):
        looped, metrics = step_1(looped, stack_triplet(b, "cpu", quant))
        _assert_tree_equal(_numpy({k: v if isinstance(v, torch.Tensor) else v
                                   for k, v in metrics.items()}),
                           _numpy(_pick(metrics_k, j)), f"step {j}")
    assert chained.step == looped.step == 3
    _assert_tree_equal(_snapshot(chained), _snapshot(looped))
    assert metrics_k["loss"].shape == (3,) and metrics_k["hist_det_cnt"]["counts"].shape == (3, 16)


def _pick(tree, j):
    return {k: _pick(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}


def test_upload_and_dequantize():
    """The int16 upload halves the bytes; a chunk's batches keep their own
    scales, so chunked and single uploads dequantize to the same clouds,
    which equal the host's q * scale bit for bit."""
    batches = _triplets(2, 3)
    f32 = stack_triplet(batches[0], "cpu")
    q, scale = stack_triplet(batches[0], "cpu", quant=True)
    assert q.dtype == torch.int16 and scale.dtype == torch.float32 and scale.dim() == 0
    assert q.numel() * q.element_size() * 2 == f32.numel() * f32.element_size()
    hq, hscale = quantize_clouds(f32.numpy())
    np.testing.assert_array_equal(dequantize((q, scale)).numpy(),
                                  hq.astype(np.float32) * hscale)
    assert np.abs(dequantize((q, scale)).numpy() - f32.numpy()).max() <= hscale
    qk, scales = stack_chunk(batches, "cpu", quant=True)
    assert qk.shape == (3,) + tuple(q.shape) and scales.shape == (3,)
    for j, b in enumerate(batches):
        one = stack_triplet(b, "cpu", quant=True)
        assert torch.equal(qk[j], one[0]) and torch.equal(scales[j], one[1])
    assert torch.equal(dequantize(f32), f32)


def test_chained_and_dp_steps_refuse_mismatches():
    cfg = _cfg("autograd")
    state = _state(cfg)
    step = make_chained_train_step(state.model, 1.0, cfg.attention)
    qk, scales = stack_chunk(_triplets(3, 2), "cpu", quant=True)
    with pytest.raises(ValueError, match="scales"):
        step(state, (qk, scales[:1]))
    with pytest.raises(ValueError, match="no batch"):
        step(state, qk[:0].float())
    group = object()                 # refused before any collective
    model = Feat3DNet(cfg)
    model.bn_group = group
    for make, clouds in ((make_fused_dp_train_step, stack_triplet(_triplets(3, 1)[0], "cpu")),
                         (make_chained_dp_train_step, (qk, scales))):
        dp = make(model, 1.0, cfg.attention, group, quantized=not isinstance(clouds, tuple))
        with pytest.raises(ValueError, match="quantized="):
            dp(state, clouds)


def _jax_setup(jcfg_kw, remat=False):
    import jax

    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
    from feat3dnet_tpu.config import TrainConfig as JaxTrainConfig
    from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
    from feat3dnet_tpu.train import trainer as jtr

    jcfg = JaxModelConfig(**jcfg_kw)
    jmodel = JaxFeat3DNet(jcfg)
    tx = jtr.make_optimizer(LR)
    jstate, _ = jtr.init_state(jmodel, JaxTrainConfig(num_points=N), jcfg,
                               jax.random.PRNGKey(0), tx=tx)
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    return jcfg, jmodel, tx, jstate, variables


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
        g = np.zeros(p.shape, np.float32) if p.grad is None else _numpy(p.grad)
        out["/".join(scope + ["kernel" if leaf == "weight" else leaf])] = \
            g.T if leaf == "weight" else g
    return out


def _noise_leaves(grads):
    top = max(np.abs(g).max() for g in grads.values())
    return {k for k, g in grads.items() if np.abs(g).max() <= 1e-4 * top}


def _assert_params_close(model, jparams, noise, steps):
    mine = _flat(variables_from_module(model)["params"])
    for path, w in _flat(jparams).items():
        if path in noise:
            np.testing.assert_allclose(mine[path], w, rtol=0, atol=2 * LR * steps + 1e-7,
                                       err_msg=path)
        else:
            assert np.mean(np.abs(mine[path] - w) <= 1e-2 * LR) >= 0.999, path


@pytest.mark.parametrize("quant", [False, True])
def test_chained_step_matches_jax(quant):
    """The port's chained step (k = 3, no augmentation: the two frameworks'
    generators differ) against JAX's make_chained_train_step, run eagerly."""
    import jax
    import jax.numpy as jnp

    from feat3dnet_tpu.train import trainer as jtr

    jcfg, jmodel, tx, jstate, variables = _jax_setup(CFG)
    cfg = _cfg("autograd")
    state = _state(cfg, variables)
    batches = _triplets(4, 3)
    stack = stack_chunk(batches, "cpu", quant)
    jstack = (jnp.asarray(stack[0].numpy()), jnp.asarray(stack[1].numpy())) if quant \
        else jnp.asarray(stack.numpy())
    # the first step's gradients on JAX's side pick the leaves of rounding noise
    clouds0 = dequantize(stack_triplet(batches[0], "cpu", quant)).numpy()

    def loss_fn(params):
        from feat3dnet_tpu.train.loss import alignment_triplet_loss
        out, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats},
                              jnp.asarray(clouds0), training=True, mutable=["batch_stats"])
        fa, fp, fn = jnp.split(out.features, 3, axis=0)
        return alignment_triplet_loss(fa, fp, fn, jnp.split(out.attention, 3, axis=0)[0],
                                      1.0)[0]

    noise = _noise_leaves(_flat(jax.grad(loss_fn)(jstate.params)))
    with jax.disable_jit():
        jstate, jm = jtr.make_chained_train_step(jmodel, tx, 1.0, jcfg.attention)(jstate,
                                                                                   jstack)
    state, m = make_chained_train_step(state.model, 1.0, cfg.attention)(state, stack)
    for j in range(3):
        np.testing.assert_allclose(m["loss"][j].item(), float(jm["loss"][j]),
                                   rtol=1e-5 if j == 0 else 1e-4)
        for key in ("sum_positive", "sum_negative"):
            np.testing.assert_allclose(m[key][j].item(), float(jm[key][j]), rtol=0, atol=1e-6,
                                       err_msg=key)
        np.testing.assert_array_equal(m["hist_det_cnt"]["counts"][j].numpy(),
                                      np.asarray(jm["hist_det_cnt"]["counts"][j]))
    assert state.step == int(jstate.step) == 3
    _assert_params_close(state.model, jax.tree.map(np.asarray, jstate.params), noise, 3)


def dp_chained_ranks(rank, world, group, dev, cases):
    """The rank body: every case's chained data-parallel step on this
    rank's share of each batch."""
    return {key: run_chained(*case, group=group, rank=rank, world=world)
            for key, case in cases.items()}


def run_chained(route, quant, k, group=None, rank=0, world=1):
    """k chained steps in float64 from the seeded weights -> numpy of the
    metrics, the last step's grads, the BN buffers and the params."""
    cfg = _cfg(route)
    state = _state(cfg, dtype=torch.float64, group=group)
    stack = stack_chunk(_triplets(6, k, b=4), "cpu", quant)
    if not quant:
        stack = stack.to(torch.float64)
    if group is None:
        step = make_chained_train_step(state.model, 1.0, cfg.attention)
    else:
        step = make_chained_dp_train_step(state.model, 1.0, cfg.attention, group,
                                          quantized=quant)
        stack = ((shard_batch(stack[0], rank, world, axis=1), stack[1]) if quant
                 else shard_batch(stack, rank, world, axis=1))
    state, metrics = step(state, stack)
    snap = _snapshot(state)
    snap["metrics"] = _numpy(metrics)
    return snap


def test_chained_dp_two_ranks_match_one_process(tmp_path):
    """The chained data-parallel step (k = 2) on 2 gloo ranks against one
    process on the combined batches, in float64: both routes, float and
    int16 uploads, within 1e-9 (tests/test_torch_parallel.py's rule; as
    there, float64 runs without augmentation, whose draws are f32)."""
    cases = {(route, quant): (route, quant, 2)
             for route in ("autograd", "fused") for quant in (False, True)}
    ranks = run_ranks(dp_chained_ranks, 2, "gloo", init_file=str(tmp_path / "store"),
                      args=(cases,), timeout=600, threads=1)
    for key, case in cases.items():
        single = run_chained(*case)
        for dp in (ranks[0][key], ranks[1][key]):
            for k, g in single["grads"].items():
                top = np.abs(g).max()
                assert np.abs(dp["grads"][k] - g).max() <= (1e-12 if top <= 1e-12
                                                            else 1e-9 * top), (key, k)
            for k in ("loss", "sum_positive", "sum_negative"):
                np.testing.assert_allclose(dp["metrics"][k], single["metrics"][k], rtol=1e-9,
                                           err_msg=str((key, k)))
            np.testing.assert_array_equal(dp["metrics"]["hist_det_cnt"]["counts"],
                                          single["metrics"]["hist_det_cnt"]["counts"])
            # the first step moves an analytic-zero leaf (a conv bias) by up to
            # lr 1e-12 / 1e-8 either way (tests/test_torch_parallel.py), which
            # shifts the second step's BN means: the parameters' atol
            for k, v in single["buffers"].items():
                np.testing.assert_allclose(dp["buffers"][k], v, rtol=1e-9, atol=2 * LR * 1e-4,
                                           err_msg=str((key, k)))
            for k, v in single["params"].items():
                np.testing.assert_allclose(dp["params"][k], v, rtol=1e-9, atol=2 * LR * 1e-4,
                                           err_msg=str((key, k)))
            assert dp["step"] == single["step"] == (2, 2)


# ---- the memory modes -------------------------------------------------------------------


class _Calls:
    """Counts each ConvBN's forward calls (the recompute runs them again)."""

    def __init__(self, model):
        self.n = {}
        for name, mod in model.named_modules():
            if isinstance(mod, layers.ConvBN):
                mod.register_forward_hook(lambda m, i, o, name=name: self.n.__setitem__(
                    name, self.n.get(name, 0) + 1))


@pytest.mark.parametrize("mode,route,dtype", [
    ("remat_towers", "autograd", "float32"), ("remat_towers", "autograd", "bfloat16"),
    ("remat", "autograd", "float32"), ("remat", "autograd", "bfloat16"),
    ("remat", "fused", "float32"), ("both", "autograd", "float32")])
def test_remat_modes_equal_plain(mode, route, dtype):
    """One augmented step with remat_towers, the trainer's remat or both
    against the plain step: bit-equal loss, metrics, gradients, BN buffers,
    parameters and Adam moments. The recompute runs the segments' ConvBNs a
    second time and the EMA stays applied once: the buffers equal the plain
    step's, which moved from the initial ones."""
    dt = getattr(torch, dtype)
    towers = mode in ("remat_towers", "both")
    plain_cfg = _cfg(route, compute_dtype=dt)
    cfg = _cfg(route, compute_dtype=dt, remat_towers=towers)
    plain, modal = _state(plain_cfg), _state(cfg)
    init = {k: _numpy(b) for k, b in plain.model.named_buffers()}
    calls = _Calls(modal.model)
    clouds = stack_triplet(_triplets(7, 1)[0], "cpu")
    _, m0 = make_fused_train_step(plain.model, 1.0, cfg.attention, augmentations=AUG,
                                  aug_seed=2)(plain, clouds)
    _, m1 = make_fused_train_step(modal.model, 1.0, cfg.attention, augmentations=AUG,
                                  aug_seed=2, remat=mode != "remat_towers")(modal, clouds)
    _assert_tree_equal(_numpy(m1), _numpy(m0))
    _assert_tree_equal(_snapshot(modal), _snapshot(plain))
    assert all(not np.array_equal(v, init[k]) for k, v in _snapshot(plain)["buffers"].items())
    # the recomputes: the whole forward once more under remat, the per-point
    # segments once more under remat_towers (within remat's: both nest)
    per_point = {k for k in calls.n if "post" not in k}
    want = {k: 1 + (mode != "remat_towers") + (mode != "remat" and k in per_point)
            for k in calls.n}
    assert calls.n == want and (route == "autograd") == bool(per_point)


@pytest.mark.parametrize("mode", ["remat_towers", "remat"])
def test_remat_modes_match_jax(mode):
    """One step of the port's mode against JAX's (tests/test_model.py's
    remat_towers, tests/test_train.py's remat), eager, from the same
    weights, at test_torch_train.py's tolerances and configuration."""
    import jax
    import jax.numpy as jnp

    from feat3dnet_tpu.train import trainer as jtr

    kw = dict(remat_towers=True) if mode == "remat_towers" else {}
    jcfg, jmodel, tx, jstate, variables = _jax_setup(dict(CFG, **kw))
    cfg = _cfg("autograd", **kw)
    state = _state(cfg, variables)
    a, p, n = _triplets(8, 1)[0]
    jstep = jtr.make_train_step(jmodel, tx, 1.0, jcfg.attention, remat=mode == "remat")
    _, jm = jstep(jstate, *map(jnp.asarray, (a, p, n)))
    step = make_fused_train_step(state.model, 1.0, cfg.attention, remat=mode == "remat")
    _, m = step(state, stack_triplet((a, p, n), "cpu"))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    for key in ("sum_positive", "sum_negative"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=0, atol=1e-6)

    def loss_fn(params):
        from feat3dnet_tpu.train.loss import alignment_triplet_loss
        out, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats},
                              jnp.concatenate(list(map(jnp.asarray, (a, p, n)))),
                              training=True, mutable=["batch_stats"])
        fa, fp, fn = jnp.split(out.features, 3, axis=0)
        return alignment_triplet_loss(fa, fp, fn, jnp.split(out.attention, 3, axis=0)[0],
                                      1.0)[0]

    want = _flat(jax.grad(loss_fn)(jstate.params))
    noise = _noise_leaves(want)
    got = _port_grads(state.model)
    for path, w in want.items():
        if path in noise:
            np.testing.assert_allclose(got[path], w, atol=1e-3, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=5e-3,
                                       atol=5e-4 * max(np.abs(w).max(), 1e-3), err_msg=path)


def test_squash_cotangent_rounds_like_jax():
    """A squash point's cotangent is rounded to bf16 (autograd's
    ToCopyBackward), as JAX transposes the cast; its value is x rounded."""
    import jax
    import jax.numpy as jnp

    from feat3dnet_tpu.models.layers import squash_residual as jax_squash

    rs = np.random.RandomState(9)
    x = rs.randn(4, 33).astype(np.float32) * 3.0
    c = rs.randn(4, 33).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layers.squash_residual(xt, torch.bfloat16, True)
    (y * torch.from_numpy(c)).sum().backward()
    jy, jvp = jax.vjp(lambda v: jax_squash(v, jnp.bfloat16, True), jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jvp(jnp.asarray(c))[0]))
    assert not np.array_equal(xt.grad.numpy(), c)      # it did round
    assert layers.squash_residual(xt, torch.bfloat16, False) is xt


def _residual_run(cfg, clouds, variables):
    model = feat3dnet.Feat3DNet(cfg)
    load_variables(model, variables)
    out = model(torch.from_numpy(clouds), training=True)
    fa, fp, fn = torch.chunk(out.features, 3)
    loss, _ = alignment_triplet_loss(fa, fp, fn, torch.chunk(out.attention, 3)[0], 1.0)
    loss.backward()
    return out, loss, model


def test_residual_dtype_matches_jax():
    """residual_dtype = bf16 in training: the forward (features, attention,
    batch_stats) and the gradients against JAX's, at the tolerances of the
    module docstring; eval is unchanged by the mode."""
    import jax
    import jax.numpy as jnp

    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
    from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
    from feat3dnet_tpu.train.loss import alignment_triplet_loss

    clouds = np.concatenate(_triplets(10, 1)[0]).astype(np.float32)
    jmodel = JaxFeat3DNet(JaxModelConfig(**SMALL, residual_dtype=jnp.bfloat16))
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clouds[:3]), training=False)
    variables = jax.tree.map(np.asarray, v)

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]},
                                jnp.asarray(clouds), training=True, mutable=["batch_stats"])
        fa, fp, fn = jnp.split(out.features, 3, axis=0)
        loss = alignment_triplet_loss(fa, fp, fn, jnp.split(out.attention, 3, axis=0)[0],
                                      1.0)[0]
        return loss, (out.features, out.attention, mut)

    (jloss, (jfeat, jatt, jmut)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    cfg = ModelConfig(**SMALL, residual_dtype=torch.bfloat16)
    out, loss, model = _residual_run(cfg, clouds, variables)
    feat, jfeat = _numpy(out.features), np.asarray(jfeat)
    assert np.sum(feat * jfeat, axis=-1).min() >= 0.999
    np.testing.assert_allclose(_numpy(out.attention), np.asarray(jatt), rtol=1e-2)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-2)
    mine = _flat(_numpy(variables_from_module(model)["batch_stats"]))
    for path, w in _flat(jax.tree.map(np.asarray, jmut["batch_stats"])).items():
        np.testing.assert_allclose(mine[path], w, rtol=2e-2, atol=2e-3, err_msg=path)
    want = _flat(jgrads)
    got = _port_grads(model)
    zeros = {p for p in want if p.endswith("conv2d/bias")
             and p.split("/")[1].startswith("conv")} | {"description/conv_mid_0/bn/bias"}
    top = max(np.abs(w).max() for w in want.values())
    for path in sorted(want):
        g, w = got[path], want[path]
        if path in zeros:
            assert np.abs(g - w).max() <= 1e-2 * top, path
        else:
            cos = float(np.sum(g * w) / (np.linalg.norm(g) * np.linalg.norm(w)))
            assert cos >= 0.99, (path, cos)
    g, w = (np.concatenate([t[p].ravel() for p in sorted(want) if p not in zeros])
            for t in (got, want))
    assert float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))) >= 0.999
    evals = []
    for c in (ModelConfig(**SMALL), cfg):             # eval: the squash points are off
        m = Feat3DNet(c)
        load_variables(m, variables)
        with torch.no_grad():
            evals.append(m(torch.from_numpy(clouds[:2])).features)
    assert torch.equal(*evals)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_saving_keeps_low_copies(dtype, monkeypatch):
    """The packing changes what autograd keeps, not the step: the gradients
    and BN buffers equal the same squash points' without it (plain ops, no
    saved-tensor hooks), and the bytes autograd saves in the towers' per-
    point segments drop to under 60 % of the plain mode's."""
    dt = getattr(torch, dtype)
    clouds = np.concatenate(_triplets(11, 1)[0]).astype(np.float32)
    variables = init_variables(ModelConfig(**SMALL), seed=0)
    cfg = ModelConfig(**SMALL, residual_dtype=torch.bfloat16, compute_dtype=dt)
    saved = {}
    pack = layers._pack

    def counting(t):
        r = pack(t)
        u = r.low if isinstance(r, layers._Low) else t
        saved[u.untyped_storage().data_ptr()] = u.untyped_storage().nbytes()
        return r

    monkeypatch.setattr(layers, "_pack", counting)
    _, loss, model = _residual_run(cfg, clouds, variables)
    packed_bytes = sum(saved.values())
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    # the reference: the same squash points through plain ops, nothing packed,
    # and the bytes a plain segment saves
    monkeypatch.setattr(layers._Normalize, "apply",
                        staticmethod(lambda x, mean, mul, bias: (x - mean) * mul + bias))
    monkeypatch.setattr(layers._Relu, "apply", staticmethod(torch.relu))
    monkeypatch.setattr(feat3dnet, "_maybe_remat", lambda f, c, t: f)
    _, loss2, model2 = _residual_run(cfg, clouds, variables)
    assert loss.item() == loss2.item()
    for k, p in model2.named_parameters():
        assert torch.equal(grads[k], p.grad), k
    for k, b in model2.named_buffers():
        assert torch.equal(buffers[k], b), k
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(counting, layers._unpack):
        _residual_run(ModelConfig(**SMALL, compute_dtype=dt), clouds, variables)
    assert packed_bytes < 0.6 * sum(saved.values()), (packed_bytes, sum(saved.values()))


# ---- cli.train ----------------------------------------------------------------------------


@pytest.fixture
def tiny_dataset(tmp_path):
    """tests/test_cli.py's dataset: 4 training clouds, 4 validation pairs."""
    rng = np.random.RandomState(0)
    train_dir, clusters = tmp_path / "train", tmp_path / "clusters"
    train_dir.mkdir()
    clusters.mkdir()
    lines = []
    for i in range(4):
        ((rng.rand(300, 6).astype(np.float32) - 0.5) * 12.0).tofile(str(train_dir / f"{i}.bin"))
        lines.append(f"{i}.bin | {(i + 1) % 4} | {(i + 2) % 4}")
    (train_dir / "train.txt").write_text("\n".join(lines))
    vlines = ["idx label"]
    for i in range(4):
        c = (rng.rand(60, 6).astype(np.float32) - 0.5) * 4.0
        c.tofile(str(clusters / f"{i}_0.bin"))
        other = c + 0.001 if i % 2 else (rng.rand(60, 6).astype(np.float32) - 0.5) * 4.0
        other.astype(np.float32).tofile(str(clusters / f"{i}_1.bin"))
        vlines.append(f"{i} {i % 2}")
    (clusters / "filenames.txt").write_text("\n".join(vlines))
    return tmp_path


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]


def test_cli_chained_quantized(tiny_dataset, tmp_path):
    """--steps_per_dispatch 2 --upload_quant int16 as in tests/test_cli.py:
    every inner step logged, validation and checkpoints at chunk ends, the
    native reader logged, and --auto_resume continuing the chunks."""
    from feat3dnet_tpu_torch.cli import train
    from feat3dnet_tpu_torch.utils.checkpoint import CheckpointManager

    log_dir = str(tmp_path / "chained")
    args = ["--data_dir", str(tiny_dataset), "--num_points", "128", "--num_clusters", "8",
            "--num_samples", "8", "--feature_dim", "16", "--batch_size", "2",
            "--noattention", "--noregress", "--num_epochs", "2", "--steps_per_dispatch", "2",
            "--upload_quant", "int16", "--augmentation", "Jitter", "RotateSmall",
            "--validate_every_n_steps", "2", "--checkpoint_every_n_steps", "2",
            "--summary_every_n_steps", "1", "--log_dir", log_dir, "--device", "cpu"]
    state = train.main(args)
    assert state.step == 4
    rows = _rows(log_dir)
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in rows if "fp_rate" in r] == [2, 4]
    assert all(np.isfinite(r["loss"]) and "hist_det_cnt" in r for r in rows if "loss" in r)
    assert CheckpointManager(os.path.join(log_dir, "ckpt")).all_steps() == [2, 4]
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    assert "Triplet reader: native" in log and "'steps_per_dispatch': 2" in log
    state = train.main(args + ["--auto_resume"])           # from step 4, two more epochs
    assert state.step == 8
    assert [r["step"] for r in _rows(log_dir) if "loss" in r] == list(range(1, 9))
    assert CheckpointManager(os.path.join(log_dir, "ckpt")).latest_step() == 8


@pytest.mark.parametrize("quant", [False, True])
def test_cli_rows_do_not_depend_on_chunking(tiny_dataset, tmp_path, quant):
    """--steps_per_dispatch 3 (a ragged chunk at each epoch's end) writes the
    rows of --steps_per_dispatch 1, bit for bit, on the fused route."""
    from feat3dnet_tpu_torch.cli import train

    args = ["--data_dir", str(tiny_dataset), "--num_points", "128", "--num_clusters", "8",
            "--num_samples", "8", "--feature_dim", "16", "--batch_size", "1",
            "--num_epochs", "2", "--summary_every_n_steps", "1", "--fused_towers",
            "--validate_every_n_steps", "0", "--device", "cpu"] \
        + (["--upload_quant", "int16"] if quant else [])
    rows = {}
    for k in (1, 3):
        log_dir = str(tmp_path / f"k{k}")
        assert train.main(args + ["--log_dir", log_dir, "--steps_per_dispatch", str(k)]).step == 8
        rows[k] = _rows(log_dir)
    assert [r["step"] for r in rows[1]] == list(range(1, 9)) and rows[1] == rows[3]


@pytest.mark.parametrize("flags", [["--remat_towers"], ["--residual_dtype", "bfloat16"],
                                   ["--compute_dtype", "bfloat16", "--residual_dtype",
                                    "bfloat16"]])
def test_cli_memory_modes(tiny_dataset, tmp_path, flags, monkeypatch):
    """The memory-mode flags reach the model (no refusal): the run trains,
    its rows are finite, and --remat_towers writes the rows of a plain run."""
    from feat3dnet_tpu_torch.cli import train

    seen = []
    orig = feat3dnet._maybe_remat
    monkeypatch.setattr(feat3dnet, "_maybe_remat",
                        lambda f, c, t: seen.append((c.remat_towers, c.residual_dtype)) or
                        orig(f, c, t))
    args = ["--data_dir", str(tiny_dataset), "--num_points", "128", "--num_clusters", "8",
            "--num_samples", "8", "--feature_dim", "16", "--batch_size", "2",
            "--num_epochs", "1", "--summary_every_n_steps", "1",
            "--validate_every_n_steps", "0", "--device", "cpu"]
    state = train.main(args + ["--log_dir", str(tmp_path / "mode")] + flags)
    assert state.step == 2
    rows = _rows(str(tmp_path / "mode"))
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)
    want = (True, None) if flags == ["--remat_towers"] else (False, torch.bfloat16)
    assert seen and all(s == want for s in seen)
    if flags == ["--remat_towers"]:
        train.main(args + ["--log_dir", str(tmp_path / "plain")])
        assert _rows(str(tmp_path / "plain")) == rows
