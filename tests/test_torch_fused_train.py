"""Port of ops/fused_train (the training towers, CPU plain passes) and of the
training-mode ConvBN and forward, against the JAX package.

Tolerances are those of tests/test_fused_train.py: loss rtol 2e-5 (of the
sum of |terms|: the signed sum cancels), pooled 1e-4, means
rtol 1e-5 / atol 1e-6, vars rtol 1e-4 / atol 1e-6, dx rtol 5e-3 / atol
5e-5, dW / dgamma / dbeta rtol 5e-3 with atol 5e-4 max|ref|, and the conv
biases (analytically zero under BN, both sides rounding noise) atol 1e-3.
The two frameworks sum in different orders; with bf16 cotangents both round
at the same two places, but a value that lands on the other side of a bf16
rounding boundary moves by one bf16 step (2^-8 relative) and carries that
into the layers below, so there dx is held to a relative L2 error of 2^-8
instead of elementwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu.ops import fused_train as jft
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.models.layers import ConvBN
from feat3dnet_tpu_torch.ops import fused_train as tft
from feat3dnet_tpu_torch.utils import load_variables, variables_from_module

torch.set_num_threads(2)

NS, CIN, CT = 16, 3, 32


def _case(rng, plan, widths, g_total, gp, repeat):
    """Inputs as tests/test_fused_train.py draws them (weights x0.4 for the
    detector plan, x0.3 for the descriptor's)."""
    scale = 0.4 if plan == jft.detector_plan(len(widths)) else 0.3
    x = rng.randn(NS, gp, CIN).astype(np.float32)
    if repeat:      # later slots copy slot 0 for a share of the clusters: pool ties
        x[NS // 2:, :g_total // 2, :] = x[0:1, :g_total // 2, :]
    flat = []
    for ci, co in tft.plan_conv_widths(plan, widths, CIN):
        flat += [rng.randn(ci, co).astype(np.float32) * scale,
                 rng.randn(co).astype(np.float32) * 0.1,
                 (1.0 + 0.2 * rng.randn(co)).astype(np.float32),
                 (0.1 * rng.randn(co)).astype(np.float32)]
    lw = rng.randn(g_total, widths[-1]).astype(np.float32)
    return x, flat, lw


def _port_grads(x, flat, lw, plan, widths, g_total, cot, tower=None):
    """The port's tower (`tower(x, flat)`, by default tower_prepool_fused on
    `plan` with `cot` cotangents) and its gradients under the loss
    sum(pooled * lw)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = [torch.from_numpy(f).requires_grad_(True) for f in flat]
    if tower is None:
        pooled, (means, vars_) = tft.tower_prepool_fused(xt, ft, plan, widths, NS, g_total,
                                                         1e-3, cot)
    else:
        pooled, (means, vars_) = tower(xt, ft)
    loss = (pooled[:g_total] * torch.from_numpy(lw)).sum()
    loss.backward()
    return (pooled[:g_total].detach().numpy(), [m.numpy() for m in means],
            [v.numpy() for v in vars_], xt.grad.numpy(), [f.grad.numpy() for f in ft])


def _assert_matches(got, want, g_total, lw, bf16=False):
    pooled, means, vars_, dx, dflat = got
    wpooled, wmeans, wvars, wdx, wdflat = want
    wpooled = np.asarray(wpooled)[:g_total]
    assert np.abs(pooled - wpooled).max() <= 1e-4
    np.testing.assert_allclose((pooled * lw).sum(), (wpooled * lw).sum(), rtol=0,
                               atol=2e-5 * np.abs(wpooled * lw).sum())
    for a, b in zip(means, wmeans):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(vars_, wvars):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    wdx = np.asarray(wdx)
    if bf16:
        err = np.linalg.norm(dx[:, :g_total] - wdx[:, :g_total]) / np.linalg.norm(wdx)
        assert err <= 2.0 ** -8, err
    else:
        np.testing.assert_allclose(dx[:, :g_total], wdx[:, :g_total], rtol=5e-3, atol=5e-5)
    if dx.shape[1] > g_total:
        np.testing.assert_array_equal(dx[:, g_total:], 0.0)
    for i, (a, b) in enumerate(zip(dflat, wdflat)):
        b = np.asarray(b)
        if i % 4 == 1:
            np.testing.assert_allclose(a, b, atol=1e-3, err_msg=f"b{i // 4}")
        else:
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4 * max(np.abs(b).max(), 1e-3),
                                       err_msg=f"param {i}")


def _jax_grads(fn, x, flat, lw, g_total):
    def loss(x, fl):
        pooled, (means, vars_) = fn(x, fl)
        return jnp.sum(pooled[:g_total] * lw), (pooled, means, vars_)

    (_, (p, m, v)), (gx, gf) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), tuple(jnp.asarray(f) for f in flat))
    return p, m, v, gx, gf


def _plan(kind):
    if kind == "detector":
        return jft.detector_plan(3), (8, 16, 32)
    n_mid = int(kind[-1])
    mid = (24,) if n_mid == 1 else (24, 16)
    return jft.descriptor_plan(2, n_mid), (8, 16) + mid


@pytest.mark.parametrize("kind,g_total,gp,repeat", [
    ("detector", 96, 96, False),       # exact tiling
    ("detector", 80, 96, False),       # padded clusters (masked statistics)
    ("detector", 96, 96, True),        # repeat-pad slots: exact ties in the pool
    ("descriptor1", 96, 96, True),     # the paper's descriptor shape: one mid conv
    ("descriptor2", 80, 96, True),     # padded + two mid convs (ReLU, then none)
])
def test_tower_matches_jax_reference(rng, kind, g_total, gp, repeat):
    """The port's tower (f32 cotangents) against JAX reference_tower, and the
    port's own autograd reference_tower against it too."""
    plan, widths = _plan(kind)
    x, flat, lw = _case(rng, plan, widths, g_total, gp, repeat)
    want = _jax_grads(lambda x, fl: jft.reference_tower(
        jnp.pad(x[:, :g_total], ((0, 0), (0, gp - g_total), (0, 0))), fl, plan, widths,
        NS, g_total), x, flat, lw, g_total)
    _assert_matches(_port_grads(x, flat, lw, plan, widths, g_total, torch.float32), want,
                    g_total, lw)
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = [torch.from_numpy(f).requires_grad_(True) for f in flat]
    pooled, (means, vars_) = tft.reference_tower(xt, ft, plan, widths, NS, g_total)
    (pooled * torch.from_numpy(lw)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy()[:, :g_total], np.asarray(want[3])[:, :g_total],
                               rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("kind,cot", [("detector", "bfloat16"), ("descriptor2", "bfloat16"),
                                      ("descriptor1", "float32")])
def test_tower_matches_jax_fused_interpret(rng, kind, cot):
    """Against JAX's own fused pipeline (Pallas interpret mode), with the
    streamed cotangent in bf16 (rounded at the same two places) or f32."""
    plan, widths = _plan(kind)
    g_total, gp = 80, 96
    x, flat, lw = _case(rng, plan, widths, g_total, gp, True)
    want = _jax_grads(lambda x, fl: jft.tower_prepool_fused(
        x, fl, plan, widths, NS, g_total, 1e-3, CT, True, None, getattr(jnp, cot)),
        x, flat, lw, g_total)
    _assert_matches(_port_grads(x, flat, lw, plan, widths, g_total, getattr(torch, cot)),
                    want, g_total, lw, bf16=cot == "bfloat16")


@pytest.mark.parametrize("cot", ["bfloat16", "float32"])
def test_convbn_maxpool_fused_matches_jax_interpret(rng, cot):
    """`convbn_maxpool_fused` (tower_prepool_fused on the detector's plan)
    against JAX's `convbn_maxpool_fused` in Pallas interpret mode, padded
    clusters and pool ties, at the limits of the fused tower test."""
    plan, widths = _plan("detector")
    g_total, gp = 80, 96
    x, flat, lw = _case(rng, plan, widths, g_total, gp, True)
    want = _jax_grads(lambda x, fl: jft.convbn_maxpool_fused(
        x, fl, widths, NS, g_total, 1e-3, CT, True, getattr(jnp, cot)), x, flat, lw, g_total)
    got = _port_grads(x, flat, lw, plan, widths, g_total, None, tower=lambda x, fl:
                      tft.convbn_maxpool_fused(x, fl, widths, NS, g_total,
                                               cot_dtype=getattr(torch, cot)))
    _assert_matches(got, want, g_total, lw, bf16=cot == "bfloat16")


def test_reference_convbn_maxpool_matches_jax(rng):
    """`reference_convbn_maxpool` against JAX's: pooled within 1e-4, means
    rtol 1e-5 / atol 1e-6, vars rtol 1e-4 / atol 1e-6; and it is
    reference_tower on the detector's plan."""
    plan, widths = _plan("detector")
    g_total, gp = 80, 96
    x, flat, _ = _case(rng, plan, widths, g_total, gp, True)
    wp, (wm, wv) = jft.reference_convbn_maxpool(jnp.asarray(x), [jnp.asarray(f) for f in flat],
                                                widths, NS, g_total)
    xt, ft = torch.from_numpy(x), [torch.from_numpy(f) for f in flat]
    pooled, (means, vars_) = tft.reference_convbn_maxpool(xt, ft, widths, NS, g_total)
    assert pooled.shape == (g_total, widths[-1])
    assert np.abs(pooled.numpy() - np.asarray(wp)).max() <= 1e-4
    for a, b in zip(means, wm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(vars_, wv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    rp, (rm, rv) = tft.reference_tower(xt, ft, plan, widths, NS, g_total)
    assert torch.equal(pooled, rp)
    assert all(torch.equal(a, b) for a, b in zip(means + vars_, rm + rv))


def _jax_pool_passes(x, folded, mu, isig, dpool, plan, ns):
    """JAX's _final_kernel and _bwdstats_top_kernel (Pallas, interpret mode),
    called as its _fwd_impl and _bwd_impl call them: (pooled, (sum dz,
    sum dz * xhat))."""
    from functools import partial

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    gp, cin = x.shape[1], x.shape[2]
    c_top = folded[-1][0].shape[1]
    ops = [jnp.asarray(t).reshape(1, -1) if t.ndim == 1 else jnp.asarray(t)
           for cv in folded for t in cv]
    vm = pl.BlockSpec(memory_space=pltpu.VMEM)
    x_spec = pl.BlockSpec((ns, CT, cin), lambda i: (0, i, 0), memory_space=pltpu.VMEM)
    tile = pl.BlockSpec((CT, c_top), lambda i: (i, 0), memory_space=pltpu.VMEM)
    pooled = pl.pallas_call(
        partial(jft._final_kernel, plan=plan, ns=ns, ct=CT), grid=(gp // CT,),
        in_specs=[x_spec] + [vm] * len(ops), out_specs=tile,
        out_shape=jax.ShapeDtypeStruct((gp, c_top), jnp.float32), interpret=True,
    )(jnp.asarray(x), *ops)
    bst = pl.pallas_call(
        partial(jft._bwdstats_top_kernel, plan=plan, ns=ns, ct=CT), grid=(gp // CT,),
        in_specs=[x_spec] + [vm] * (len(ops) + 2) + [tile],
        out_specs=pl.BlockSpec((8, c_top), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, c_top), jnp.float32), interpret=True,
    )(jnp.asarray(x), *ops, jnp.asarray(mu).reshape(1, -1), jnp.asarray(isig).reshape(1, -1),
      jnp.asarray(dpool))
    return np.asarray(pooled), np.asarray(bst[:2])


@pytest.mark.parametrize("kind,case", [
    ("detector", "all_tied"), ("detector", "pad_slots"), ("detector", "relu_zero"),
    ("descriptor1", "all_tied"), ("descriptor1", "pad_slots")])
def test_pool_passes_ties_and_pads_match_jax_interpret(rng, kind, case):
    """The final pass and the top backward pass (plain, as the CPU runs
    them) against JAX's _final_kernel and _bwdstats_top_kernel in interpret
    mode on inputs where the slot max-pool ties: every slot of every
    cluster the same point (each channel ties ns ways); an odd ns, so the
    kernels' 64-slot tiles carry pad slots; or, for the detector's ReLU top
    conv, channels whose pre-ReLU values are all negative (a ReLU-zero tie).
    Pooled within 1e-4, the sums (dbeta, dgamma) at rtol 5e-3 / atol 5e-4
    max|ref|."""
    plan, widths = _plan(kind)
    gp, ns = 96, 13 if case == "pad_slots" else NS
    x, flat, _ = _case(rng, plan, widths, gp, gp, True)
    x = x[:ns].copy()
    if case == "all_tied":
        x[:] = x[0:1]
    xt = torch.from_numpy(x)
    ft = [torch.from_numpy(f) for f in flat]
    folded, mus, isigs = [], [], []
    for j in range(len(widths)):
        w, b, g, be = ft[4 * j:4 * j + 4]
        st = tft.stats_pass.plain(xt, plan, folded, w, b, gp)
        mean, _, a, c, isig = tft._finalize_stats(st, float(ns * gp), g, be, 1e-3)
        if case == "relu_zero" and j == len(widths) - 1:
            c = c.clone()
            c[:8] -= 1e3
        folded.append((w, b, a, c))
        mus.append(mean)
        isigs.append(isig)
    dpool = rng.randn(gp, widths[-1]).astype(np.float32)
    pooled = tft.final_pass.plain(xt, plan, folded)
    sums = tft.bwd_top_pass.plain(xt, plan, folded, mus[-1], isigs[-1], torch.from_numpy(dpool))
    h, _ = tft._run_plan(xt, plan, folded, len(widths))
    cnt = tft._pool_and_ties(h)[1]
    if case == "all_tied":
        assert bool((cnt == ns).all())
    if case == "relu_zero":
        assert not pooled[:, :8].any() and bool((cnt[:, :8] == ns).all())
    want_pooled, want_sums = _jax_pool_passes(
        x, [tuple(t.numpy() for t in cv) for cv in folded], mus[-1].numpy(),
        isigs[-1].numpy(), dpool, plan, ns)
    assert np.abs(pooled.numpy() - want_pooled).max() <= 1e-4
    np.testing.assert_allclose(sums.numpy(), want_sums, rtol=5e-3,
                               atol=5e-4 * max(np.abs(want_sums).max(), 1e-3))


def test_plans_and_widths():
    for n in (1, 3):
        assert tft.detector_plan(n) == jft.detector_plan(n)
    for pre, mid in ((2, 1), (1, 2), (3, 3)):
        assert tft.descriptor_plan(pre, mid) == jft.descriptor_plan(pre, mid)
        w = tuple(range(4, 4 * (pre + mid) + 4, 4))
        assert tft.plan_conv_widths(tft.descriptor_plan(pre, mid), w, 3) == \
            jft.plan_conv_widths(jft.descriptor_plan(pre, mid), w, 3)


def test_training_convbn_matches_flax(rng):
    """ConvBN(training=True): output, the EMA batch_stats and the grads."""
    from feat3dnet_tpu.models.layers import ConvBN as JaxConvBN

    x = rng.randn(2, 12, 16, 8).astype(np.float32) * 2.0 + 0.5
    jmod = JaxConvBN(24)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    v = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), v)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.abs(a) + 0.5 if "var" in jax.tree_util.keystr(p) else a, v)
    cot = rng.randn(2, 12, 16, 24).astype(np.float32)

    def loss(params, x):
        y, mut = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                            training=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    mod = ConvBN(8, 24)
    load_variables(mod, jax.tree.map(np.asarray, v))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = mod(xt, training=True)
    (yt * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.bn.mean.numpy(), np.asarray(stats["bn"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.bn.var.numpy(), np.asarray(stats["bn"]["var"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mod.conv2d.weight.grad.numpy().T,
                               np.asarray(gp["conv2d"]["kernel"]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mod.bn.scale.grad.numpy(), np.asarray(gp["bn"]["scale"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mod.bn.bias.grad.numpy(), np.asarray(gp["bn"]["bias"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mod.conv2d.bias.grad.numpy(), np.asarray(gp["conv2d"]["bias"]),
                               atol=1e-3)


SMALL = dict(num_clusters=16, num_samples=8, feature_dim=16, base_scale=10.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))


@pytest.mark.parametrize("fused", [False, True])
def test_training_forward_matches_jax(rng, fused):
    """Feat3DNet(training=True) against Feat3DNet.apply(training=True,
    mutable=['batch_stats']): outputs and the new batch_stats."""
    clouds = rng.randn(6, 128, 3).astype(np.float32)
    jmodel = JaxFeat3DNet(JaxModelConfig(**SMALL, fused_towers=fused))
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clouds[:3]), training=False)
    want, mut = jmodel.apply(v, jnp.asarray(clouds), training=True, mutable=["batch_stats"])
    model = load_variables(Feat3DNet(ModelConfig(**SMALL, fused_towers=fused)),
                           jax.tree.map(np.asarray, v))
    got = model(torch.from_numpy(clouds), training=True)
    np.testing.assert_array_equal(got.keypoints.numpy(), np.asarray(want.keypoints))
    np.testing.assert_allclose(got.features.detach().numpy(), np.asarray(want.features),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.attention.detach().numpy(), np.asarray(want.attention),
                               rtol=1e-4, atol=1e-5)
    new = variables_from_module(model)["batch_stats"]
    flat_t = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), new))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(mut["batch_stats"]))
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_allclose(a, np.asarray(flat_j[path]), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
