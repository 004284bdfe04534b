"""`ModelConfig.compute_dtype` in the port against the JAX model, on the CPU.

Both packages get the same numpy-seeded weights (utils/init.py, BN
perturbed) through the weight bridge, on the SMALL config of
tests/test_model.py, and the same numpy clouds.

* Eval in bf16: outputs f32; JAX's own gate against f32 (cosine > 0.98 on
  > 90 % of descriptors); port-bf16 against JAX-bf16 max |Δdescriptor|
  at least 10x under port-f32 against JAX-bf16 (the control: the port
  reproduces the bf16 roundings instead of staying near f32). Measured:
  1.2e-7 against 4.3e-3, attention within one bf16 ulp (softplus rounds
  at other points in JAX's bf16 composite), so 2 ulps are allowed.
* One training forward and backward in bf16 (the autograd route) against
  JAX's eager grads: loss rtol 1e-3 (measured 8.4e-5; port-f32 is 1.6e-2
  away); cosine >= 0.99 per leaf (measured >= 0.9995), except the leaves
  whose grad is analytically zero (a shift the next BN removes), which
  carry rounding noise; the control, port-f32, falls below 0.99 on some
  leaf (measured 0.47). BN buffers stay f32, move, and match JAX's
  within rtol 2e-3 / atol 2e-5 (measured 6.6e-6 abs, 4.3e-4 relative, on
  the last conv, whose moments sum bf16 values that rounded apart).
* `cli.train --compute_dtype bfloat16` trains 2 steps.
* The f32 default casts nothing: a model moved to float64 (the float64
  reference grads of the card checks) computes and differentiates in
  float64.
"""
import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu.train.loss import alignment_triplet_loss as jax_loss
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.train import alignment_triplet_loss
from feat3dnet_tpu_torch.utils import init_variables, load_variables

torch.set_num_threads(2)

SMALL = dict(num_clusters=16, num_samples=8, feature_dim=16, base_scale=10.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _variables(seed=0):
    return init_variables(ModelConfig(**SMALL), seed=seed, bn_perturb=0.1)


def _port(v, dt):
    return load_variables(Feat3DNet(ModelConfig(**SMALL, compute_dtype=DTYPES[dt][0])), v)


def _jax(dt):
    return JaxFeat3DNet(JaxModelConfig(**SMALL, compute_dtype=DTYPES[dt][1]))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def test_eval_bf16_matches_jax(rng):
    cloud = (rng.randn(2, 128, 6) * 3.0).astype(np.float32)
    v = _variables()
    want = _jax("bf16").apply(v, jnp.asarray(cloud), training=False)
    with torch.no_grad():
        got = {dt: _port(v, dt).eval()(torch.from_numpy(cloud)) for dt in DTYPES}
    g16, g32 = got["bf16"], got["f32"]
    assert g16.features.dtype == g16.attention.dtype == g16.orientation.dtype == torch.float32
    f16, f32, w16 = g16.features.numpy(), g32.features.numpy(), np.asarray(want.features)
    assert np.mean(np.sum(f16 * f32, -1) > 0.98) > 0.9            # JAX's own gate
    err16, err32 = np.abs(f16 - w16).max(), np.abs(f32 - w16).max()
    assert err32 > 0 and err16 * 10 <= err32, (err16, err32)
    wa = np.asarray(want.attention)
    assert np.all(np.abs(g16.attention.numpy() - wa) <= 2 * _bf16_ulp(wa))
    d = g16.orientation.numpy() - np.asarray(want.orientation)
    assert np.abs((d + np.pi) % (2 * np.pi) - np.pi).max() <= 1e-2


def _jax_grads(dt, v, clouds):
    model = _jax(dt)

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                               jnp.asarray(clouds), training=True, mutable=["batch_stats"])
        fa, fp, fn = jnp.split(out.features, 3, axis=0)
        att = jnp.split(out.attention, 3, axis=0)[0]
        return jax_loss(fa, fp, fn, att, 1.0)[0], mut

    (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    return float(loss), _flat(grads), _flat(mut["batch_stats"])


def _port_step(dt, v, clouds):
    model = _port(v, dt)
    out = model(torch.from_numpy(clouds), training=True)
    fa, fp, fn = torch.chunk(out.features, 3)
    loss, _ = alignment_triplet_loss(fa, fp, fn, torch.chunk(out.attention, 3)[0], 1.0)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        *scope, leaf = name.split(".")
        g = p.grad.numpy()
        grads["/".join(scope + ["kernel" if leaf == "weight" else leaf])] = \
            g.T if leaf == "weight" else g
    return loss.item(), grads, model


def _cos(a, b):
    return float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_train_bf16_matches_jax_eager_grads(rng):
    a = (rng.randn(2, 128, 3) * 3.0).astype(np.float32)
    clouds = np.concatenate([a, a + 0.01 * rng.randn(*a.shape),
                             a + 0.2 * rng.randn(*a.shape)]).astype(np.float32)
    v = _variables()
    jloss, jgrads, jstats = _jax_grads("bf16", v, clouds)
    _, g32_jax, _ = _jax_grads("f32", v, clouds)
    top = max(np.abs(g).max() for g in g32_jax.values())
    noise = {k for k, g in g32_jax.items() if np.abs(g).max() <= 1e-4 * top}
    assert {k for k in g32_jax if k.endswith("conv2d/bias")} <= noise
    loss16, g16, model = _port_step("bf16", v, clouds)
    loss32, g32, _ = _port_step("f32", v, clouds)
    np.testing.assert_allclose(loss16, jloss, rtol=1e-3)
    assert abs(loss32 - jloss) > 1e-3 * jloss                    # bf16 moved the loss
    assert g16.keys() == jgrads.keys()
    cos16 = {k: _cos(g16[k], jgrads[k]) for k in jgrads if k not in noise}
    cos32 = {k: _cos(g32[k], jgrads[k]) for k in jgrads if k not in noise}
    assert min(cos16.values()) >= 0.99, min(cos16.items(), key=lambda kv: kv[1])
    assert min(cos32.values()) < 0.99                            # the control
    init = _flat(v["batch_stats"])
    for scope in ("detection", "description"):
        for name, blk in getattr(model, scope).named_children():
            if getattr(blk, "bn", None) is None:
                continue
            for buf in ("mean", "var"):
                t = getattr(blk.bn, buf)
                key = f"{scope}/{name}/bn/{buf}"
                assert t.dtype == torch.float32, key
                assert not np.array_equal(t.numpy(), init[key]), key
                np.testing.assert_allclose(t.numpy(), jstats[key], rtol=2e-3, atol=2e-5,
                                           err_msg=key)


def test_cli_train_bf16(tmp_path):
    from feat3dnet_tpu_torch.cli import train

    rs = np.random.RandomState(3)
    (tmp_path / "data" / "train").mkdir(parents=True)
    lines = []
    for i in range(4):
        (rs.randn(200, 6) * 3.0).astype(np.float32).tofile(
            str(tmp_path / "data" / "train" / f"c{i}.bin"))
        lines.append(f"c{i}.bin | {(i + 1) % 4} | {(i + 2) % 4}")
    (tmp_path / "data" / "train" / "train.txt").write_text("\n".join(lines) + "\n")
    state = train.main(["--data_dir", str(tmp_path / "data"), "--log_dir", str(tmp_path / "log"),
                        "--num_points", "64", "--num_clusters", "8", "--num_samples", "8",
                        "--batch_size", "2", "--num_epochs", "1", "--summary_every_n_steps",
                        "1", "--device", "cpu", "--fused_towers", "--compute_dtype", "bfloat16"])
    assert state.step == 2
    assert state.model.cfg.compute_dtype is torch.bfloat16
    assert state.model.detection.conv0.conv2d.weight.dtype == torch.float32
    rows = [json.loads(x) for x in open(tmp_path / "log" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_float32_default_keeps_a_float64_model_in_float64(rng):
    model = _port(_variables(), "f32").double()
    grouped = torch.from_numpy(rng.randn(2, 16, 8, 3)).requires_grad_(True)
    att, ori = model.detection(grouped, True)
    feat = model.description(grouped, True)
    assert att.dtype == ori.dtype == feat.dtype == torch.float64
    (att.sum() + feat.sum()).backward()
    assert grouped.grad.dtype == torch.float64
    assert model.detection.conv0.conv2d.weight.grad.dtype == torch.float64
