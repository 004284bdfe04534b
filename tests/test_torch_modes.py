"""The modes of kernels K3 and K6 (ops/fused_describe.py) against JAX, and
the port's profiling helpers (utils/profiling.py).

K3's bf16 activations: the plain version against `_kernel_t(bf16_act)`,
`_kernel_2d(bf16_act)`, `_kernel(bf16_act)` and `_kernel(bf16_matmul)`,
all in Pallas interpret mode. The products are exact in f32 on both sides
(bf16 x bf16), so only the order of the f32 sums differs; where that flips
a bf16 rounding of an activation the result moves by about one bf16 step
(2^-8). At these sizes no rounding flips (measured: descriptors within
9e-8, attention 1.1e-7 relative), so the tolerances are 1e-5 for both and
cosine >= 0.99999. The decomposition bodies (`_ablate_kernel_t` and
`_ablate_kernel_2d`): `stream` exact; `matmul` and `matmul_2d` round their
pooled convs' operands to TF32, as the kernel does, so they are held to
JAX's f32 bodies within `ABLATE_F32_LIMIT` (2^-9) of max|ref| (measured
2.9e-4 - 7.1e-4; in f32 they read 8.6e-7 and 6.9e-7, and
tests/test_torch_k3_bodies.py holds the rounding's placement to 1e-5). K6 folded and bf16_operands:
attention rtol 1e-5, orientation 1e-5 rad, K6's f32 tolerances (measured
4.7e-7 / 4.8e-7 rad folded, 1.3e-7 / 2.4e-7 rad bf16_operands). The
kernels themselves are held against these plain versions in
test_torch_cuda.py.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.ops import fused_describe as jfd
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.inference import ClusterDescriptorServer
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.ops import fused_describe as tfd
from feat3dnet_tpu_torch.utils import init_variables, load_variables, profiling
from tests.test_torch_fused_describe import SMALL, _close_bf16, _mixed_clusters, _setup

torch.set_num_threads(2)


def _k3_case(rng, kw):
    _, v, clusters = _setup(rng, kw)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    packed = jfd.pack_clusters_lanes(clusters)
    wt = tfd.transpose_folded_weights(tfd.folded_weights(v, tcfg))
    return v, clusters, jcfg, tcfg, packed, wt


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, num_samples=16, base_scale=1.7)])
def test_plain_k3_bf16_matches_jax_kernel_t(rng, kw):
    v, _, jcfg, tcfg, packed, wt = _k3_case(rng, kw)
    with pltpu.force_tpu_interpret_mode():
        jd, ja = jfd.fused_describe_clusters_t(
            jfd.transpose_folded_weights(jfd.folded_weights(v, jcfg)), jnp.asarray(packed),
            jcfg, tile=8, bf16_act=True)
    n0 = dict(tfd.fused_describe_clusters_t.mode_launches)
    td, ta = tfd.fused_describe_clusters_t(wt, torch.from_numpy(packed), tcfg, bf16_act=True)
    assert tfd.fused_describe_clusters_t.mode_launches == n0     # CPU: plain version
    _close_bf16(td, ta, jd, ja)


@pytest.mark.parametrize("layout,flag", [("2d", "bf16_act"), ("rank3", "bf16_act"),
                                         ("rank3", "bf16_matmul")])
def test_plain_k3_bf16_matches_jax_other_layouts(rng, layout, flag):
    """`_kernel_2d` and `_kernel` in bf16: their bf16_matmul rounds each
    product's operands where bf16_act stores bf16 activations, the same
    values since rounding commutes with ReLU and max."""
    v, clusters, jcfg, tcfg, packed, wt = _k3_case(rng, SMALL)
    fn = jfd.fused_describe_clusters_2d if layout == "2d" else jfd.fused_describe_clusters
    with pltpu.force_tpu_interpret_mode():
        jd, ja = fn(jfd.folded_weights(v, jcfg), jnp.asarray(clusters), jcfg, tile=8,
                    **{flag: True})
    td, ta = tfd.fused_describe_clusters_t_plain(wt, torch.from_numpy(packed), tcfg,
                                                 bf16_act=True)
    _close_bf16(td, ta, jd, ja)


def test_plain_k3_bf16_close_to_f32(rng):
    """The bound of tests/test_fused_describe.py::test_fused_bf16_act_close_to_f32."""
    kw = dict(SMALL, num_samples=16)
    _, _, _, tcfg, packed, wt = _k3_case(rng, kw)
    x = torch.from_numpy(packed)
    d32, a32 = tfd.fused_describe_clusters_t_plain(wt, x, tcfg)
    d16, a16 = tfd.fused_describe_clusters_t_plain(wt, x, tcfg, bf16_act=True)
    assert torch.nn.functional.cosine_similarity(d32, d16, dim=1).min().item() > 0.995
    assert not torch.equal(d32, d16)
    np.testing.assert_allclose(a16.numpy(), a32.numpy(), rtol=0.02, atol=1e-4)


@pytest.mark.parametrize("layout,ablate,ours", [("t", "stream", "stream"),
                                                ("t", "matmul", "matmul"),
                                                ("2d", "stream", "stream"),
                                                ("2d", "matmul", "matmul_2d")])
def test_plain_k3_ablate_matches_jax(rng, layout, ablate, ours):
    """The decomposition bodies against `_ablate_kernel_t` and
    `_ablate_kernel_2d`. Both stream bodies compute desc = x, att = y of
    slot 0 (exact). `_ablate_kernel_2d`'s matmul body, K3's 'matmul_2d',
    takes each pool as slot 0's row and feeds the mid conv [d | d], another
    function than 'matmul'. The matmul bodies take TF32-rounded operands in
    their two pooled convs (the kernel's tiles) and JAX's sum in f32: within
    ABLATE_F32_LIMIT of max|ref|, the rounding's bound (tfd.ABLATE_F32_LIMIT)."""
    v, clusters, jcfg, tcfg, packed, wt = _k3_case(rng, dict(SMALL, num_samples=16))
    with pltpu.force_tpu_interpret_mode():
        if layout == "t":
            jd, ja = jfd.fused_describe_clusters_t(
                jfd.transpose_folded_weights(jfd.folded_weights(v, jcfg)), jnp.asarray(packed),
                jcfg, tile=8, ablate=ablate)
        else:
            jd, ja = jfd.fused_describe_clusters_2d(jfd.folded_weights(v, jcfg),
                                                    jnp.asarray(clusters), jcfg, tile=8,
                                                    ablate=ablate)
    jd, ja = np.asarray(jd), np.asarray(ja)
    x = torch.from_numpy(packed)
    td, ta = tfd.fused_describe_clusters_t(wt, x, tcfg, ablate=ours)
    assert td.shape == jd.shape and ta.shape == ja.shape
    if ablate == "stream":
        np.testing.assert_array_equal(td.numpy(), jd)
        np.testing.assert_array_equal(ta.numpy(), ja)
    else:
        limit = tfd.ABLATE_F32_LIMIT
        assert np.abs(td.numpy() - jd).max() <= limit * np.abs(jd).max()
        assert np.abs(ta.numpy() - ja).max() <= limit * np.abs(ja).max()
    if ours == "matmul_2d":
        md, _ = tfd.fused_describe_clusters_t_plain(wt, x, tcfg, ablate="matmul")
        assert np.abs(md.numpy() - jd).max() > 1e-2 * np.abs(jd).max()


def test_k3_mode_arguments_are_checked(rng):
    cfg = ModelConfig(**SMALL)
    wt = tfd.transpose_folded_weights(tfd.folded_weights(init_variables(cfg, seed=1), cfg))
    x = torch.from_numpy(tfd.pack_clusters_lanes(_mixed_clusters(rng, 12, 8)))
    for fn in (tfd.fused_describe_clusters_t, tfd.fused_describe_clusters_t_plain):
        with pytest.raises(ValueError, match="ablate must be"):
            fn(wt, x, cfg, ablate="vpu")
        with pytest.raises(ValueError, match="exclude each other"):
            fn(wt, x, cfg, bf16_act=True, ablate="matmul")


def test_k3_bf16_weight_buffer_is_bf16(rng):
    """In bf16 mode the kernel matrices handed to K3 are bf16 values; the
    biases stay f32 and the table is the f32 mode's."""
    cfg = ModelConfig(**SMALL)
    wt = tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(cfg, seed=1, bn_perturb=0.1), cfg))
    f32, table = tfd._kernel_weights(wt, cfg, torch.device("cpu"))
    bf, table_bf = tfd._kernel_weights(wt, cfg, torch.device("cpu"), bf16=True)
    assert torch.equal(table, table_bf)
    for cin, cout, w_off, b_off in table.tolist():
        w = bf[w_off:w_off + cin * cout]
        assert torch.equal(w, w.to(torch.bfloat16).float())
        assert torch.equal(w, f32[w_off:w_off + cin * cout].to(torch.bfloat16).float())
        assert torch.equal(bf[b_off:b_off + cout], f32[b_off:b_off + cout])
    assert not torch.equal(bf, f32)


def test_bf16_server(rng):
    """describe_packed runs K3's bf16 mode (the plain version on the CPU);
    __call__ takes the f32 model path, as the JAX server off the TPU."""
    _, v, clusters = _setup(rng, SMALL, b=12)
    tcfg = ModelConfig(**SMALL)
    server = ClusterDescriptorServer(load_variables(Feat3DNet(tcfg), v), device="cpu",
                                     bf16_act=True)
    f32_server = ClusterDescriptorServer(load_variables(Feat3DNet(tcfg), v), device="cpu")
    packed = server.pack_clusters(clusters)
    pd, pa = server.describe_packed(packed)
    wd, wa = tfd.fused_describe_clusters_t_plain(
        tfd.transpose_folded_weights(tfd.folded_weights(v, tcfg)), torch.from_numpy(packed),
        tcfg, bf16_act=True)
    assert torch.equal(pd, wd) and torch.equal(pa, wa)
    fd_, fa = f32_server.describe_packed(packed)
    assert not torch.equal(pd, fd_)
    td, ta = server(clusters)
    md, ma = f32_server._model_path(torch.from_numpy(clusters))
    assert torch.equal(td, md) and torch.equal(ta, ma)


@pytest.mark.parametrize("source", ["mixed", "ball_query"])
def test_plain_k6_folded_matches_jax(rng, source):
    """K6's default (folded) mode against fused_detect_clusters_2d(
    folded_weights(v), unfolded=False); the whole folded list and its
    detector prefix give the same result."""
    kw = dict(SMALL, base_scale=1.7)
    _, v, clusters = _setup(rng, kw)
    if source == "ball_query":
        from feat3dnet_tpu_torch.ops import hash_grid as thg

        xyz = ((rng.rand(300, 3) - 0.5) * 10).astype(np.float32)
        sc = thg.build_sorted_cloud_host(xyz, cell_size=1.7, block_size=32)
        ctr = torch.from_numpy(sc.pts4[:, :3])
        grouped, _, _ = thg.ball_query_grouped_sorted(sc.to("cpu"), ctr, 1.7, 8, tile=16)
        clusters = (grouped - ctr[:, None, :]).numpy()[:300]
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    with pltpu.force_tpu_interpret_mode():
        ja, jo = jfd.fused_detect_clusters_2d(jfd.folded_weights(v, jcfg),
                                              jnp.asarray(clusters), jcfg, tile=8)
    wt = tfd.transpose_folded_weights(tfd.folded_weights(v, tcfg))
    n0 = dict(tfd.fused_detect_clusters.mode_launches)
    ta, to = tfd.fused_detect_clusters(wt, torch.from_numpy(clusters), tcfg)
    assert tfd.fused_detect_clusters.mode_launches == n0          # CPU: plain version
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-7)
    d = to.numpy() - np.asarray(jo)
    assert np.abs((d + np.pi) % (2 * np.pi) - np.pi).max() <= 1e-5
    pa, po = tfd.fused_detect_clusters_plain(wt[:10], torch.from_numpy(clusters), tcfg)
    assert torch.equal(pa, ta) and torch.equal(po, to)


def test_plain_k6_bf16_operands_matches_jax(rng):
    kw = dict(SMALL, base_scale=2.0, num_samples=16)
    _, v, clusters = _setup(rng, kw)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    with pltpu.force_tpu_interpret_mode():
        ja, jo = jfd.fused_detect_clusters_2d(jfd.detector_weights_unfolded(v, jcfg),
                                              jnp.asarray(clusters), jcfg, tile=8,
                                              unfolded=True, bf16_operands=True)
    wt = tfd.transpose_unfolded_detector(tfd.detector_weights_unfolded(v, tcfg))
    ta, to = tfd.fused_detect_clusters(wt, torch.from_numpy(clusters), tcfg, unfolded=True,
                                       bf16_operands=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-7)
    d = to.numpy() - np.asarray(jo)
    assert np.abs((d + np.pi) % (2 * np.pi) - np.pi).max() <= 1e-5
    fa, _ = tfd.fused_detect_clusters(wt, torch.from_numpy(clusters), tcfg, unfolded=True)
    assert not torch.equal(fa, ta)


def test_k6_mode_arguments_are_checked(rng):
    cfg = ModelConfig(**SMALL)
    v = init_variables(cfg, seed=1, bn_perturb=0.1)
    unf = tfd.transpose_unfolded_detector(tfd.detector_weights_unfolded(v, cfg))
    fol = tfd.transpose_folded_weights(tfd.folded_weights(v, cfg))
    x = torch.from_numpy(_mixed_clusters(rng, 12, 8))
    for fn in (tfd.fused_detect_clusters, tfd.fused_detect_clusters_plain):
        with pytest.raises(ValueError, match="bf16_operands needs unfolded"):
            fn(unf, x, cfg, bf16_operands=True)
        with pytest.raises(ValueError, match="weight tensors"):
            fn(unf, x, cfg)                      # an unfolded list in the folded mode
        with pytest.raises(ValueError, match="weight tensors"):
            fn(fol, x, cfg, unfolded=True)
    flat, table, _ = tfd._detect_kernel_weights(fol, cfg, torch.device("cpu"), unfolded=False)
    assert (table[:, 4:] == -1).all() and table.shape == (5, 7)
    bf, table_bf, _ = tfd._detect_kernel_weights(unf, cfg, torch.device("cpu"), unfolded=True,
                                                 bf16=True)
    for cin, cout, w_off, *_ in table_bf.tolist():
        w = bf[w_off:w_off + cin * cout]
        assert torch.equal(w, w.to(torch.bfloat16).float())


def test_timed_device_call_returns_a_positive_median():
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"sum": a + b, "rest": (a * b,)}

    t = profiling.timed_device_call(fn, torch.ones(64, 64), torch.ones(64, 64), repeats=3)
    assert t > 0 and len(calls) == 4                         # one warm-up, three timed


def test_device_trace_writes_a_trace(tmp_path):
    """The trace holds every thread: the prefetch thread's upload span too."""
    from feat3dnet_tpu_torch.data.datagenerator import prefetch

    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
        fed = list(prefetch(iter([np.ones((2, 3), np.float32)]), transform=torch.from_numpy))
    assert len(fed) == 1
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".json") and files[0].stat().st_size > 0
    assert any("matmul" in e.key or "mm" in e.key for e in prof.key_averages())
    events = json.loads(files[0].read_text())["traceEvents"]
    main = next(e["tid"] for e in events if e.get("name") == "aten::matmul")
    assert [e["tid"] != main for e in events if e.get("name") == "f3d.data.upload"] == [True]
