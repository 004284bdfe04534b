"""Port serving path (ops/fused_describe, inference/serving) against JAX.

The plain version of kernel K3 is held against the JAX `_kernel_t` run in
Pallas interpret mode (rtol 1e-4 / atol 1e-5: the products are summed in
another order), and the (B, ns, 3) entry `fused_describe_clusters`
against JAX's (its `_kernel`) at the same limits in f32 and at
test_torch_modes.py's in bf16; the weight lists to rtol 1e-6; packing must
be equal.
The kernel itself is held against its plain version in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.inference import ClusterDescriptorServer as JaxServer
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu.ops import fused_describe as jfd
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.inference import ClusterDescriptorServer
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.ops import fused_describe as tfd
from feat3dnet_tpu_torch.utils import init_variables, load_variables

torch.set_num_threads(2)

SMALL = dict(num_samples=8, base_scale=1.0, detector_mlp=(32, 64),
             detector_mlp2=(32,), descriptor_mlp=(32, 32), feature_dim=16)



def _mixed_clusters(rng, b, ns):
    c = (rng.randn(b, ns, 3) * 0.8).astype(np.float32)
    c[5] += 5.0                                  # empty ball -> nearest fallback
    c[7, ns // 2:] = c[7, :ns // 2]              # duplicates -> first-min ties
    c[9, ns // 2:] += 4.0                        # partial ball
    c[11] = 9.0                                  # identical far points
    return c


def _setup(rng, kw, b=21):
    clusters = _mixed_clusters(rng, b, kw["num_samples"])
    jmodel = JaxFeat3DNet(JaxModelConfig(**kw))
    kp = jnp.zeros((b, 1, 3), jnp.float32)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clusters), training=False,
                    keypoints=kp)
    v = jax.tree.map(lambda x: x + 0.05 if x.ndim == 1 else x, v)
    return jmodel, jax.tree.map(np.asarray, v), clusters


def test_weight_lists_match_jax(rng):
    _, v, _ = _setup(rng, SMALL)
    jw = jfd.folded_weights(v, JaxModelConfig(**SMALL))
    tw = tfd.folded_weights(v, ModelConfig(**SMALL))
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    for a, b in zip(jfd.transpose_folded_weights(jw), tfd.transpose_folded_weights(tw)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_packing_matches_jax(rng):
    clusters = _mixed_clusters(rng, 13, 8)
    want = jfd.pack_clusters_lanes(clusters)
    np.testing.assert_array_equal(tfd.pack_clusters_lanes(clusters), want)
    np.testing.assert_array_equal(
        tfd.pack_clusters_lanes_torch(torch.from_numpy(clusters)).numpy(), want)
    np.testing.assert_array_equal(ClusterDescriptorServer.pack_clusters(clusters), want)


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, num_samples=16, base_scale=1.7)])
def test_plain_k3_matches_jax_kernel_t(rng, kw):
    """Mixed clusters (empty, tie, partial, full) at a batch (21) that is not
    a multiple of the JAX tile (8)."""
    _, v, clusters = _setup(rng, kw)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    packed = jfd.pack_clusters_lanes(clusters)
    with pltpu.force_tpu_interpret_mode():
        jd, ja = jfd.fused_describe_clusters_t(
            jfd.transpose_folded_weights(jfd.folded_weights(v, jcfg)),
            jnp.asarray(packed), jcfg, tile=8)
    n0 = tfd.fused_describe_clusters_t.launches
    td, ta = tfd.fused_describe_clusters_t(
        tfd.transpose_folded_weights(tfd.folded_weights(v, tcfg)),
        torch.from_numpy(packed), tcfg)
    assert tfd.fused_describe_clusters_t.launches == n0        # CPU: plain version
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)


def _close_bf16(td, ta, jd, ja):
    """K3's bf16 limits against JAX (test_torch_modes.py): descriptors within
    1e-5 and cosine >= 0.99999, attention rtol 1e-5 / atol 1e-7."""
    jd, ja = np.asarray(jd), np.asarray(ja)
    assert np.abs(td.numpy() - jd).max() <= 1e-5
    cos = (td.numpy() * jd).sum(1) / np.linalg.norm(jd, axis=1) / np.linalg.norm(td.numpy(), axis=1)
    assert cos.min() >= 0.99999
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("flag", [None, "bf16_matmul", "bf16_act"])
def test_fused_describe_clusters_matches_jax(rng, flag):
    """The (B, ns, 3) entry against JAX's `fused_describe_clusters` (its
    `_kernel`, interpret mode) on mixed clusters at a batch (21) off the JAX
    tile (8): f32 at rtol 1e-4 / atol 1e-5, bf16_matmul and bf16_act (both
    K3's bf16 mode) at the bf16 limits. On the CPU it is the plain K3 on
    the packed clusters, bit for bit."""
    _, v, clusters = _setup(rng, SMALL)
    jcfg, tcfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    kw = {} if flag is None else {flag: True}
    with pltpu.force_tpu_interpret_mode():
        jd, ja = jfd.fused_describe_clusters(jfd.folded_weights(v, jcfg),
                                             jnp.asarray(clusters), jcfg, tile=8, **kw)
    weights = tfd.folded_weights(v, tcfg)
    n0 = tfd.fused_describe_clusters_t.launches
    td, ta = tfd.fused_describe_clusters(weights, torch.from_numpy(clusters), tcfg, **kw)
    assert tfd.fused_describe_clusters_t.launches == n0        # CPU: plain version
    assert td.shape == (21, SMALL["feature_dim"]) and ta.shape == (21,)
    if flag is None:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    else:
        _close_bf16(td, ta, jd, ja)
    pd, pa = tfd.fused_describe_clusters_t(
        tfd.transpose_folded_weights(weights),
        torch.from_numpy(tfd.pack_clusters_lanes(clusters)), tcfg, bf16_act=flag is not None)
    assert torch.equal(td, pd) and torch.equal(ta, pa)


def test_fused_describe_clusters_checks_its_input(rng):
    cfg = ModelConfig(**SMALL)
    weights = tfd.folded_weights(init_variables(cfg, seed=1), cfg)
    with pytest.raises(ValueError, match="num_samples=8"):
        tfd.fused_describe_clusters(weights, torch.zeros(4, 16, 3), cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.fused_describe_clusters(weights, torch.empty(4, 8, 3, device="meta"), cfg)


def test_kernel_weight_table_layout(rng):
    """The flat buffer handed to K3 holds each layer as (Cin, Cout) then
    its bias, K-padded inputs cut to 4 rows (x, y, z, 0)."""
    cfg = ModelConfig(**SMALL)
    wt = tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(cfg, seed=1, bn_perturb=0.1), cfg))
    flat, table = tfd._kernel_weights(wt, cfg, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (len(wt) // 2, 4)
    for li, (cin, cout, w_off, b_off) in enumerate(table.tolist()):
        kt, b = wt[2 * li], wt[2 * li + 1]
        w = flat[w_off:w_off + cin * cout].reshape(cin, cout)
        np.testing.assert_array_equal(w.numpy(), kt.t()[:cin].numpy())
        if kt.shape[1] == 8:
            assert cin == 4 and not kt[:, 3:].any()
        np.testing.assert_array_equal(flat[b_off:b_off + cout].numpy(), b[:, 0].numpy())
    assert (table[:, 2] % 4 == 0).all()                     # float4-aligned blocks
    assert table[-1, 3].item() + table[-1, 1].item() <= flat.numel()
    bad = ModelConfig(**dict(SMALL, detector_mlp=(48, 64)))
    wbad = tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(bad, seed=1), bad))
    with pytest.raises(ValueError, match="per-slot layer"):
        tfd._kernel_weights(wbad, bad, torch.device("cpu"))


def test_server_matches_jax_server(rng):
    """CPU: both servers take their model path; describe_packed takes the
    plain K3 and agrees with it."""
    jmodel, v, clusters = _setup(rng, SMALL, b=12)
    jcfg, tcfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    jd, ja = JaxServer(jmodel, v, jcfg)(clusters)
    server = ClusterDescriptorServer(load_variables(Feat3DNet(tcfg), v), device="cpu")
    td, ta = server(clusters)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    pd, pa = server.describe_packed(server.pack_clusters(clusters))
    np.testing.assert_allclose(pd.numpy(), td.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pa.numpy(), ta.numpy(), rtol=1e-4, atol=1e-5)


def test_describe_packed_asserts_its_contract(rng):
    cfg = ModelConfig(**SMALL)
    server = ClusterDescriptorServer(load_variables(Feat3DNet(cfg), init_variables(cfg)),
                                     device="cpu")
    with pytest.raises(ValueError):
        server.describe_packed(np.zeros((8 * 4, 3), np.float32))      # ns 4 != 8
    nobn = ModelConfig(**SMALL, use_bn=False)
    server = ClusterDescriptorServer(load_variables(Feat3DNet(nobn), init_variables(nobn)),
                                     device="cpu")
    with pytest.raises(ValueError):
        server.describe_packed(np.zeros((8 * 8, 3), np.float32))
    d, a = server(_mixed_clusters(rng, 12, 8))             # no-BN: the model path
    assert d.shape == (12, 16) and a.shape == (12,)



def test_unfolded_detector_weights_match_jax(rng):
    _, v, _ = _setup(rng, SMALL)
    jw = jfd.detector_weights_unfolded(v, JaxModelConfig(**SMALL))
    tw = tfd.detector_weights_unfolded(v, ModelConfig(**SMALL))
    assert len(jw) == len(tw) == 5 * 3 + 4
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    for a, b in zip(jfd.transpose_unfolded_detector(jw), tfd.transpose_unfolded_detector(tw)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("source", ["mixed", "ball_query"])
def test_plain_k6_matches_jax_detect_2d(rng, source):
    """K6's plain version against the JAX detector-only kernel
    (fused_detect_clusters_2d, unfolded=True, Pallas interpret mode):
    attention within rtol 1e-5, orientation within 1e-5 rad. The
    ball-query clusters are what the extraction feeds it: repeat-padded
    offsets from the sorted ball query."""
    kw = dict(SMALL, base_scale=2.0)
    _, v, clusters = _setup(rng, kw)
    if source == "ball_query":
        from feat3dnet_tpu_torch.ops import hash_grid as thg

        xyz = ((rng.rand(300, 3) - 0.5) * 10).astype(np.float32)
        sc = thg.build_sorted_cloud_host(xyz, cell_size=2.0, block_size=32)
        ctr = torch.from_numpy(sc.pts4[:, :3])
        grouped, _, _ = thg.ball_query_grouped_sorted(sc.to("cpu"), ctr, 2.0, 8, tile=16)
        clusters = (grouped - ctr[:, None, :]).numpy()[:300]
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    ja, jo = jfd.fused_detect_clusters_2d(jfd.detector_weights_unfolded(v, jcfg),
                                          jnp.asarray(clusters), jcfg, tile=8, unfolded=True)
    n0 = tfd.fused_detect_clusters.launches
    wt = tfd.transpose_unfolded_detector(tfd.detector_weights_unfolded(v, tcfg))
    ta, to = tfd.fused_detect_clusters(wt, torch.from_numpy(clusters), tcfg, unfolded=True)
    assert tfd.fused_detect_clusters.launches == n0        # CPU: plain version
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-7)
    d = to.numpy() - np.asarray(jo)
    assert np.abs((d + np.pi) % (2 * np.pi) - np.pi).max() <= 1e-5
    # chunking changes only the matmuls' blocking (last-ulp differences)
    ca, _ = tfd.fused_detect_clusters_plain(wt, torch.from_numpy(clusters), tcfg, unfolded=True,
                                            chunk=7)
    np.testing.assert_allclose(ca.numpy(), ta.numpy(), rtol=1e-6)


def test_k6_weight_table_layout(rng):
    """K6's flat buffer: (Cin, Cout) kernel, bias, then mean, mul, bn_bias
    per conv (-1 for the heads), 16-byte aligned; first layer cut to 4
    input rows; after them the top per-slot conv's tensor-core fragments
    and column norms, the only offsets of the second table."""
    cfg = ModelConfig(**SMALL)
    wt = tfd.transpose_unfolded_detector(
        tfd.detector_weights_unfolded(init_variables(cfg, seed=1, bn_perturb=0.1), cfg))
    flat, table, extra = tfd._detect_kernel_weights(wt, cfg, torch.device("cpu"), unfolded=True)
    top = len(cfg.detector_mlp) - 1
    assert extra.shape == (table.shape[0], 2) and extra.dtype == torch.int32
    assert (extra[top] > table[:, 2:].max()).all() and (extra[top] % 4 == 0).all()
    assert (torch.cat([extra[:top], extra[top + 1:]]) == -1).all()
    convs, heads = tfd._detector_layers(wt, cfg, unfolded=True)
    assert table.shape == (len(convs) + 2, 7) and table.dtype == torch.int32
    for row, layer in zip(table.tolist(), list(convs) + list(heads)):
        cin, cout, w_off = row[:3]
        k = layer[0]
        np.testing.assert_array_equal(flat[w_off:w_off + cin * cout].reshape(cin, cout).numpy(),
                                      k.t()[:cin].numpy())
        for off, vec in zip(row[3:], layer[1:]):
            np.testing.assert_array_equal(flat[off:off + cout].numpy(), vec[:, 0].numpy())
        assert all(o % 4 == 0 for o in row[2:] if o >= 0)
    assert table[0, 0].item() == 4 and (table[-2:, 4:] == -1).all()
    with pytest.raises(ValueError, match="weight tensors"):
        tfd.fused_detect_clusters(wt[:-1], torch.zeros(2, 8, 3), cfg, unfolded=True)
