"""Port serving path (ops/fused_describe, inference/serving) against JAX.

The plain version of kernel K3 is held against the JAX `_kernel_t` run in
Pallas interpret mode (rtol 1e-4 / atol 1e-5: the products are summed in
another order); the weight lists to rtol 1e-6; packing must be equal.
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
    server = ClusterDescriptorServer(load_variables(Feat3DNet(tcfg), v))
    td, ta = server(clusters)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    pd, pa = server.describe_packed(server.pack_clusters(clusters))
    np.testing.assert_allclose(pd.numpy(), td.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pa.numpy(), ta.numpy(), rtol=1e-4, atol=1e-5)


def test_describe_packed_asserts_its_contract(rng):
    cfg = ModelConfig(**SMALL)
    server = ClusterDescriptorServer(load_variables(Feat3DNet(cfg), init_variables(cfg)))
    with pytest.raises(ValueError):
        server.describe_packed(np.zeros((8 * 4, 3), np.float32))      # ns 4 != 8
    nobn = ModelConfig(**SMALL, use_bn=False)
    server = ClusterDescriptorServer(load_variables(Feat3DNet(nobn), init_variables(nobn)))
    with pytest.raises(ValueError):
        server.describe_packed(np.zeros((8 * 8, 3), np.float32))
    d, a = server(_mixed_clusters(rng, 12, 8))             # no-BN: the model path
    assert d.shape == (12, 16) and a.shape == (12,)

