"""The rest of the point-op API of the port against the JAX package.

Inputs are numpy arrays from a seed and go through both packages:
per-centre radii through the ball query (its plain version, `ball_query`
and `ball_query_fused` on CPU tensors; kernel K2's per-centre form is held
against the plain version on a card in test_torch_cuda.py), `knn_points`,
`prob_sample`, the pointnet wrappers, `FullyConnected` and `dropout`.

Contracts: ball query and kNN index-exact (kNN's dist2 equal);
`prob_sample` index-exact on dyadic weights, and on random float32 weights
at most 1e-3 of the draws one index over, each with its target within
4 ulp of the row total of the boundary it crossed (the cumsums sum in
different orders); the pointnet wrappers' centres, idx and cnt exact,
grouped within 1e-6; `FullyConnected` within rtol 1e-5, atol 1e-6
(outputs and BN's running statistics); `dropout` by its contract (JAX's
bernoulli and torch's generator draw different bits).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.models.layers import FullyConnected as JaxFullyConnected
from feat3dnet_tpu.models.layers import dropout as jax_dropout
from feat3dnet_tpu.ops.neighborhoods import ball_query as jax_ball_query
from feat3dnet_tpu.ops.neighborhoods import knn_points as jax_knn_points
from feat3dnet_tpu.ops.pointnet import (sample_and_group as jax_sample_and_group,
                                        sample_and_group_all as jax_sample_and_group_all,
                                        sample_points as jax_sample_points)
from feat3dnet_tpu.ops.sampling import prob_sample as jax_prob_sample
from feat3dnet_tpu_torch import ops
from feat3dnet_tpu_torch.models.layers import FullyConnected, dropout
from feat3dnet_tpu_torch.ops.batch_group import ball_query_fused
from feat3dnet_tpu_torch.ops.neighborhoods import ball_query_plain
from feat3dnet_tpu_torch.utils.convert import load_variables, variables_from_module

torch.set_num_threads(2)


def _radii_case(name, rng):
    """(xyz, centers, radii (B, M), ns, mask)."""
    if name == "mixed":
        xyz = rng.randn(2, 300, 3).astype(np.float32) * 2.0
        return xyz, xyz[:, ::10].copy(), rng.uniform(0.3, 2.5, (2, 30)).astype(np.float32), \
            12, None
    if name == "mask":
        xyz = rng.randn(2, 256, 3).astype(np.float32) * 1.5
        ctr = np.concatenate([xyz[:, :12], xyz[:, 12:16] + 25.0], axis=1)
        return xyz, ctr, rng.uniform(0.5, 2.0, (2, 16)).astype(np.float32), 10, \
            rng.rand(2, 256) > 0.3
    if name == "duplicates":
        base = rng.randn(1, 80, 3).astype(np.float32)
        xyz = np.concatenate([base, base, base[:, :40]], axis=1)
        return xyz, base[:, ::4].copy(), rng.uniform(0.2, 1.5, (1, 20)).astype(np.float32), \
            16, None
    if name == "zero_nan_negative":
        xyz = rng.randn(1, 200, 3).astype(np.float32)
        radii = rng.uniform(0.5, 1.5, (1, 12)).astype(np.float32)
        radii[0, 0] = 0.0
        radii[0, 1] = np.nan
        radii[0, 2] = -radii[0, 3]
        radii[0, 4] = -1e-3
        radii[0, 5] = 1e3
        return xyz, xyz[:, ::17][:, :12].copy(), radii, 8, None
    if name == "at_radius":
        # each centre's own point at exactly d2 == r2 (dyadic radii, exact
        # squares), which the strict test leaves out
        radii = np.float32([[0.5, 0.75, 1.5, 2.0]])
        ctr = np.zeros((1, 4, 3), np.float32)
        ctr[0, :, 1] = np.arange(4) * 10.0
        on = ctr[0].copy()
        on[:, 0] += radii[0]
        inside = ctr[0] + np.float32([0.0, 0.0, 0.25])
        return np.concatenate([on, inside])[None], ctr, radii, 4, None
    # JAX's test_ball_query_per_center_radii: all radii equal
    xyz = rng.rand(1, 100, 3).astype(np.float32)
    return xyz, rng.rand(1, 10, 3).astype(np.float32), np.full((1, 10), 0.3, np.float32), 8, \
        None


RADII_CASES = ["mixed", "mask", "duplicates", "zero_nan_negative", "at_radius", "equal"]


@pytest.mark.parametrize("case", RADII_CASES)
def test_ball_query_per_centre_radii_match_jax(rng, case):
    xyz, ctr, radii, ns, mask = _radii_case(case, rng)
    want_idx, want_cnt = jax_ball_query(jnp.asarray(xyz), jnp.asarray(ctr), jnp.asarray(radii),
                                        ns, valid_mask=None if mask is None else jnp.asarray(mask))
    args = (torch.from_numpy(xyz), torch.from_numpy(ctr), torch.from_numpy(radii), ns,
            None if mask is None else torch.from_numpy(mask))
    n0 = ball_query_fused.launches
    for fn in (ball_query_plain, ops.ball_query, ball_query_fused):
        idx, cnt = fn(*args)
        assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert ball_query_fused.launches == n0                  # CPU: the plain version
    if case == "equal":
        idx_s, cnt_s = ops.ball_query(args[0], args[1], 0.3, ns)
        np.testing.assert_array_equal(idx.numpy(), idx_s.numpy())
        np.testing.assert_array_equal(cnt.numpy(), cnt_s.numpy())
    if case == "at_radius":
        np.testing.assert_array_equal(cnt.numpy(), [[1, 1, 1, 1]])
        np.testing.assert_array_equal(idx.numpy()[0, :, 0], [4, 5, 6, 7])
    if case == "zero_nan_negative":
        c = cnt.numpy()[0]
        assert c[0] == 0 and c[1] == 0 and c[4] == 1 and c[5] == ns   # c[4]: its own point
        i = idx.numpy()[0]
        assert (i[0] == i[0, 0]).all() and (i[1] == i[1, 0]).all()


def test_ball_query_negative_radius_is_its_absolute_value(rng):
    xyz, ctr, radii, ns, _ = _radii_case("mixed", rng)
    x, c = torch.from_numpy(xyz), torch.from_numpy(ctr)
    pos, neg = ops.ball_query(x, c, torch.from_numpy(radii), ns), \
        ops.ball_query(x, c, torch.from_numpy(-radii), ns)
    assert torch.equal(pos[0], neg[0]) and torch.equal(pos[1], neg[1])


def test_ball_query_scalar_radius_forms_agree(rng):
    xyz, ctr, _, ns, _ = _radii_case("mixed", rng)
    x, c = torch.from_numpy(xyz), torch.from_numpy(ctr)
    want = ops.ball_query(x, c, 1.2, ns)
    for r in (torch.tensor(1.2), np.float32(1.2), np.array(1.2)):
        got = ops.ball_query(x, c, r, ns)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("radius,err", [
    (torch.ones(2, 7), ValueError),                            # not (B, M)
    (torch.ones(2, 30, dtype=torch.float64), ValueError),      # not the cloud's dtype
    (torch.ones(2, 30, 1), ValueError),
    ([1.0, 2.0], TypeError),
    ("1.0", TypeError),
])
def test_ball_query_refuses_other_radii(rng, radius, err):
    xyz, ctr, _, ns, _ = _radii_case("mixed", rng)
    with pytest.raises(err):
        ops.ball_query(torch.from_numpy(xyz), torch.from_numpy(ctr), radius, ns)


def _knn_case(name, rng):
    if name == "random":
        return rng.randn(2, 200, 3).astype(np.float32), rng.randn(2, 9, 3).astype(np.float32), \
            7, None
    if name == "ties":
        base = rng.randn(1, 30, 3).astype(np.float32)
        xyz = np.concatenate([base, base, base[:, :10], base], axis=1)
        return xyz, base[:, ::3].copy(), 8, None
    if name == "grid":
        # equal distances to other points (an integer lattice)
        g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(1, -1, 3)
        return g.astype(np.float32), g[:, ::7].astype(np.float32), 10, None
    if name == "mask":
        xyz = rng.randn(2, 64, 3).astype(np.float32)
        mask = rng.rand(2, 64) > 0.6                          # fewer valid points than k
        return xyz, rng.randn(2, 5, 3).astype(np.float32), 40, mask
    xyz = rng.randn(2, 24, 3).astype(np.float32)               # k = N
    return xyz, xyz[:, ::4].copy(), 24, rng.rand(2, 24) > 0.5


@pytest.mark.parametrize("case", ["random", "ties", "grid", "mask", "k_equals_n"])
def test_knn_points_match_jax(rng, case):
    xyz, ctr, k, mask = _knn_case(case, rng)
    want_d2, want_idx = jax_knn_points(k, jnp.asarray(xyz), jnp.asarray(ctr),
                                       valid_mask=None if mask is None else jnp.asarray(mask))
    d2, idx = ops.knn_points(k, torch.from_numpy(xyz), torch.from_numpy(ctr),
                             None if mask is None else torch.from_numpy(mask))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert tuple(idx.shape) == (ctr.shape[0], ctr.shape[1], k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(want_d2))
    if mask is not None:
        assert np.isinf(d2.numpy()[..., -1]).any()


def test_knn_points_tie_order():
    # lax.top_k(-d2, 5) on d2 = [3, 1, 1, 2, 1, 0, 0] gives [5, 6, 1, 2, 4]
    xyz = torch.tensor([[[3.0 ** 0.5, 0, 0], [1, 0, 0], [0, 1, 0], [2.0 ** 0.5, 0, 0],
                         [0, 0, 1], [0, 0, 0], [0, 0, 0]]])
    d2, idx = ops.knn_points(5, xyz, torch.zeros(1, 1, 3))
    assert idx.tolist() == [[[5, 6, 1, 2, 4]]]


def test_knn_points_k_past_n_raises():
    with pytest.raises(ValueError):
        ops.knn_points(9, torch.zeros(1, 8, 3), torch.zeros(1, 2, 3))


def boundary_rule(got, want, probs, uniforms, share=1e-3, ulps=4):
    """The draws where got != want: at most `share` of them, each one index
    over, and its target within `ulps` ulp(total) of the float64 cdf at
    the boundary between the two."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.nonzero(got != want)
    assert len(diff[0]) <= share * got.size, len(diff[0])
    assert (np.abs(got[diff] - want[diff]) == 1).all()
    cdf = np.cumsum(probs.astype(np.float64), axis=-1)
    total = probs.astype(np.float32).sum(-1, dtype=np.float32)
    rows, cols = diff
    k = np.minimum(got[diff], want[diff])
    target = uniforms[rows, cols].astype(np.float64) * cdf[rows, -1]
    assert (np.abs(target - cdf[rows, k]) <= ulps * np.spacing(total[rows])).all()


def test_prob_sample_exact_on_dyadic_weights(rng):
    probs = rng.randint(0, 6, (4, 500)).astype(np.float32)
    probs[1, ::3] = 0.25
    u = rng.rand(4, 3000).astype(np.float32)
    got = ops.prob_sample(torch.from_numpy(probs), torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_prob_sample(jnp.asarray(probs), jnp.asarray(u))))


def test_prob_sample_random_weights_boundary_rule(rng):
    probs = rng.rand(4, 5000).astype(np.float32)
    u = rng.rand(4, 2000).astype(np.float32)
    got = ops.prob_sample(torch.from_numpy(probs), torch.from_numpy(u))
    want = jax_prob_sample(jnp.asarray(probs), jnp.asarray(u))
    boundary_rule(got.numpy(), want, probs, u)


def test_prob_sample_zero_row_and_jax_distribution(rng):
    probs = np.float32([[0.0, 1.0, 3.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    u = rng.rand(2, 4000).astype(np.float32)
    got = ops.prob_sample(torch.from_numpy(probs), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jax_prob_sample(jnp.asarray(probs), jnp.asarray(u))))
    assert (got[1] == 3).all()
    counts = np.bincount(got[0], minlength=4)
    assert counts[0] == 0 and counts[3] == 0
    assert abs(counts[2] / counts[1] - 3.0) < 0.3


def _cloud(rng, b=2, n=400):
    return rng.randn(b, n, 3).astype(np.float32) * 1.5


@pytest.mark.parametrize("npoint", [-1, 0, 16])
def test_sample_points_matches_jax(rng, npoint):
    xyz = _cloud(rng)
    mask = rng.rand(2, 400) > 0.2
    want = jax_sample_points(jnp.asarray(xyz), npoint, jnp.asarray(mask))
    got = ops.sample_points(torch.from_numpy(xyz), npoint, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("option", ["fps", "keypoints", "orientations", "mask",
                                    "not_normalized", "all"])
def test_sample_and_group_matches_jax(rng, option):
    xyz = _cloud(rng)
    kw_j, kw_t = {}, {}
    if option in ("keypoints", "all"):
        kp = xyz[:, ::25].copy() + 0.1
        kw_j["keypoints"], kw_t["keypoints"] = jnp.asarray(kp), torch.from_numpy(kp)
    if option in ("orientations", "all"):
        ori = rng.uniform(-np.pi, np.pi, (2, 16)).astype(np.float32)
        kw_j["orientations"], kw_t["orientations"] = jnp.asarray(ori), torch.from_numpy(ori)
    if option in ("mask", "all"):
        mask = rng.rand(2, 400) > 0.25
        kw_j["valid_mask"], kw_t["valid_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if option in ("not_normalized", "all"):
        kw_j["normalize_radius"] = kw_t["normalize_radius"] = False
    want = jax_sample_and_group(16, 1.1, 24, jnp.asarray(xyz), **kw_j)
    got = ops.sample_and_group(16, 1.1, 24, torch.from_numpy(xyz), **kw_t)
    for name, g, w in zip(("centers", "idx", "cnt"), (got[0], got[2], got[3]),
                          (want[0], want[2], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)


def test_sample_and_group_refuses_per_centre_radii(rng):
    with pytest.raises(ValueError, match="scalar"):
        ops.sample_and_group(4, torch.ones(2, 4), 8, torch.from_numpy(_cloud(rng)))


def test_sample_and_group_all_matches_jax(rng):
    xyz = _cloud(rng, n=50)
    want = jax_sample_and_group_all(jnp.asarray(xyz))
    got = ops.sample_and_group_all(torch.from_numpy(xyz))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32


def _fc_pair(rng, use_bn, activation):
    """A flax FullyConnected's variables (BN statistics perturbed) and the
    port's module loaded from them."""
    x = rng.randn(6, 5, 9).astype(np.float32)
    act_j = None if activation is None else jax.nn.relu
    fc_j = JaxFullyConnected(7, use_bn=use_bn, activation=act_j)
    v = jax.tree_util.tree_map(np.asarray, fc_j.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    v = jax.tree_util.tree_map(np.array, v)
    v["params"]["dense"]["bias"] = rng.randn(7).astype(np.float32) * 0.1
    if use_bn:
        v["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, 7).astype(np.float32)
        v["params"]["bn"]["bias"] = rng.randn(7).astype(np.float32) * 0.1
        v["batch_stats"]["bn"]["mean"] = rng.randn(7).astype(np.float32) * 0.2
        v["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    act_t = None if activation is None else torch.relu
    fc_t = load_variables(FullyConnected(9, 7, use_bn=use_bn, activation=act_t), v)
    return x, fc_j, v, fc_t


@pytest.mark.parametrize("use_bn,activation,training", [
    (False, "relu", False), (True, "relu", False), (True, "relu", True),
    (True, None, True), (False, None, False)])
def test_fully_connected_matches_jax(rng, use_bn, activation, training):
    x, fc_j, v, fc_t = _fc_pair(rng, use_bn, activation)
    if training and use_bn:
        want, upd = fc_j.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    else:
        want = fc_j.apply(v, jnp.asarray(x), training=training)
    got = fc_t(torch.from_numpy(x), training=training)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if training and use_bn:
        stats = variables_from_module(fc_t)["batch_stats"]["bn"]
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[k], np.asarray(upd["batch_stats"]["bn"][k]),
                                       rtol=1e-5, atol=1e-6)
    if activation is None:
        assert (got < 0).any()


def test_fully_connected_names_are_flax_names():
    keys = set(FullyConnected(3, 4, use_bn=True).state_dict())
    assert keys == {"dense.weight", "dense.bias", "bn.scale", "bn.bias", "bn.mean", "bn.var"}
    assert set(FullyConnected(3, 4).state_dict()) == {"dense.weight", "dense.bias"}


def test_dropout_contract(rng):
    x = torch.from_numpy(rng.randn(200, 100).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    y = dropout(x, g, keep_prob=0.7)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02          # 7 sd of the share
    assert torch.equal(y[kept], x[kept] / 0.7)
    # the same seed, the same mask
    y2 = dropout(x, torch.Generator().manual_seed(5), keep_prob=0.7)
    assert torch.equal(y, y2)
    assert not torch.equal(y, dropout(x, torch.Generator().manual_seed(6), keep_prob=0.7))
    # identity when not training, or nothing dropped
    assert dropout(x, g, training=False) is x
    assert dropout(x, g, keep_prob=1.0) is x
    # JAX's kept values are the same quotients
    z = np.asarray(jax_dropout(jnp.asarray(x.numpy()), jax.random.PRNGKey(1), keep_prob=0.7))
    both = (z != 0) & kept.numpy()
    np.testing.assert_array_equal(z[both], y.numpy()[both])
