"""Port of ops/hash_grid (host layout, cull, K4/K5 plain versions) against JAX.

* `build_sorted_cloud_host` is bit-equal to the JAX numpy layout code
  (use_native=False), with pad rows, invalid points and non-finite
  coordinates; `estimate_ball_points`, `sort_centers` and the bbox hit
  test are equal.
* `build_sorted_cloud` (torch, on the CPU here) is bit-equal to the host
  layout and to JAX's jitted device builder on the same cases, a cloud of
  duplicate points and the four vendored clouds at their buckets; the
  pipeline's extract on it (the first 6 000 points of a vendored cloud,
  bucket 8 192) equals the extract on the host layout.
* The plain versions of kernels K4 (`sorted_ball_query`) and K5
  (`ball_max_sorted`) are index-exact against the JAX kernels run in
  Pallas interpret mode: saturated balls, masks, duplicate points, exact
  value ties and a cloud offset by 5 000 m.
* `hashed_ball_query` equals the dense ball query, the nearest-point
  fallback of empty balls included.
The kernels themselves are held against these plain versions in
test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.ops import ball_query as jax_ball_query
from feat3dnet_tpu.ops import hash_grid as jhg
from feat3dnet_tpu_torch.ops import hash_grid as thg
from feat3dnet_tpu_torch.ops.neighborhoods import ball_query_plain

torch.set_num_threads(2)


def _cloud(rs, n, spread=20.0, clusters=0, offset=0.0):
    """Uniform points, optionally a third of them in tight clusters (which
    saturates balls), optionally shifted far from the origin."""
    pts = (rs.rand(n, 3).astype(np.float32) - 0.5) * spread
    if clusters:
        k = n // 3
        ctr = (rs.rand(clusters, 3).astype(np.float32) - 0.5) * spread
        pts[:k] = ctr[rs.randint(0, clusters, k)] + rs.randn(k, 3).astype(np.float32) * 0.5
    return pts + np.float32(offset)


CASES = {
    "random": dict(n=500, spread=20.0),
    "saturated": dict(n=600, spread=8.0, clusters=5),
    "offset_5000m": dict(n=400, spread=10.0, offset=5000.0),
}


@pytest.mark.parametrize("case", ["plain", "pads_invalid", "nonfinite", "offset"])
def test_build_sorted_cloud_host_bit_equal(case):
    rs = np.random.RandomState(1)
    n = 300 if case == "plain" else 437              # 437 % 64 != 0: pad rows
    xyz = _cloud(rs, n, spread=15.0, clusters=3,
                 offset=5000.0 if case == "offset" else 0.0)
    valid = None
    if case in ("pads_invalid", "nonfinite"):
        valid = rs.rand(n) > 0.2
    if case == "nonfinite":
        xyz[3] = np.nan
        xyz[17, 1] = np.inf
        xyz[40, 2] = -np.inf
    want = jhg.build_sorted_cloud_host(xyz, valid, cell_size=2.0, block_size=64,
                                       use_native=False)
    got = thg.build_sorted_cloud_host(xyz, valid, cell_size=2.0, block_size=64)
    for f in ("pts4", "blk_bbox", "orig_idx", "inv_perm"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.block_size == 64
    if case == "pads_invalid":
        keys = got.pts4[:, 3]
        assert np.unique(keys).size == keys.size           # unique keys, pads included
        assert (got.pts4[keys >= n, :3] == np.float32(1e9)).all()



LAYOUT_FIELDS = ("pts4", "blk_bbox", "orig_idx", "inv_perm")
VENDORED = ("oxford_270.bin", "oxford_456.bin", "kitti_00_001554.bin", "kitti_00_004534.bin")


def _layout_case(case):
    """(xyz, valid, block): the host-layout cases above, a cloud of
    duplicate points, or a vendored cloud padded to its bucket."""
    rs = np.random.RandomState(1)
    if case in VENDORED:
        from feat3dnet_tpu_torch.config import bucket_for
        from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud

        cloud = load_point_cloud(example_cloud_path(case))[:, :3]
        nb = bucket_for(cloud.shape[0])
        xyz = np.zeros((nb, 3), np.float32)
        xyz[:cloud.shape[0]] = cloud
        return xyz, np.arange(nb) < cloud.shape[0], 256
    if case == "duplicates":
        xyz = _cloud(rs, 150, spread=6.0)
        xyz = np.concatenate([xyz, xyz, xyz[:37], np.repeat(xyz[:1], 20, axis=0)])
        return xyz, rs.rand(xyz.shape[0]) > 0.1, 64
    n = 300 if case == "plain" else 437
    xyz = _cloud(rs, n, spread=15.0, clusters=3, offset=5000.0 if case == "offset" else 0.0)
    valid = rs.rand(n) > 0.2 if case in ("pads_invalid", "nonfinite") else None
    if case == "nonfinite":
        xyz[3] = np.nan
        xyz[17, 1] = np.inf
        xyz[40, 2] = -np.inf
    return xyz, valid, 64


@pytest.mark.parametrize("case", ["plain", "pads_invalid", "nonfinite", "offset", "duplicates"]
                         + list(VENDORED))
def test_build_sorted_cloud_bit_equal(case):
    xyz, valid, block = _layout_case(case)
    host = thg.build_sorted_cloud_host(xyz, valid, cell_size=2.0, block_size=block)
    got = thg.build_sorted_cloud(torch.from_numpy(xyz),
                                 None if valid is None else torch.from_numpy(valid),
                                 cell_size=2.0, block_size=block)
    # JAX's device builder, jitted on the CPU (its SortedCloud is no pytree)
    fields = jax.jit(lambda x, v: tuple(getattr(jhg.build_sorted_cloud(
        x, v, cell_size=2.0, block_size=block), f) for f in LAYOUT_FIELDS))(
        jnp.asarray(xyz), None if valid is None else jnp.asarray(valid))
    assert got.block_size == block
    for f in LAYOUT_FIELDS:
        a = getattr(got, f).numpy()
        assert a.dtype == getattr(host, f).dtype, f
        np.testing.assert_array_equal(a, getattr(host, f), err_msg=f)
    for f, want in zip(LAYOUT_FIELDS, fields):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(want), err_msg=f)


def test_extract_on_the_device_layout_equals_the_host_layout(monkeypatch):
    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.inference import InferencePipeline, pipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.utils import init_variables

    cfg = ModelConfig(num_clusters=-1, num_samples=8, feature_dim=16, detector_mlp=(8, 16),
                      detector_mlp2=(8,), descriptor_mlp=(8, 8))
    pipe = InferencePipeline(Feat3DNet(cfg), init_variables(cfg, seed=0, bn_perturb=0.1), cfg,
                             InferenceConfig(use_hashed_grouping=True, keypoint_chunk=4096,
                                             num_points=6000),   # its first 6 000 points
                             device="cpu")
    cloud = load_point_cloud(example_cloud_path("oxford_270.bin"))
    got = pipe.extract(cloud)

    def host_layouts(xyz, valid, **kw):
        """The pipeline's (B, N) union of layouts, each built in numpy."""
        scs = [thg.build_sorted_cloud_host(x, v, **kw) for x, v in zip(xyz.numpy(),
                                                                       valid.numpy())]
        return thg.SortedCloud(np.concatenate([s.pts4 for s in scs]),
                               np.concatenate([s.blk_bbox for s in scs]),
                               np.stack([s.orig_idx for s in scs]),
                               np.stack([s.inv_perm for s in scs]), kw["block_size"]).to("cpu")
    monkeypatch.setattr(pipeline, "build_sorted_cloud_batch", host_layouts)
    want = pipe.extract(cloud)
    assert got.num_keypoints == want.num_keypoints > 100
    np.testing.assert_array_equal(got.keypoints, want.keypoints)
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.attention, want.attention)

def test_estimate_and_sort_centers_match_jax():
    rs = np.random.RandomState(2)
    xyz = _cloud(rs, 700, spread=30.0, clusters=4)
    assert thg.estimate_ball_points(xyz, 2.0) == jhg.estimate_ball_points(xyz, 2.0)
    cv = rs.rand(700) > 0.3
    jc, jo = jhg.sort_centers(jnp.asarray(xyz), jnp.asarray(cv), cell_size=2.0)
    tc, to = thg.sort_centers(torch.from_numpy(xyz), torch.from_numpy(cv), cell_size=2.0)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("radius", [2.0, 0.5])
def test_block_hitmask_matches_jax(radius):
    rs = np.random.RandomState(3)
    xyz = _cloud(rs, 512, spread=25.0, clusters=3)
    sc = thg.build_sorted_cloud_host(xyz, cell_size=2.0, block_size=32)
    centers = sc.pts4[:, :3]
    r2 = float(radius) ** 2
    want_bits = np.asarray(jhg._block_hitmask(jhg._tile_bbox(jnp.asarray(centers), 16),
                                              jnp.asarray(sc.blk_bbox), r2))
    nb = sc.blk_bbox.shape[0]
    want = ((want_bits[:, :, None] >> np.arange(32)) & 1).reshape(want_bits.shape[0], -1)[:, :nb]
    tbox = thg.tile_bbox(torch.from_numpy(centers), 16)
    np.testing.assert_array_equal(tbox.numpy(), np.asarray(jhg._tile_bbox(jnp.asarray(centers), 16)))
    got = thg.block_hitmask(tbox, torch.from_numpy(sc.blk_bbox), thg._r2(radius), chunk=64)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    # the cull is sufficient: every in-ball pair lies in a hit (tile, block)
    d2 = ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    tiles, blocks = np.nonzero(d2 < r2)
    assert got.numpy()[tiles // 16, blocks // 32].all()


def _jax_grouped(sc, centers, radius, ns, tile):
    jsc = jhg.SortedCloud(pts4=jnp.asarray(sc.pts4), blk_bbox=jnp.asarray(sc.blk_bbox),
                          orig_idx=None, inv_perm=None, block_size=sc.block_size)
    return [np.asarray(a) for a in jhg.ball_query_grouped_sorted(
        jsc, jnp.asarray(centers), radius, ns, tile=tile)]


@pytest.mark.parametrize("case", sorted(CASES) + ["masked_dupes"])
def test_plain_k4_matches_jax_grouped(case):
    rs = np.random.RandomState(4)
    kw = CASES.get(case, dict(n=480, spread=10.0))
    xyz = _cloud(rs, **kw)
    valid = None
    if case == "masked_dupes":
        xyz[100:160] = xyz[:60]                           # duplicate points
        valid = rs.rand(xyz.shape[0]) > 0.25
    sc = thg.build_sorted_cloud_host(xyz, valid, cell_size=2.0, block_size=64)
    centers = sc.pts4[:, :3]                              # every point, invalid included
    want = _jax_grouped(sc, centers, 2.0, 8, tile=32)
    n0 = thg.sorted_ball_query.launches
    top, cnt_raw = thg.sorted_ball_query(torch.from_numpy(sc.pts4),
                                         torch.from_numpy(sc.blk_bbox),
                                         torch.from_numpy(centers), 2.0, 8, tile=32)
    assert thg.sorted_ball_query.launches == n0          # CPU: the plain version
    got = thg._finish_grouped(top, cnt_raw, torch.from_numpy(centers), 8)
    for name, a, b in zip(("grouped", "idx", "cnt"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    if case == "saturated":
        assert (cnt_raw.numpy() > 8).mean() > 0.5, "the cloud should saturate balls"
    # the raw contract: ascending keys, [0 0 0 1e30] past the true count
    t = top.numpy()
    filled = np.arange(8)[None, :] < np.minimum(cnt_raw.numpy(), 8)[:, None]
    keys, both = t[..., 3], filled[:, 1:]
    assert (keys[:, 1:][both] > keys[:, :-1][both]).all()
    np.testing.assert_array_equal(t[~filled], np.tile([0, 0, 0, 1e30], ((~filled).sum(), 1))
                                  .astype(np.float32))
    d2 = ((centers[:, None, :] - sc.pts4[None, :, :3]) ** 2).sum(-1)
    np.testing.assert_array_equal(cnt_raw.numpy(), (d2 < 4.0).sum(1))


def test_plain_k4_external_centers_and_tiles():
    """Centres that are not cloud points (some far away: empty balls), a
    count that is not a multiple of the tile, chunking smaller than the
    cloud."""
    rs = np.random.RandomState(5)
    xyz = _cloud(rs, 400, spread=12.0, clusters=3)
    sc = thg.build_sorted_cloud_host(xyz, cell_size=2.0, block_size=32)
    centers = np.concatenate([_cloud(rs, 37, spread=14.0),
                              np.array([[500.0, 0.0, 0.0]], np.float32)])
    want = _jax_grouped(sc, centers, 1.5, 8, tile=16)
    top, cnt_raw = thg.sorted_ball_query_plain(torch.from_numpy(sc.pts4),
                                               torch.from_numpy(centers), 1.5, 8,
                                               chunk_m=10, chunk_n=96)
    got = thg._finish_grouped(top, cnt_raw, torch.from_numpy(centers), 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got[2][-1].item() == 0 and (got[0][-1].numpy() == centers[-1]).all()


@pytest.mark.parametrize("case", ["offset_5000m", "masked_ties"])
def test_plain_k5_matches_jax_ball_max(case):
    rs = np.random.RandomState(6)
    n = 600
    xyz = _cloud(rs, n, spread=12.0, clusters=3,
                 offset=5000.0 if case == "offset_5000m" else 0.0)
    valid = rs.rand(n) > 0.15 if case == "masked_ties" else None
    att = rs.rand(n).astype(np.float32) + 0.01
    att[10] = att[11] = att[12] = np.float32(0.7)        # exact ties
    sc = thg.build_sorted_cloud_host(xyz, valid, cell_size=1.5, block_size=64)
    vals = att[sc.orig_idx]
    want = np.asarray(jhg.ball_max_sorted(jnp.asarray(sc.pts4), jnp.asarray(sc.blk_bbox),
                                          jnp.asarray(vals), 1.5, tile=32))
    n0 = thg.ball_max_sorted.launches
    got = thg.ball_max_sorted(torch.from_numpy(sc.pts4), torch.from_numpy(sc.blk_bbox),
                              torch.from_numpy(vals), 1.5, tile=32)
    assert thg.ball_max_sorted.launches == n0
    np.testing.assert_array_equal(got.numpy(), want)
    part = thg.ball_max_plain(torch.from_numpy(sc.pts4), torch.from_numpy(vals), 1.5,
                              centers=torch.from_numpy(sc.pts4[100:170, :3]),
                              chunk_m=16, chunk_n=100)
    np.testing.assert_array_equal(part.numpy(), want[100:170])
    if valid is not None:                                 # invalid centres: +1e30
        bad = sc.pts4[:, 0] >= 5e8
        assert bad.any() and (got.numpy()[bad] == np.float32(1e30)).all()


@pytest.mark.parametrize("case", ["saturated", "masked", "empty_and_center_valid"])
def test_hashed_ball_query_matches_dense(case):
    rs = np.random.RandomState(7)
    xyz = _cloud(rs, 500, spread=8.0 if case == "saturated" else 20.0,
                 clusters=4 if case == "saturated" else 0)
    centers = xyz[rs.choice(500, 90, replace=False)]
    valid = rs.rand(500) > 0.3 if case == "masked" else None
    cv = None
    if case == "empty_and_center_valid":
        centers = np.concatenate([centers, [[600.0, 0.0, 0.0], [-300.0, 200.0, 1.0]]],
                                 axis=0).astype(np.float32)
        cv = np.ones(centers.shape[0], bool)
        cv[::7] = False
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a[None]))
    idx, cnt = thg.hashed_ball_query(t(xyz), t(centers), 2.0, 8, valid_mask=t(valid),
                                     center_valid=t(cv), block_size=64, tile=16)
    ridx, rcnt = ball_query_plain(t(xyz), t(centers), 2.0, 8, t(valid))
    jidx, jcnt = jax_ball_query(jnp.asarray(xyz[None]), jnp.asarray(centers[None]), 2.0, 8,
                                valid_mask=None if valid is None else jnp.asarray(valid[None]))
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rcnt.numpy(), np.asarray(jcnt))
    keep = slice(None) if cv is None else cv
    np.testing.assert_array_equal(idx.numpy()[0][keep], ridx.numpy()[0][keep])
    np.testing.assert_array_equal(cnt.numpy()[0][keep], rcnt.numpy()[0][keep])
    if cv is not None:
        assert (cnt.numpy()[0][~cv] == 0).all() and (idx.numpy()[0][~cv] == 0).all()
        assert (rcnt.numpy()[0][-2:] == 0).all()           # the far centres were empty


def test_nearest_valid_chunked_matches_jax():
    rs = np.random.RandomState(8)
    pts = _cloud(rs, 333, spread=10.0)
    pts[50] = pts[49]                                     # equal distances: first wins
    centers = np.concatenate([_cloud(rs, 40, spread=30.0), pts[49:50]])
    valid = rs.rand(333) > 0.2
    valid[49] = valid[50] = True
    want = np.asarray(jhg._nearest_valid_chunked(jnp.asarray(centers), jnp.asarray(pts),
                                                 jnp.asarray(valid), chunk_m=16, chunk_n=64))
    got = thg._nearest_valid_chunked(torch.from_numpy(centers), torch.from_numpy(pts),
                                     torch.from_numpy(valid), chunk_m=16, chunk_n=64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[-1].item() == 49


def test_wrappers_refuse_bad_inputs():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        thg.sorted_ball_query(torch.empty(64, 4, device=meta), torch.empty(2, 8, device=meta),
                              torch.empty(3, 3, device=meta), 2.0, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        thg.ball_max_sorted(torch.empty(64, 4, device=meta), torch.empty(2, 8, device=meta),
                            torch.empty(64, device=meta), 0.5)
    with pytest.raises(ValueError, match="multiple of 32"):
        thg._check_sorted_inputs("k", torch.empty(48, 4), torch.empty(3, 8), torch.empty(2, 3))
