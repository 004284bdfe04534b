"""Batched and pipelined extraction of the port against JAX and against itself.

* The plain versions of K4 (`sorted_ball_query`) and K5 (`ball_max_sorted`)
  with `segment=` (a union of equal clouds, keys local to each) are
  index-exact against the JAX kernels run with `block_mask=` the cloud
  mask, in Pallas interpret mode; the block-diagonal hit mask equals the
  whole mask ANDed with the cloud mask (JAX's `cloud_mask`, copied here).
* `build_sorted_cloud_batch` is bit-equal to per-cloud builds.
* `extract_batch`, `extract_many` (sequential, batched with an odd tail,
  mixed buckets, with `rng`), `extract_batch` on clouds of two buckets
  at the default keypoint_chunk, `process_directory(batch_size=2)` and
  `cli.infer --batch_size 2` give each cloud exactly the port's `extract`
  result, on the default and the fused detector route, with overlapping
  coordinates (the isolation comes from the cloud mask, not from
  distance); `extract_batch` equals JAX's within tests/test_torch_pipeline.py's
  tolerance (keypoints equal, features rtol 1e-4 / atol 1e-5, attention
  rtol 1e-5 / atol 1e-6); `warmup` returns its (points, batch) keys.
Small widths (ns 8, towers (8, 16) / (8,) / (8, 8)), clouds of 400-900
points (bucket 4 096) and of 3 000 / 4 500 (buckets 4 096, 8 192).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.config import InferenceConfig as JaxInferenceConfig
from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.inference import InferencePipeline as JaxPipeline
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu.ops import hash_grid as jhg
from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, bucket_for
from feat3dnet_tpu_torch.inference import InferencePipeline
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.ops import hash_grid as thg
from feat3dnet_tpu_torch.utils import init_variables, save_variables_npz

torch.set_num_threads(2)

MODEL = dict(num_clusters=-1, num_samples=8, feature_dim=16, base_scale=2.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))
INFER = dict(keypoint_chunk=256, max_keypoints=64, nms_radius=1.0, use_hashed_grouping=True)
ROUTES = {"default": {}, "fused": dict(use_fused_detector=True),
          "auto_layout": dict(hash_block=0, hash_tile=128)}
FIELDS = ("keypoints", "attention", "features")


def _cloud(rs, n, spread=15.0, clusters=3):
    """Uniform points, a third of them in tight clusters; six columns."""
    pts = (rs.rand(n, 3).astype(np.float32) - 0.5) * spread
    k = n // 3
    ctr = (rs.rand(clusters, 3).astype(np.float32) - 0.5) * spread
    pts[:k] = ctr[rs.randint(0, clusters, k)] + rs.randn(k, 3).astype(np.float32) * 0.5
    return np.concatenate([pts, rs.randn(n, 3).astype(np.float32)], axis=1)


@pytest.fixture(scope="module")
def variables():
    """The flax variable tree as numpy (seeded, BN moved off identity)."""
    return init_variables(ModelConfig(**MODEL), seed=3, bn_perturb=0.1)


def _port(v, **icfg):
    cfg = ModelConfig(**MODEL)
    return InferencePipeline(Feat3DNet(cfg), v, cfg, InferenceConfig(**dict(INFER, **icfg)),
                             device="cpu")


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_keypoints == w.num_keypoints > 0
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)


def _cloud_mask(n_clouds, per, tile, block):
    """The JAX pipeline's `cloud_mask` (its batched `block_mask`): tile i
    and block j of a union of `per`-point clouds belong to one cloud."""
    tpc, bpc = per // tile, per // block
    return (np.arange(n_clouds * tpc)[:, None] // tpc
            == np.arange(n_clouds * bpc)[None, :] // bpc)


def _union(rs, sizes, per, block):
    """Per-cloud host layouts of clouds padded to `per` points (valid
    first), concatenated: the union K4 and K5 take with segment=per."""
    scs = []
    for n in sizes:
        xyz = np.zeros((per, 3), np.float32)
        xyz[:n] = _cloud(rs, n, spread=10.0)[:, :3]
        scs.append(thg.build_sorted_cloud_host(xyz, np.arange(per) < n, cell_size=2.0,
                                               block_size=block))
    return (np.concatenate([s.pts4 for s in scs]), np.concatenate([s.blk_bbox for s in scs]),
            scs)


# ---- K4 / K5 on a union, against JAX's block_mask ----------------------------

@pytest.mark.parametrize("sizes,per,block,tile", [((400, 250, 512), 512, 64, 32),
                                                  ((300, 700), 768, 96, 64)])
def test_plain_k4_k5_segment_match_jax_block_mask(sizes, per, block, tile):
    rs = np.random.RandomState(7)
    pts4, bbox, scs = _union(rs, sizes, per, block)
    b = len(sizes)
    mask = _cloud_mask(b, per, tile, block)
    centers = pts4[:, :3]
    jsc = jhg.SortedCloud(pts4=jnp.asarray(pts4), blk_bbox=jnp.asarray(bbox), orig_idx=None,
                          inv_perm=None, block_size=block)
    want = [np.asarray(a) for a in jhg.ball_query_grouped_sorted(
        jsc, jnp.asarray(centers), 2.0, 8, tile=tile, block_mask=jnp.asarray(mask))]
    n0 = thg.sorted_ball_query.launches
    got = thg.ball_query_grouped_sorted(
        thg.SortedCloud(torch.from_numpy(pts4), torch.from_numpy(bbox), None, None, block),
        torch.from_numpy(centers), 2.0, 8, tile=tile, segment=per)
    assert thg.sorted_ball_query.launches == n0            # CPU: the plain version
    for name, g, w in zip(("grouped", "idx", "cnt"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # each cloud's rows are its own run's (chunks that straddle two clouds)
    top, cnt = thg.sorted_ball_query_plain(torch.from_numpy(pts4), torch.from_numpy(centers),
                                           2.0, 8, chunk_m=100, chunk_n=200, segment=per)
    for i, sc in enumerate(scs):
        alone = thg.sorted_ball_query_plain(torch.from_numpy(sc.pts4),
                                            torch.from_numpy(sc.pts4[:, :3]), 2.0, 8)
        rows = slice(i * per, (i + 1) * per)
        assert torch.equal(top[rows], alone[0]) and torch.equal(cnt[rows], alone[1])

    vals = rs.rand(pts4.shape[0]).astype(np.float32)
    vals[5] = vals[per + 5] = np.float32(0.9)             # a tie across clouds
    bm_want = np.asarray(jhg.ball_max_sorted(
        jnp.asarray(pts4), jnp.asarray(bbox), jnp.asarray(vals), 1.0, tile=tile,
        block_mask=jnp.asarray(mask)))
    n0 = thg.ball_max_sorted.launches
    bm = thg.ball_max_sorted(torch.from_numpy(pts4), torch.from_numpy(bbox),
                             torch.from_numpy(vals), 1.0, tile=tile, segment=per)
    assert thg.ball_max_sorted.launches == n0
    np.testing.assert_array_equal(bm.numpy(), bm_want)
    for i, sc in enumerate(scs):
        alone = thg.ball_max_plain(torch.from_numpy(sc.pts4),
                                   torch.from_numpy(vals[i * per:(i + 1) * per]), 1.0)
        assert torch.equal(bm[i * per:(i + 1) * per], alone)


def test_block_diagonal_hitmask_is_the_anded_mask():
    rs = np.random.RandomState(8)
    per, block, tile, b = 512, 64, 32, 3
    pts4, bbox, _ = _union(rs, (500, 120, 512), per, block)
    ctr, bb = torch.from_numpy(pts4[:, :3]), torch.from_numpy(bbox)
    r2 = thg._r2(2.0)
    whole = thg._padded_hitmask(ctr, bb, r2, tile).bool()
    diag = thg._padded_hitmask(ctr, bb, r2, tile, n_clouds=b, chunk=3000)  # chunked clouds
    assert diag.dtype == torch.uint8
    mask = torch.from_numpy(_cloud_mask(b, per, tile, block))
    assert torch.equal(diag.bool(), whole & mask)
    jmask = np.asarray(jhg._block_hitmask(
        jhg._tile_bbox(jnp.asarray(pts4[:, :3]), tile), jnp.asarray(bbox), r2,
        jnp.asarray(mask.numpy())))
    bits = (jmask[:, :, None] >> np.arange(32)) & 1      # JAX packs 32 blocks a word
    np.testing.assert_array_equal(diag.numpy(), bits.reshape(jmask.shape[0], -1)[:, :bb.shape[0]])


def test_segment_is_checked():
    rs = np.random.RandomState(9)
    pts4, bbox, _ = _union(rs, (200, 300), 512, 64)
    p, bb = torch.from_numpy(pts4), torch.from_numpy(bbox)
    for seg, tile in ((500, 32), (512, 96), (256 + 128, 32)):
        with pytest.raises(ValueError, match="segment"):
            thg.sorted_ball_query(p, bb, p[:, :3], 2.0, 8, tile=tile, segment=seg)
        with pytest.raises(ValueError, match="segment"):
            thg.ball_max_sorted(p, bb, p[:, 0], 1.0, tile=tile, segment=seg)
    with pytest.raises(ValueError, match="segment"):          # centres not split evenly
        thg.sorted_ball_query(p, bb, p[:96, :3], 2.0, 8, tile=32, segment=512)
    with pytest.raises(ValueError, match="segment"):          # nor in the plain version
        thg.ball_max_plain(p, p[:, 0], 1.0, centers=p[:33, :3], segment=512)


@pytest.mark.parametrize("block", [64, 128, 96])
def test_build_sorted_cloud_batch_equals_per_cloud(block):
    rs = np.random.RandomState(10)
    n = 1024
    xyz = np.stack([_cloud(rs, n, spread=s)[:, :3] for s in (12.0, 30.0, 5.0)])
    xyz[1, 7] = np.nan                                    # non-finite: invalid
    xyz[2] += np.float32(3000.0)                          # far from the others
    valid = np.zeros((3, n), bool)
    valid[0, :700], valid[1], valid[2, :1] = True, rs.rand(n) > 0.2, True
    got = thg.build_sorted_cloud_batch(torch.from_numpy(xyz), torch.from_numpy(valid),
                                       cell_size=2.0, block_size=block)
    alone = [thg.build_sorted_cloud_host(xyz[i], valid[i], cell_size=2.0, block_size=block)
             for i in range(3)]
    np.testing.assert_array_equal(got.pts4.numpy(), np.concatenate([s.pts4 for s in alone]))
    np.testing.assert_array_equal(got.blk_bbox.numpy(),
                                  np.concatenate([s.blk_bbox for s in alone]))
    np.testing.assert_array_equal(got.inv_perm.numpy(), np.stack([s.inv_perm for s in alone]))
    np.testing.assert_array_equal(got.orig_idx.numpy(), np.stack([s.orig_idx for s in alone]))
    assert got.inv_perm.dtype == got.orig_idx.dtype == torch.int32
    assert got.block_size == block


# ---- the entry points ------------------------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_extract_batch_equals_extract(variables, route):
    """Three clouds of one bucket with overlapping coordinates."""
    rs = np.random.RandomState(11)
    clouds = [_cloud(rs, n) for n in (700, 450, 900)][:2 if route == "auto_layout" else 3]
    pipe = _port(variables, **ROUTES[route])
    _assert_equal(pipe.extract_batch(clouds), [pipe.extract(c) for c in clouds])
    if route == "default":
        # with rng: the permutations drawn in input order, as a loop of extract
        got = pipe.extract_batch(clouds[:2], rng=np.random.RandomState(4))
        r = np.random.RandomState(4)
        _assert_equal(got, [pipe.extract(c, rng=r) for c in clouds[:2]])


def test_extract_batch_matches_jax(variables):
    rs = np.random.RandomState(12)
    clouds = [_cloud(rs, n) for n in (650, 500)]
    jpipe = JaxPipeline(JaxFeat3DNet(JaxModelConfig(**MODEL)),
                        jax.tree.map(jnp.asarray, variables),
                        JaxModelConfig(**MODEL), JaxInferenceConfig(**INFER))
    got, want = _port(variables).extract_batch(clouds), jpipe.extract_batch(clouds)
    for g, w in zip(got, want):
        assert g.num_keypoints == w.num_keypoints > 0
        np.testing.assert_array_equal(g.keypoints, w.keypoints)
        np.testing.assert_allclose(g.features, w.features, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g.attention, w.attention, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["default", "fused"])
def test_extract_many_equals_extract(variables, route):
    """Batched with an odd tail (2 + 1) on two prep threads; on the
    default route also sequential, and batched with rng."""
    rs = np.random.RandomState(13)
    clouds = [_cloud(rs, n) for n in (500, 650, 400)]
    pipe = _port(variables, max_keypoints=32, **ROUTES[route])
    want = [pipe.extract(c) for c in clouds]
    _assert_equal(pipe.extract_many(clouds, batch_size=2, depth=3, prep_workers=2), want)
    if route == "default":
        _assert_equal(pipe.extract_many(clouds), want)
        r = np.random.RandomState(5)
        seq = [pipe.extract(c, rng=r) for c in clouds]
        _assert_equal(pipe.extract_many(clouds, rng=np.random.RandomState(5), batch_size=2),
                      seq)


def test_extract_many_mixed_buckets(variables):
    """Clouds of two buckets: each bucket its own unit."""
    rs = np.random.RandomState(17)
    clouds = [_cloud(rs, 3000, spread=25.0, clusters=4), _cloud(rs, 4500, spread=25.0,
                                                                clusters=4)]
    assert len({bucket_for(c.shape[0]) for c in clouds}) == 2
    pipe = _port(variables, max_keypoints=32)
    _assert_equal(pipe.extract_many(clouds, batch_size=2), [pipe.extract(c) for c in clouds])


def test_extract_batch_mixed_buckets(variables):
    """A cloud of bucket 4 096 batched with one of bucket 8 192 at the
    default keypoint_chunk, on the default route: the small cloud is
    padded to the shared bucket, yet its detector passes keep the shapes
    of its own run."""
    rs = np.random.RandomState(18)
    clouds = [_cloud(rs, 3000, spread=25.0, clusters=4), _cloud(rs, 4500, spread=25.0,
                                                                clusters=4)]
    pipe = _port(variables, max_keypoints=32, keypoint_chunk=InferenceConfig().keypoint_chunk)
    assert pipe._chunk_size(bucket_for(3000)) < pipe._chunk_size(bucket_for(4500))
    _assert_equal(pipe.extract_batch(clouds), [pipe.extract(c) for c in clouds])


def test_dense_route_takes_the_extract_loop(variables):
    rs = np.random.RandomState(14)
    clouds = [_cloud(rs, n) for n in (500, 600)]
    pipe = _port(variables, use_hashed_grouping=False)
    want = [pipe.extract(c) for c in clouds]
    _assert_equal(pipe.extract_batch(clouds), want)
    _assert_equal(pipe.extract_many(clouds, batch_size=2), want)


def test_warmup_returns_its_keys(variables):
    pipe = _port(variables)
    times = pipe.warmup(point_counts=[300], batch_sizes=(1, 2))
    assert set(times) == {(300, 1), (300, 2)}
    assert all(t > 0 for t in times.values())
    rs = np.random.RandomState(15)
    assert set(pipe.warmup(clouds=[_cloud(rs, 450)])) == {(450, 1)}


def test_process_directory_and_cli_batch(variables, tmp_path, monkeypatch):
    """process_directory(batch_size=2) and cli.infer --batch_size 2 write
    the files a loop of extract writes (three files: a batch and a tail)."""
    import feat3dnet_tpu_torch.config as tcfg
    from feat3dnet_tpu_torch.cli import infer

    rs = np.random.RandomState(16)
    data = tmp_path / "data"
    data.mkdir()
    names = ("a.bin", "b.bin", "c.bin")
    for n, name in zip((600, 480, 700), names):
        _cloud(rs, n).tofile(str(data / name))
    pipe = _port(variables)
    logs = []
    assert pipe.process_directory(str(data), str(tmp_path / "b2"), log=logs.append,
                                  batch_size=2) == 3
    assert len(logs) == 3 and "keypoints" in logs[0]
    pipe.process_directory(str(data), str(tmp_path / "b1"), log=lambda *_: None)
    npz = str(tmp_path / "v.npz")
    save_variables_npz(npz, variables)
    # the CLI exposes no tower widths, chunk or route: run it at this test's
    towers = {k: MODEL[k] for k in ("detector_mlp", "detector_mlp2", "descriptor_mlp")}
    monkeypatch.setattr(tcfg, "ModelConfig", lambda **kw: ModelConfig(**kw, **towers))
    monkeypatch.setattr(tcfg, "InferenceConfig", lambda **kw: InferenceConfig(
        **kw, keypoint_chunk=256, use_hashed_grouping=True))
    infer.main(["--data_dir", str(data), "--output_dir", str(tmp_path / "cli"),
                "--variables", npz, "--num_samples", "8", "--feature_dim", "16",
                "--nms_radius", "1.0", "--max_keypoints", "64", "--device", "cpu",
                "--batch_size", "2"])
    for name in names:
        ref = np.fromfile(str(tmp_path / "b1" / name), np.float32)
        assert ref.size > 0 and ref.size % 19 == 0
        np.testing.assert_array_equal(np.fromfile(str(tmp_path / "b2" / name), np.float32), ref)
        np.testing.assert_array_equal(np.fromfile(str(tmp_path / "cli" / name), np.float32),
                                      ref)
