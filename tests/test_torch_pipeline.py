"""Port of inference/pipeline (and cli/infer) against the JAX pipeline.

The reference is JAX `InferencePipeline.extract` with
use_hashed_grouping=False (XLA ball query, dense NMS, model forward at the
keypoints; no Pallas). The port's dense route, its hashed route (Morton
layout built with torch on the CPU, plain K4, detector, plain K5, selection, descriptors from the
attention pass's neighbourhoods) and the hashed route with
use_fused_detector (plain K6 and K3) must give the same keypoints and
counts; features within rtol 1e-4 / atol 1e-5, keypoint attention within
rtol 1e-5 / atol 1e-6. The external-keypoints branch, randomize_points,
process_directory and the CLI are covered the same way. Small widths
(ns 8, towers (8, 16) / (8,) / (8, 8)) and clouds of 600-900 points.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp

from feat3dnet_tpu.config import InferenceConfig as JaxInferenceConfig
from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.config import POINT_BUCKETS as JAX_BUCKETS
from feat3dnet_tpu.config import bucket_for as jax_bucket_for
from feat3dnet_tpu.inference import InferencePipeline as JaxPipeline
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu_torch.config import (POINT_BUCKETS, InferenceConfig, ModelConfig,
                                        bucket_for)
from feat3dnet_tpu_torch.inference import InferencePipeline
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.utils import save_variables_npz

torch.set_num_threads(2)

MODEL = dict(num_clusters=-1, num_samples=8, feature_dim=16, base_scale=2.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))
INFER = dict(keypoint_chunk=256, max_keypoints=64, nms_radius=1.0)
ROUTES = {
    "dense": dict(use_hashed_grouping=False),
    "hashed": dict(use_hashed_grouping=True),
    "hashed_auto_layout": dict(use_hashed_grouping=True, hash_block=0, hash_tile=128),
    "hashed_csr_flag": dict(use_hashed_grouping=True, use_csr_kernels=True),
    "hashed_fused": dict(use_hashed_grouping=True, use_fused_detector=True),
}


def _cloud(seed, n=900, spread=18.0, clusters=5):
    rs = np.random.RandomState(seed)
    pts = (rs.rand(n, 3).astype(np.float32) - 0.5) * spread
    k = n // 3
    ctr = (rs.rand(clusters, 3).astype(np.float32) - 0.5) * spread
    pts[:k] = ctr[rs.randint(0, clusters, k)] + rs.randn(k, 3).astype(np.float32) * 0.5
    return np.concatenate([pts, rs.randn(n, 3).astype(np.float32)], axis=1)  # + normals


@pytest.fixture(scope="module")
def jax_setup():
    rs = np.random.RandomState(0)
    model = JaxFeat3DNet(JaxModelConfig(**MODEL))
    v = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 3)), training=False)
    v = jax.tree.map(lambda x: x + 0.1 * rs.randn(*x.shape).astype(np.float32), v)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.abs(x) + 0.5 if "var" in jax.tree_util.keystr(p) else x, v)
    pipe = JaxPipeline(model, v, JaxModelConfig(**MODEL),
                       JaxInferenceConfig(use_hashed_grouping=False, **INFER))
    return pipe, jax.tree.map(np.asarray, v)


def _port(variables, **icfg):
    cfg = ModelConfig(**MODEL)
    return InferencePipeline(Feat3DNet(cfg), variables, cfg,
                             InferenceConfig(**dict(INFER, **icfg)), device="cpu")


def _assert_same(got, want):
    assert got.num_keypoints == want.num_keypoints
    np.testing.assert_array_equal(got.keypoints, want.keypoints)
    np.testing.assert_allclose(got.features, want.features, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.attention, want.attention, rtol=1e-5, atol=1e-6)


def test_config_mirrors_jax():
    ours = {f.name: f.default for f in dataclasses.fields(InferenceConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxInferenceConfig)}
    assert ours == theirs
    assert POINT_BUCKETS == JAX_BUCKETS
    for n in (1, 4096, 4097, 131072, 131073, 200000, 600000):
        assert bucket_for(n) == jax_bucket_for(n)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_extract_matches_jax(jax_setup, route):
    jpipe, v = jax_setup
    cloud = _cloud(3)
    want = jpipe.extract(cloud)
    pipe = _port(v, **ROUTES[route])
    assert pipe._use_hashed() == (route != "dense")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = pipe.extract(cloud)
    _assert_same(got, want)
    assert got.num_keypoints > 8 and np.isfinite(got.features).all()
    layouts = [e for e in prof.events() if e.name == "f3d.extract.layout"]
    assert len(layouts) == (route != "dense")
    if route == "hashed":
        assert pipe._chunk_size(4096) == jpipe._chunk_size(4096)
        assert pipe._layout_for(cloud[:, :3]) == jpipe._layout_for(cloud[:, :3])


def test_extract_external_keypoints_and_randomize(jax_setup):
    jpipe, v = jax_setup
    cloud = _cloud(4, n=700)
    kp = cloud[::37, :3] + np.float32(0.2)
    kp[0] = [500.0, 500.0, 0.0]                           # an empty ball
    pipe = _port(v)
    _assert_same(pipe.extract(cloud, keypoints=kp), jpipe.extract(cloud, keypoints=kp))
    got = pipe.extract(cloud, rng=np.random.RandomState(5))
    _assert_same(got, jpipe.extract(cloud, rng=np.random.RandomState(5)))


def test_process_directory_and_cli(jax_setup, tmp_path, monkeypatch):
    """Both packages write the same [xyz | descriptor] files; the CLI with
    --variables and --device cpu writes them too; the external-keypoints
    directory is read as <name>_kp.bin."""
    from feat3dnet_tpu_torch.cli import infer

    jpipe, v = jax_setup
    data, kp_dir = tmp_path / "data", tmp_path / "kp"
    data.mkdir()
    kp_dir.mkdir()
    for i, name in enumerate(("a.bin", "b.bin")):
        c = _cloud(10 + i, n=600)
        c.tofile(str(data / name))
        c[::50, :3].copy().tofile(str(kp_dir / (name[:-4] + "_kp.bin")))
    logs = []
    pipe = _port(v)
    assert pipe.process_directory(str(data), str(tmp_path / "ours"), log=logs.append) == 2
    jpipe.process_directory(str(data), str(tmp_path / "jax"), log=lambda *_: None)
    assert len(logs) == 2 and "keypoints" in logs[0]
    for name in ("a.bin", "b.bin"):
        ours = np.fromfile(str(tmp_path / "ours" / name), np.float32).reshape(-1, 19)
        theirs = np.fromfile(str(tmp_path / "jax" / name), np.float32).reshape(-1, 19)
        assert ours.shape == theirs.shape and ours.shape[0] > 0
        np.testing.assert_array_equal(ours[:, :3], theirs[:, :3])
        np.testing.assert_allclose(ours[:, 3:], theirs[:, 3:], rtol=1e-4, atol=1e-5)

    pipe.process_directory(str(data), str(tmp_path / "ext"), keypoints_dir=str(kp_dir),
                           log=lambda *_: None)
    ext = np.fromfile(str(tmp_path / "ext" / "a.bin"), np.float32).reshape(-1, 19)
    np.testing.assert_array_equal(ext[:, :3], np.fromfile(
        str(kp_dir / "a_kp.bin"), np.float32).reshape(-1, 3))
    # batch_size > 1 (extract_batch; the per-file loop off the hashed route)
    # writes the same files
    pipe.process_directory(str(data), str(tmp_path / "x"), batch_size=2, log=lambda *_: None)
    for name in ("a.bin", "b.bin"):
        np.testing.assert_array_equal(np.fromfile(str(tmp_path / "x" / name), np.float32),
                                      np.fromfile(str(tmp_path / "ours" / name), np.float32))

    npz = str(tmp_path / "v.npz")
    save_variables_npz(npz, v)
    args = ["--data_dir", str(data), "--output_dir", str(tmp_path / "cli"),
            "--variables", npz, "--num_samples", "8", "--feature_dim", "16",
            "--nms_radius", "1.0", "--max_keypoints", "64"]
    # the CLI, like the JAX one, exposes no tower widths: run it at this
    # test's small widths and chunk
    import feat3dnet_tpu_torch.config as tcfg

    towers = {k: MODEL[k] for k in ("detector_mlp", "detector_mlp2", "descriptor_mlp")}
    monkeypatch.setattr(tcfg, "ModelConfig", lambda **kw: ModelConfig(**kw, **towers))
    monkeypatch.setattr(tcfg, "InferenceConfig",
                        lambda **kw: InferenceConfig(**kw, keypoint_chunk=256))
    infer.main(args + ["--device", "cpu"])
    for name in ("a.bin", "b.bin"):
        np.testing.assert_array_equal(
            np.fromfile(str(tmp_path / "cli" / name), np.float32),
            np.fromfile(str(tmp_path / "ours" / name), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer.main(args + ["--device", "cuda"])
    with pytest.raises(SystemExit):
        infer.main(args + ["--checkpoint", "ckpt"])
