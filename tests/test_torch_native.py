"""The port's native point-cloud reader (utils/native.py,
csrc/host/pointcloud_io.cpp), TripletDataset's native branch, the int16
upload and the small numpy copies (data/io.save_point_cloud,
utils/synthetic.py) against the JAX package, on the CPU.

The reader is held bit for bit against the JAX package's committed
native/libf3dnative.so: the same xoshiro256** draws, and the crop's
squared distance as that library computes it (fma(z, z, fma(y, y, x x)),
which g++ -O3 -march=native contracts it to on an x86 with FMA; the
boundary case below puts points within a few ulps of the crop radius).
"""
import os
import threading

import numpy as np
import pytest

from feat3dnet_tpu.data import datagenerator as jdg
from feat3dnet_tpu.data import io as jio
from feat3dnet_tpu.data.quant import QUANT_MAX as JAX_QUANT_MAX
from feat3dnet_tpu.data.quant import quantize_clouds as jax_quantize
from feat3dnet_tpu.utils import native as jnative
from feat3dnet_tpu.utils import synthetic as jsyn
from feat3dnet_tpu_torch.data import datagenerator as tdg
from feat3dnet_tpu_torch.data import io as tio
from feat3dnet_tpu_torch.data.quant import QUANT_MAX, quantize_clouds
from feat3dnet_tpu_torch.utils import native, synthetic


def _cloud(kind, rs):
    if kind == "short":                    # fewer rows than num_points: padding
        return (rs.randn(90, 6) * 3.0).astype(np.float32)
    if kind == "boundary":                 # radii within a few ulps of 20 m
        d = rs.randn(4000, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = 20.0 + rs.randn(4000) * 2e-6
        return np.concatenate([d * r[:, None], rs.randn(4000, 3)], axis=1).astype(np.float32)
    return (rs.randn(3000, 6) * 12.0).astype(np.float32)


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    rs = np.random.RandomState(0)
    paths = {}
    for kind in ("wide", "short", "boundary"):
        paths[kind] = str(root / f"{kind}.bin")
        _cloud(kind, rs).tofile(paths[kind])
    return paths


@pytest.mark.parametrize("kind,radius,points", [
    ("wide", 20.0, 256), ("wide", 5.0, 64), ("wide", 0.0, 1000), ("wide", 20.0, 3000),
    ("short", 20.0, 256), ("boundary", 20.0, 512), ("boundary", 20.0, 5000)])
def test_load_processed_matches_jax(clouds, kind, radius, points):
    for seed in (0, 1, 7, 2**31 - 1, 2**40 + 3):
        got = native.load_processed(clouds[kind], 6, radius, points, seed)
        want = jnative.load_processed(clouds[kind], 6, radius, points, seed)
        assert got.shape == (points, 6) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_load_processed_batch_matches_jax(clouds, threads):
    paths = [clouds[k] for k in ("wide", "short", "boundary", "wide", "boundary")]
    seeds = [3, 4, 5, 6, 7]
    got = native.load_processed_batch(paths, 6, 20.0, 384, seeds, num_threads=threads)
    want = jnative.load_processed_batch(paths, 6, 20.0, 384, seeds, num_threads=threads)
    np.testing.assert_array_equal(got, want)
    for i, (p, s) in enumerate(zip(paths, seeds)):
        np.testing.assert_array_equal(got[i], native.load_processed(p, 6, 20.0, 384, s))


def test_failed_reads_raise(clouds, tmp_path):
    missing = str(tmp_path / "missing.bin")
    with pytest.raises(IOError, match="rc=-1"):
        native.load_processed(missing, 6, 20.0, 64, 0)
    with pytest.raises(IOError, match="missing.bin"):
        native.load_processed_batch([clouds["wide"], missing], 6, 20.0, 64, [0, 1])
    ragged = str(tmp_path / "ragged.bin")
    np.zeros(13, np.float32).tofile(ragged)              # not a whole number of rows
    with pytest.raises(IOError):
        native.load_processed(ragged, 6, 20.0, 64, 0)
    far = str(tmp_path / "far.bin")
    (np.ones((10, 6), np.float32) * 100.0).tofile(far)   # empty after the crop
    with pytest.raises(IOError, match="rc=-2"):
        native.load_processed(far, 6, 20.0, 64, 0)
    with pytest.raises(OSError):
        native.read_cloud(missing)


def test_read_cloud_and_save_point_cloud(clouds, tmp_path):
    want = tio.load_point_cloud(clouds["wide"])
    np.testing.assert_array_equal(native.read_cloud(clouds["wide"]), want)
    cloud = np.random.RandomState(2).randn(17, 6) * 3.0        # float64 in, float32 out
    tio.save_point_cloud(str(tmp_path / "a.bin"), cloud)
    jio.save_point_cloud(str(tmp_path / "b.bin"), cloud)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    np.testing.assert_array_equal(tio.load_point_cloud(str(tmp_path / "a.bin")),
                                  cloud.astype(np.float32))


def test_concurrent_first_builds(tmp_path, monkeypatch):
    """Threads building into an empty build directory at once: each gets a
    whole library at the same path, and no temporary directory is left."""
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path / "native"))
    results, errors = [], []

    def one():
        try:
            results.append(native.build.__wrapped__())
        except Exception as e:            # handed to the assertion below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(results) == 4 and not any(t.is_alive() for t in threads)
    assert len({r.path for r in results}) == 1 and os.path.isfile(results[0].path)
    assert os.listdir(tmp_path / "native") == [os.path.basename(os.path.dirname(
        results[0].path))]
    assert native.build.__wrapped__().seconds == 0.0          # reused


def _write_dataset(root, rs):
    os.makedirs(root)
    sizes = [300, 90, 250, 400, 180, 260, 310, 120]     # short clouds: duplicate-padding
    lines = []
    for i, n in enumerate(sizes):
        (rs.randn(n, 6) * 8.0).astype(np.float32).tofile(os.path.join(root, f"cloud_{i}.bin"))
        lines.append(f"cloud_{i}.bin | {(i + 1) % 8} {(i + 2) % 8} | {(i + 3) % 8}")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.join(root, "train.txt")


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_triplet_dataset_native_matches_jax(tmp_path, shard):
    meta = _write_dataset(str(tmp_path / "train"), np.random.RandomState(1))
    ours = tdg.TripletDataset(meta, seed=4, shard_index=shard[0], num_shards=shard[1],
                              use_native=True)
    theirs = jdg.TripletDataset(meta, seed=4, shard_index=shard[0], num_shards=shard[1],
                                use_native=True)
    assert ours.use_native is True and theirs.use_native is True
    for epoch in range(2):
        got = list(ours.epoch_triplets(epoch, 2, 128))
        want = list(theirs.epoch_triplets(epoch, 2, 128))
        assert len(got) == len(want) == 4 // shard[1]
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.shape == (2, 128, 6)
                np.testing.assert_array_equal(a, b)
    if shard == (0, 1):              # the numpy reader draws other resamples
        numpy_reader = tdg.TripletDataset(meta, seed=4, use_native="no")
        assert not np.array_equal(next(numpy_reader.epoch_triplets(1, 2, 128))[0], got[0][0])


def test_use_native_values(tmp_path, monkeypatch):
    meta = _write_dataset(str(tmp_path / "train"), np.random.RandomState(1))
    assert tdg.TripletDataset(meta).use_native is True              # "auto": it builds here
    for value in ("no", False, "false", None):
        assert tdg.TripletDataset(meta, use_native=value).use_native is False
    for value in (True, "true", "yes"):
        assert tdg.TripletDataset(meta, use_native=value).use_native is True

    def unbuildable():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "library", unbuildable)
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert tdg.TripletDataset(meta).use_native is False             # "auto": numpy
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tdg.TripletDataset(meta, use_native=True)


@pytest.mark.parametrize("case", ["clouds", "zeros", "extremes"])
def test_quantize_clouds_matches_jax(case):
    rs = np.random.RandomState(5)
    x = {"clouds": rs.randn(4, 18, 256, 3).astype(np.float32) * 30.0,
         "zeros": np.zeros((6, 64, 3), np.float32),
         "extremes": np.array([[-50.0, 0.0, 49.99], [1e-9, -1e-9, 25.0]], np.float32)}[case]
    q, scale = quantize_clouds(x)
    jq, jscale = jax_quantize(x)
    assert QUANT_MAX == JAX_QUANT_MAX
    assert q.dtype == np.int16 and isinstance(scale, np.float32)
    np.testing.assert_array_equal(q, jq)
    assert scale == jscale
    if case != "zeros":
        # half a step, and the f32 roundings of x / scale and q * scale
        bound = scale / 2 + 2 * np.spacing(np.abs(x).max())
        assert np.abs(q.astype(np.float32) * scale - x).max() <= bound


def test_synthetic_matches_jax():
    for n, seed in ((1000, 7), (5000, 3)):
        np.testing.assert_array_equal(synthetic.synthetic_submap(n, seed),
                                      jsyn.synthetic_submap(n, seed))

    class Res:
        def __init__(self, kp, att):
            self.keypoints, self.attention, self.num_keypoints = kp, att, len(kp) - 1

    rs = np.random.RandomState(0)
    kp = rs.randn(9, 3).astype(np.float32)
    att = rs.rand(9).astype(np.float32)
    a = Res(kp, att)
    b = Res(np.concatenate([kp[:5], rs.randn(4, 3).astype(np.float32)]), att * 1.01)
    c = Res(rs.randn(9, 3).astype(np.float32), att)
    for x, y in ((a, b), (a, a), (a, c)):
        assert synthetic.keypoint_agreement(x, y) == jsyn.keypoint_agreement(x, y)
