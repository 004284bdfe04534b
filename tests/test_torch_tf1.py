"""The port's TF1 loader (utils/tf1_loader.py) and --tf1_checkpoint in its
CLIs, against the JAX package's (tests/test_checkpoint.py's cases) on the
CPU. Names and arrays must be identical (restore, skip and export are
numpy in both packages); the golden fixture through the port's model at
rtol = atol = 1e-5, the limit of the JAX test; cli.infer --tf1_checkpoint
bit-equal to --variables on the same weights.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu.utils import tf1_loader as jtf1
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.utils import init_variables, load_variables
from feat3dnet_tpu_torch.utils import tf1_loader as tf1
from feat3dnet_tpu_torch.utils.convert import variables_from_module
from tests.test_checkpoint import CFG as JAX_CFG
from tests.test_checkpoint import _tf1_arrays_for

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
                  detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_variables(seed=0):
    return jax.tree.map(np.asarray, JaxFeat3DNet(JAX_CFG).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 3)), training=False))


def _arrays(seed=0):
    np.random.seed(seed)
    arrays = _tf1_arrays_for(_jax_variables())
    arrays["detection/conv9/conv2d/weights"] = np.zeros((1, 1, 4, 4), np.float32)  # not in model
    return arrays


@pytest.mark.parametrize("exclude", [None, ["detection"], ["description"]])
def test_restore_matches_jax(exclude):
    """The same restored / skipped names and arrays as JAX's loader, from
    the port's tree (as its model gives it) and from JAX's init."""
    arrays = _arrays()
    want, w_restored, w_skipped = jtf1.restore_tf1_variables(
        _jax_variables(), arrays, restore_exclude=exclude, ignore_missing=True)
    model = load_variables(Feat3DNet(CFG), _jax_variables())
    got, g_restored, g_skipped = tf1.restore_tf1_variables(
        variables_from_module(model), arrays, restore_exclude=exclude, ignore_missing=True)
    assert (g_restored, g_skipped) == (w_restored, w_skipped)
    assert "global_step" in g_skipped and "detection/conv9/conv2d/weights" in g_skipped
    load_variables(model, got)           # the restored tree loads into the model
    want, got = _flat(want), _flat(got)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(KeyError):        # strict: a name the model lacks raises
        tf1.restore_tf1_variables(variables_from_module(model), arrays)


def test_export_round_trip_and_reference_names():
    """export -> restore is the identity, the export equals JAX's on the
    same variables, and its names are exactly the reference Saver's."""
    rs = np.random.RandomState(0)
    src = jax.tree.map(lambda x: x + rs.randn(*x.shape).astype(np.float32),
                       _jax_variables(2))
    arrays = tf1.export_tf1_arrays(src)
    want = jtf1.export_tf1_arrays(src)
    assert arrays.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(arrays[k], want[k], err_msg=k)
    dst = variables_from_module(load_variables(Feat3DNet(CFG), _jax_variables(3)))
    restored, names, skipped = tf1.restore_tf1_variables(dst, arrays)
    assert not skipped and len(names) == len(arrays)
    back = _flat(restored)
    for k, v in _flat(src).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    np.random.seed(0)
    reference = {n for n in _tf1_arrays_for(_jax_variables())
                 if "Adam" not in n and n not in ("global_step", "beta1_power")}
    assert set(arrays) == reference


def test_shape_mismatch_raises():
    arrays = {"detection/conv0/conv2d/weights": np.zeros((1, 1, 5, 5), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        tf1.restore_tf1_variables(init_variables(CFG), arrays)
    with pytest.raises(ValueError, match="shape mismatch"):
        jtf1.restore_tf1_variables(_jax_variables(), arrays)


def test_golden_fixture_through_the_port():
    """tests/fixtures/tf1_golden.npz restored into the port's model gives
    tf1_golden_expected.npz (rtol = atol = 1e-5, the JAX test's limit)."""
    fdir = os.path.join(ROOT, "tests", "fixtures")
    arrays = dict(np.load(os.path.join(fdir, "tf1_golden.npz")))
    expected = np.load(os.path.join(fdir, "tf1_golden_expected.npz"))
    cfg = ModelConfig(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
                      detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))
    restored, names, skipped = tf1.restore_tf1_variables(init_variables(cfg, seed=9), arrays)
    assert not skipped
    model = load_variables(Feat3DNet(cfg), restored).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(expected["cloud"]),
                    keypoints=torch.from_numpy(expected["keypoints"]))
    np.testing.assert_allclose(out.features.numpy(), expected["features"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.end_points["attention"].numpy(), expected["attention"],
                               rtol=1e-5, atol=1e-5)


def test_cli_infer_tf1_checkpoint_equals_variables(tmp_path):
    """The trained ckpt4480 exported to TF1 names: cli.infer --tf1_checkpoint
    writes the files --variables writes, byte for byte (device cpu)."""
    from feat3dnet_tpu_torch.cli import infer
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.utils.convert import load_variables_npz

    npz = os.path.join(ROOT, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz")
    tf1_npz = str(tmp_path / "tf1.npz")
    np.savez(tf1_npz, **tf1.export_tf1_arrays(load_variables_npz(npz)))
    data = tmp_path / "data"
    data.mkdir()
    cloud = load_point_cloud(example_cloud_path("oxford_270.bin"))
    cloud[::8].tofile(str(data / "a.bin"))                           # 2 048 points
    common = ["--data_dir", str(data), "--device", "cpu", "--max_keypoints", "64"]
    infer.main(common + ["--output_dir", str(tmp_path / "v"), "--variables", npz])
    infer.main(common + ["--output_dir", str(tmp_path / "t"), "--tf1_checkpoint", tf1_npz])
    a, b = (open(tmp_path / d / "a.bin", "rb").read() for d in ("v", "t"))
    assert len(a) == 64 * 35 * 4 and a == b
    with pytest.raises(SystemExit, match="JAX package"):
        infer.main(common + ["--output_dir", str(tmp_path / "c"), "--checkpoint", "x"])


@pytest.mark.parametrize("exclude", [None, "detection"])
def test_cli_train_tf1_checkpoint_restores_as_jax(tmp_path, exclude):
    """cli.train --tf1_checkpoint (no epochs) in both packages: the restored
    scopes hold the same values; an excluded scope keeps each package's
    own seeded init."""
    from feat3dnet_tpu.cli import train as jax_train
    from feat3dnet_tpu_torch.cli import train
    from tests.test_torch_train import _write_dataset

    widths = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0)
    np.random.seed(1)
    arrays = tf1.export_tf1_arrays(jax.tree.map(
        lambda x: np.random.randn(*x.shape).astype(np.float32),
        init_variables(ModelConfig(**widths), seed=4)))
    arrays["global_step"] = np.int64(7)
    npz = str(tmp_path / "tf1.npz")
    np.savez(npz, **arrays)
    _write_dataset(tmp_path / "data", np.random.RandomState(3))
    args = ["--data_dir", str(tmp_path / "data"), "--num_points", "64",
            "--num_clusters", "8", "--num_samples", "8", "--feature_dim", "16",
            "--base_scale", "10", "--batch_size", "2", "--num_epochs", "0",
            "--tf1_checkpoint", npz] + (["--restore_exclude", exclude] if exclude else [])
    state = train.main(args + ["--log_dir", str(tmp_path / "port"), "--device", "cpu"])
    jstate = jax_train.main(args + ["--log_dir", str(tmp_path / "jax")])
    got = _flat(jax.tree.map(lambda t: t.numpy(), variables_from_module(state.model)))
    want = _flat(jax.tree.map(np.asarray, {"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    seeded = _flat(init_variables(ModelConfig(**widths), seed=0))
    assert got.keys() == want.keys()
    for k in want:
        if exclude and k.split("/")[1] == exclude:
            np.testing.assert_array_equal(got[k], seeded[k], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert state.step == int(jstate.step) == 0
