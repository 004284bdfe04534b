"""The trained checkpoint as the port reads it.

`export_ckpt4480` restores examples/results/scaled_accuracy/ckpt/4480 with
the JAX package's own Orbax restore (the widths of
examples/eval_inference_sweep.py) and writes {params, batch_stats} as the
flat npz the port loads (utils/convert.load_variables_npz). The committed
copy is feat3dnet_tpu_torch/assets/ckpt4480_variables.npz; to rebuild it:

    python -c "from tests.test_torch_checkpoint import export_ckpt4480; export_ckpt4480()"

The tests hold the committed file to a fresh restore, leaf for leaf, and
the port's model loaded from it to the JAX model on one small cloud.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.utils import (load_variables, load_variables_npz,
                                       save_variables_npz)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "examples", "results", "scaled_accuracy", "ckpt")
NPZ = os.path.join(ROOT, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz")


def restore_ckpt4480():
    """{params, batch_stats} of ckpt/4480 as numpy, through the JAX
    package's CheckpointManager.restore(init_state(...))."""
    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
    from feat3dnet_tpu.config import TrainConfig
    from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
    from feat3dnet_tpu.train.trainer import init_state
    from feat3dnet_tpu.utils.checkpoint import CheckpointManager

    cfg = JaxModelConfig(num_clusters=256, num_samples=64)
    state, _ = init_state(JaxFeat3DNet(cfg), TrainConfig(batch_size=6, num_points=4096),
                          cfg, jax.random.PRNGKey(0))
    mgr = CheckpointManager(CKPT)
    assert mgr.latest_step() == 4480
    state = mgr.restore(state)
    return jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})


def export_ckpt4480(path: str = NPZ) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_variables_npz(path, restore_ckpt4480())
    return path


@pytest.fixture(scope="module")
def restored():
    return restore_ckpt4480()


def test_committed_npz_equals_a_fresh_restore(restored):
    assert os.path.getsize(NPZ) < 2 * 1024 * 1024
    ours = load_variables_npz(NPZ)
    want = {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_leaves_with_path(restored)}
    got = {jax.tree_util.keystr(p): x
           for p, x in jax.tree_util.tree_leaves_with_path(ours)}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_npz_round_trip(tmp_path, restored):
    path = str(tmp_path / "v.npz")
    save_variables_npz(path, restored)
    back = load_variables_npz(path)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(restored),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        load_variables_npz(str(tmp_path / "missing.npz"))


def test_port_model_from_npz_matches_jax(restored):
    """The trained weights through the npz and the bridge: the port's
    forward equals the JAX forward (keypoints exact, features and
    attention within rtol 1e-4 / atol 1e-5)."""
    from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
    from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet

    rs = np.random.RandomState(4)
    cloud = (rs.randn(1, 600, 3) * 3.0).astype(np.float32)
    kw = dict(num_clusters=32, num_samples=64)
    want = JaxFeat3DNet(JaxModelConfig(**kw)).apply(restored, jnp.asarray(cloud),
                                                    training=False)
    model = load_variables(Feat3DNet(ModelConfig(**kw)), load_variables_npz(NPZ)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(cloud))
    np.testing.assert_array_equal(got.keypoints.numpy(), np.asarray(want.keypoints))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention),
                               rtol=1e-4, atol=1e-5)
