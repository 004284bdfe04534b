"""Port model (feat3dnet_tpu_torch.models) against the JAX Feat3DNet.

The JAX model's own `init` makes the weights (BN statistics perturbed so
folding and BN are exercised); the weight bridge loads them into the port.
Both see the same numpy clouds. Keypoints must be equal; features and
attention agree within rtol 1e-4 / atol 1e-5 (f32, the two frameworks
sum the tower products in different orders); orientation within 1e-4 as
an angle difference wrapped to (-pi, pi].
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.models import Feat3DNet as JaxFeat3DNet
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models import Feat3DNet, get_network
from feat3dnet_tpu_torch.utils import (init_variables, load_variables,
                                       state_dict_from_variables)

torch.set_num_threads(2)

SMALL = dict(num_samples=16, detector_mlp=(16, 32), detector_mlp2=(16, 8),
             descriptor_mlp=(8, 16), feature_dim=16)


def _jax_variables(cfg_kw, cloud, keypoints=None, seed=0):
    rng = np.random.RandomState(seed)
    model = JaxFeat3DNet(JaxModelConfig(**cfg_kw))
    kp = None if keypoints is None else jnp.asarray(keypoints)
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(cloud), training=False,
                   keypoints=kp)
    v = jax.tree.map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32) if x.ndim == 1 else x, v)
    # variances must stay positive
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.abs(x) + 0.5 if "var" in jax.tree_util.keystr(p) else x, v)
    return model, v


def _wrapped(a, b):
    d = np.asarray(a) - np.asarray(b)
    return np.abs((d + np.pi) % (2 * np.pi) - np.pi)


def _compare(cfg_kw, cloud, keypoints=None, mask=None):
    jmodel, v = _jax_variables(cfg_kw, cloud, keypoints)
    want = jmodel.apply(v, jnp.asarray(cloud), training=False,
                        keypoints=None if keypoints is None else jnp.asarray(keypoints),
                        valid_mask=None if mask is None else jnp.asarray(mask))
    model = load_variables(Feat3DNet(ModelConfig(**cfg_kw)),
                           jax.tree.map(np.asarray, v)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(cloud),
                    keypoints=None if keypoints is None else torch.from_numpy(keypoints),
                    valid_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.keypoints.numpy(), np.asarray(want.keypoints))
    np.testing.assert_array_equal(got.end_points["det_cnt"].numpy(),
                                  np.asarray(want.end_points["det_cnt"]))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention),
                               rtol=1e-4, atol=1e-5)
    assert _wrapped(got.orientation.numpy(), want.orientation).max() <= 1e-4
    return got


@pytest.mark.parametrize("mode", ["fps", "fps_masked", "every_point", "keypoints"])
def test_forward_matches_jax(rng, mode):
    cloud = (rng.randn(2, 160, 3) * 2.0).astype(np.float32)
    kw = dict(SMALL, num_clusters=24)
    keypoints = mask = None
    if mode == "fps_masked":
        mask = rng.rand(2, 160) > 0.25
    elif mode == "every_point":
        kw["num_clusters"] = -1
        cloud = cloud[:, :48].copy()
    elif mode == "keypoints":
        keypoints = (cloud[:, :10] + 0.3 * rng.randn(2, 10, 3)).astype(np.float32)
    _compare(kw, cloud, keypoints, mask)


def test_forward_matches_jax_paper_width(rng):
    """Paper widths (64-128-256 / 128-64 / 32-64 / 128 / 32), 64 FPS
    clusters of 64 samples on a 1024-point cloud."""
    cloud = (rng.randn(1, 1024, 3) * 3.0).astype(np.float32)
    got = _compare(dict(num_clusters=64), cloud)
    assert got.features.shape == (1, 64, 32)


def test_forward_without_bn_matches_jax(rng):
    cloud = (rng.randn(1, 120, 3) * 2.0).astype(np.float32)
    _compare(dict(SMALL, num_clusters=16, use_bn=False), cloud)


def test_bridge_raises_on_missing_and_unused_keys():
    v = init_variables(ModelConfig(**SMALL, num_clusters=8))   # the flax tree (test below)
    model = Feat3DNet(ModelConfig(**SMALL, num_clusters=8))
    state_dict_from_variables(v, model)                      # complete tree loads
    missing = jax.tree.map(lambda x: x, v)
    del missing["params"]["description"]["conv_mid_0"]["conv2d"]["bias"]
    with pytest.raises(KeyError, match="conv_mid_0/conv2d/bias"):
        state_dict_from_variables(missing, model)
    extra = jax.tree.map(lambda x: x, v)
    extra["params"]["detection"]["conv9"] = {"conv2d": {"kernel": np.zeros((3, 3))}}
    with pytest.raises(KeyError, match="conv9"):
        state_dict_from_variables(extra, model)


@pytest.mark.parametrize("use_bn", [True, False])
def test_init_variables_has_the_flax_tree(use_bn):
    """utils/init.py makes the tree model.init makes: same paths, shapes,
    dtypes; lecun-normal kernels have the flax spread."""
    kw = dict(num_clusters=8, use_bn=use_bn)
    model = JaxFeat3DNet(JaxModelConfig(**kw))
    v = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 3)),
                                          training=False))
    assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(v))
    ours = init_variables(ModelConfig(**kw), seed=3, bn_perturb=0.1)
    flat_j = {jax.tree_util.keystr(p): x.shape
              for p, x in jax.tree_util.tree_leaves_with_path(v)}
    flat_t = {jax.tree_util.keystr(p): x.shape
              for p, x in jax.tree_util.tree_leaves_with_path(ours)}
    assert flat_t == flat_j
    k = ours["params"]["detection"]["conv2"]["conv2d"]["kernel"]
    assert k.dtype == np.float32 and abs(k.std() * np.sqrt(128) - 1.0) < 0.05
    load_variables(Feat3DNet(ModelConfig(**kw)), ours)


def test_training_mode_waits_for_its_slice(rng):
    model = load_variables(Feat3DNet(ModelConfig(**SMALL, num_clusters=4)),
                           init_variables(ModelConfig(**SMALL, num_clusters=4)))
    with pytest.raises(NotImplementedError):
        model(torch.from_numpy(rng.randn(1, 20, 3).astype(np.float32)), training=True)


def test_registry():
    assert get_network("3DFeatNet") is Feat3DNet
    with pytest.raises(KeyError):
        get_network("PointNet")
