"""Port of ops/nms against JAX: radius NMS and keypoint selection.

Selection is fed JAX's own attention array (with injected exact ties), so
the comparison is index-exact and separates selection from tower
rounding: the top-k must break ties to the lower index as jax.lax.top_k
does, NMS must keep tied neighbours (>=), invalid attention is zeroed
before the min_response_ratio floor, and empty slots repeat slot 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feat3dnet_tpu.ops import nms as jnms
from feat3dnet_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)


def _inputs(seed, b=2, n=700, spread=15.0):
    rs = np.random.RandomState(seed)
    xyz = ((rs.rand(b, n, 3) - 0.5) * spread).astype(np.float32)
    att = (rs.rand(b, n) + 0.01).astype(np.float32)
    att[:, 5] = att[:, 6] = att[:, 7] = np.float32(0.95)      # exact ties
    xyz[:, 6] = xyz[:, 5] + 0.1                               # tied neighbours
    att[:, 300:340] = np.float32(0.5)                         # a plateau of ties
    valid = rs.rand(b, n) > 0.2
    valid[:, 5:8] = True
    return xyz, att, valid


@pytest.mark.parametrize("masked", [False, True])
def test_nms_keypoints_matches_jax(masked):
    xyz, att, valid = _inputs(0)
    v = valid if masked else None
    want = jnms.nms_keypoints(jnp.asarray(xyz), jnp.asarray(att), 1.0, 128, 1e-2,
                              valid_mask=None if v is None else jnp.asarray(v), tile=256)
    got = tnms.nms_keypoints(torch.from_numpy(xyz), torch.from_numpy(att), 1.0, 128, 1e-2,
                             valid_mask=None if v is None else torch.from_numpy(v), tile=256)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[2].numpy() > 0).all()


@pytest.mark.parametrize("k,ratio", [(64, 1e-2), (700, 0.0), (32, 0.9)])
def test_select_keypoints_index_exact(k, ratio):
    """is_max from JAX's own dense rule; every tie class present; a budget
    below, at and above the number of survivors."""
    xyz, att, valid = _inputs(1)
    is_max = (np.random.RandomState(2).rand(*att.shape) > 0.5)
    is_max[:, 300:340] = True
    jx, ja, jn, ji = jnms.select_keypoints(
        jnp.asarray(xyz), jnp.asarray(att), jnp.asarray(is_max), k, ratio,
        valid_mask=jnp.asarray(valid), return_indices=True)
    tx, ta, tn, ti = tnms.select_keypoints(
        torch.from_numpy(xyz), torch.from_numpy(att), torch.from_numpy(is_max), k, ratio,
        valid_mask=torch.from_numpy(valid), return_indices=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert ti.dtype == torch.int32 and tn.dtype == torch.int32


def test_select_keypoints_pads_with_the_strongest():
    xyz = np.zeros((1, 10, 3), np.float32)
    xyz[0, :, 0] = np.arange(10)
    att = np.array([[0.1, 0.9, 0.3, 0.9, 0.2, 0, 0, 0, 0, 0]], np.float32)
    is_max = np.array([[1, 1, 0, 1, 0, 0, 0, 0, 0, 0]], bool)
    kp, ka, num = tnms.select_keypoints(torch.from_numpy(xyz), torch.from_numpy(att),
                                        torch.from_numpy(is_max), 6, 0.0)
    assert num.tolist() == [3]
    assert kp[0, :, 0].tolist() == [1, 3, 0, 1, 1, 1]          # ties: lower index first
    assert ka[0].tolist() == pytest.approx([0.9, 0.9, 0.1, 0.9, 0.9, 0.9])
    with pytest.raises(ValueError, match="max_keypoints"):
        tnms.select_keypoints(torch.from_numpy(xyz), torch.from_numpy(att),
                              torch.from_numpy(is_max), 11, 0.0)
