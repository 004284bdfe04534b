"""Port point ops (feat3dnet_tpu_torch.ops) against the JAX package.

Inputs are numpy arrays from a seed and go through both packages. FPS and
the ball query must agree index for index; the gathers must be equal.
CPU tensors take the plain versions of kernels K1/K2 (the kernels
themselves are held against those on a card in test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feat3dnet_tpu.ops.batch_group import ball_query_fused as jax_ball_query_fused
from feat3dnet_tpu.ops.fps import farthest_point_sample_scan as jax_fps_scan
from feat3dnet_tpu.ops.neighborhoods import (ball_query as jax_ball_query,
                                             gather_points as jax_gather_points,
                                             group_points as jax_group_points)
from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
from feat3dnet_tpu_torch.ops import (ball_query, farthest_point_sample,
                                     gather_points, group_points)
from feat3dnet_tpu_torch.ops.batch_group import ball_query_fused
from feat3dnet_tpu_torch.ops.fps import farthest_point_sample_scan
from feat3dnet_tpu_torch.ops.neighborhoods import ball_query_plain, pairwise_sqdist

torch.set_num_threads(2)


def _fps_case(name, rng):
    if name == "random":
        return rng.randn(2, 300, 3).astype(np.float32) * 3.0, None, 40
    if name == "ties":
        base = rng.randn(1, 60, 3).astype(np.float32)
        return np.concatenate([base, base, base[:, :20]], axis=1), None, 50
    if name == "mask":
        xyz = rng.randn(2, 256, 3).astype(np.float32) * 2.0
        mask = rng.rand(2, 256) > 0.4
        xyz[~mask] += 50.0                      # masked points would win if allowed
        return xyz, mask, 48
    cloud = load_point_cloud(example_cloud_path("oxford_270.bin"))[:, :3]
    sub = rng.choice(cloud.shape[0], 4096, replace=False)
    return cloud[None, np.sort(sub)].copy(), None, 64


@pytest.mark.parametrize("case", ["random", "ties", "mask", "oxford_4096"])
def test_fps_plain_matches_jax(rng, case):
    xyz, mask, npoint = _fps_case(case, rng)
    want = np.asarray(jax_fps_scan(
        jnp.asarray(xyz), npoint,
        valid_mask=None if mask is None else jnp.asarray(mask)))
    got = farthest_point_sample(torch.from_numpy(xyz), npoint,
                                None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if mask is not None:
        assert np.take_along_axis(mask, got.numpy().astype(np.int64), 1).all()


def _bq_case(name, rng):
    """(xyz, centers, radius, ns, mask)."""
    if name == "random":
        xyz = rng.randn(2, 200, 3).astype(np.float32) * 2.0
        return xyz, xyz[:, ::7].copy(), 1.5, 12, None
    if name == "saturated":
        xyz = rng.rand(2, 120, 3).astype(np.float32) * 0.2
        return xyz, xyz[:, :10].copy(), 1.0, 16, None
    if name == "empty":
        xyz = rng.randn(1, 90, 3).astype(np.float32)
        ctr = np.concatenate([xyz[:, :5], xyz[:, 5:10] + 30.0], axis=1)
        return xyz, ctr, 0.8, 8, None
    if name == "at_radius":
        # points exactly at distance r (not in the strict ball) and just inside
        axis = np.eye(3, dtype=np.float32)
        pts = np.concatenate([axis * 2.0, -axis * 2.0, axis * 1.5,
                              rng.randn(20, 3).astype(np.float32) * 3.0])[None]
        return pts, np.zeros((1, 3, 3), np.float32) + np.float32([[0], [0.5], [1]]), 2.0, 10, None
    xyz = rng.randn(2, 160, 3).astype(np.float32) * 1.5
    mask = rng.rand(2, 160) > 0.3
    ctr = np.concatenate([xyz[:, :8], xyz[:, 8:12] + 25.0], axis=1)
    return xyz, ctr, 1.2, 10, mask


@pytest.mark.parametrize("case", ["random", "saturated", "empty", "at_radius", "mask"])
def test_ball_query_plain_matches_jax(rng, case):
    xyz, ctr, radius, ns, mask = _bq_case(case, rng)
    jm = None if mask is None else jnp.asarray(mask)
    want_idx, want_cnt = jax_ball_query(jnp.asarray(xyz), jnp.asarray(ctr), radius, ns,
                                        valid_mask=jm)
    tm = None if mask is None else torch.from_numpy(mask)
    idx, cnt = ball_query(torch.from_numpy(xyz), torch.from_numpy(ctr), radius, ns, tm)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    if mask is None:
        # the JAX Pallas kernel (interpreted) holds the same contract
        f_idx, f_cnt = jax_ball_query_fused(jnp.asarray(xyz), jnp.asarray(ctr), radius,
                                            ns, tile=8, interpret=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(f_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(f_cnt))


def test_ball_query_at_radius_is_strict():
    xyz = np.array([[[2.0, 0, 0], [0, 1.999, 0], [0, 0, 2.0]]], np.float32)
    idx, cnt = ball_query(torch.from_numpy(xyz), torch.zeros(1, 1, 3), 2.0, 4)
    assert cnt.item() == 1 and idx.tolist() == [[[1, 1, 1, 1]]]


def test_pairwise_sqdist_matches_jax(rng):
    from feat3dnet_tpu.ops.neighborhoods import pairwise_sqdist as jax_sqdist

    a = rng.randn(2, 5, 3).astype(np.float32) * 100.0
    b = rng.randn(2, 7, 3).astype(np.float32) * 100.0
    np.testing.assert_array_equal(
        pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_sqdist(jnp.asarray(a), jnp.asarray(b))))


def test_group_and_gather_points_equal(rng):
    pts = rng.randn(2, 50, 4).astype(np.float32)
    idx = rng.randint(0, 50, size=(2, 6, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        group_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy(),
        np.asarray(jax_group_points(jnp.asarray(pts), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        gather_points(torch.from_numpy(pts), torch.from_numpy(idx[:, :, 0])).numpy(),
        np.asarray(jax_gather_points(jnp.asarray(pts), jnp.asarray(idx[:, :, 0]))))


def test_cpu_tensors_take_the_plain_versions(rng):
    xyz = torch.from_numpy(rng.randn(1, 64, 3).astype(np.float32))
    n_fps, n_bq = farthest_point_sample.launches, ball_query_fused.launches
    np.testing.assert_array_equal(farthest_point_sample(xyz, 8).numpy(),
                                  farthest_point_sample_scan(xyz, 8).numpy())
    got = ball_query_fused(xyz, xyz[:, :4].contiguous(), 1.0, 8)
    want = ball_query_plain(xyz, xyz[:, :4].contiguous(), 1.0, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (farthest_point_sample.launches, ball_query_fused.launches) == (n_fps, n_bq)

