"""K1's cluster design (csrc/fps.cu), emulated in numpy, against the plain
version and the JAX package.

The kernel runs only on a card, so its design is held here by a numpy
emulation of the same steps in float32: the cloud cut into C contiguous
slices of ceil(N / C) points (one per block of the cluster); a masked
point's running minimum starting at -inf, so that fminf keeps its score at
-inf without the mask; per step each slice's argmax (ties to the lowest
index), then the slices' winners combined in rank order, each beating the
running winner only with a larger value or an equal value and a lower
index; the next step's centre the winner's coordinates. For C = 1, 2, 4, 8
and 16 it must equal `farthest_point_sample_scan` and the JAX package's
`farthest_point_sample_scan`, also with duplicated points that straddle
slice boundaries, a slice that is wholly masked and an all-masked cloud.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feat3dnet_tpu.ops import fps as jfps
from feat3dnet_tpu_torch.ops import fps as tfps

F32 = np.float32
INT_MAX = 0x7FFFFFFF


def _better(v, i, bv, bi):
    """f3d::argmax_better: (v, i) beats (bv, bi), ties to the lowest index."""
    return v > bv or (v == bv and i < bi)


def fps_cluster(xyz, npoint, mask, clusters):
    """Emulated K1 on a cluster of `clusters` blocks: (B, N, 3) f32 ->
    (B, npoint) int32."""
    b, n, _ = xyz.shape
    slice_ = -(-n // clusters)
    out = np.zeros((b, npoint), np.int32)
    for k in range(b):
        p = xyz[k].astype(F32)
        mind = np.full((n,), F32(1e38), F32)
        if mask is not None:
            mind[~mask[k]] = -np.inf
        s = p[0]
        for j in range(1, npoint):
            d = p - s
            d = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            mind = np.fmin(mind, d)
            win_v, win_i = -np.inf, INT_MAX
            for r in range(clusters):                     # rank order
                lo, hi = min(r * slice_, n), min((r + 1) * slice_, n)
                if hi <= lo:
                    continue                              # an empty slice: (-inf, INT_MAX)
                q = lo + int(np.argmax(mind[lo:hi]))      # first maximum of the slice
                if _better(mind[q], q, win_v, win_i):
                    win_v, win_i = mind[q], q
            out[k, j] = win_i
            s = p[win_i]
    return out


def _cloud(case, rs):
    """(xyz (B, N, 3), mask or None, npoint) of one case."""
    if case == "random":
        return rs.randn(3, 600, 3).astype(F32) * 5.0, None, 64
    if case == "duplicates_across_slices":
        # N = 512: the same points at the ends and starts of the slices of
        # every cluster size, so equal running minima straddle the slices
        xyz = rs.randn(2, 512, 3).astype(F32) * 4.0
        for cut in (32, 64, 128, 256):
            xyz[:, cut - 8:cut] = xyz[:, cut:cut + 8]
        xyz[:, 400:480] = xyz[:, :80]
        return xyz, None, 96
    if case == "masked_slice":
        # N = 999 (slices of unequal length); a quarter masked at random,
        # rank 0's whole slice under every C >= 4, and the last points
        xyz = rs.randn(2, 999, 3).astype(F32) * 3.0
        mask = rs.rand(2, 999) > 0.25
        mask[:, :250] = False
        mask[1, 900:] = False
        return xyz, mask, 80
    if case == "all_masked":
        xyz = rs.randn(2, 300, 3).astype(F32)
        mask = np.ones((2, 300), bool)
        mask[1] = False                                   # repeats index 0
        return xyz, mask, 16
    if case == "tiny":
        # fewer points than some clusters have blocks: empty slices
        return rs.randn(1, 11, 3).astype(F32), None, 11
    raise KeyError(case)


CASES = ["random", "duplicates_across_slices", "masked_slice", "all_masked", "tiny"]


@pytest.mark.parametrize("case", CASES)
def test_cluster_fps_equals_plain_and_jax(case):
    rs = np.random.RandomState(CASES.index(case))
    xyz, mask, npoint = _cloud(case, rs)
    want = tfps.farthest_point_sample_scan(
        torch.from_numpy(xyz), npoint, None if mask is None else torch.from_numpy(mask)).numpy()
    want_jax = np.asarray(jfps.farthest_point_sample_scan(
        jnp.asarray(xyz), npoint, None if mask is None else jnp.asarray(mask)))
    np.testing.assert_array_equal(want, want_jax)
    for clusters in (1, 2, 4, 8, 16):
        np.testing.assert_array_equal(fps_cluster(xyz, npoint, mask, clusters), want,
                                      err_msg=f"cluster {clusters}")
    if case == "all_masked":
        assert (want[1] == 0).all()
    if mask is not None:                   # after index 0, masked points never chosen
        for k in np.nonzero(mask.any(axis=1))[0]:
            assert mask[k][want[k, 1:]].all()


def test_cluster_size_choice():
    """The wrapper's cluster size: the smallest power of two, at most 16,
    whose slices hold at most _FPS_SLICE points."""
    s = tfps._FPS_SLICE
    assert tfps.fps_cluster_size(1) == 1
    assert tfps.fps_cluster_size(s) == 1
    assert tfps.fps_cluster_size(s + 1) == 2
    assert tfps.fps_cluster_size(16 * s) == 16
    assert tfps.fps_cluster_size(10 ** 6) == 16
    for n in (4096, 16384, 29291, 30609, 70000):
        c = tfps.fps_cluster_size(n)
        assert c == 16 or -(-n // c) <= s
        assert c == 1 or -(-n // (c // 2)) > s
