"""K2's cluster design (csrc/ball_query.cu), emulated in numpy, against the
plain version and the JAX package.

The kernel runs only on a card, so its design is held here by a numpy
emulation of the same steps in float32, every operation rounded on its
own: a group of 32 centres a cluster of `cluster` CTAs of `warps` warps; the
cloud in rounds of cluster x warps x chunks 32-point chunks, warp v taking
the contiguous run [q0 + v q / V, q0 + (v + 1) q / V) of a round's q chunks;
a staged point (x, y, z), +inf where masked or past N; per warp and chunk a
hit mask (d2 < r2, d2 = ((dx dx) + dy dy) + dz dz of centre minus point)
and the chunk's smallest d2; per warp its hit count, the exclusive scan of
the counts in (round, rank, warp) order giving each hit its slot, the
group stopping after the first round in which each of its centres has ns
hits; the slot-0 index repeated past the count; for an empty ball each
warp's first chunk holding its smallest d2 searched again for that d2's
first index, the warps' candidates reduced with f3d::argmin_better. It
must equal `ball_query_plain` and the JAX package's ball query (XLA, and
the interpreted Pallas kernel where there is no mask) at the kernel's own
sizes (kWarps, kChunks and kMaxCluster, read from the kernel's source, and
the wrapper's cluster size on the H100's 132 SMs) and at small ones that
make a small cloud take several rounds.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feat3dnet_tpu.ops.batch_group import ball_query_fused as jax_ball_query_fused
from feat3dnet_tpu.ops.neighborhoods import ball_query as jax_ball_query
from feat3dnet_tpu_torch.ops import batch_group as bg
from feat3dnet_tpu_torch.ops.neighborhoods import ball_query_plain

F32 = np.float32
INT_MAX = 0x7FFFFFFF
H100_SMS = 132


def _k2_shape():
    """(kWarps, kChunks, kMaxCluster) as csrc/ball_query.cu defines them,
    the values kernels.ball_query_shape reads from the built library."""
    src = (pathlib.Path(bg.__file__).parents[1] / "csrc" / "ball_query.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kWarps", "kChunks", "kMaxCluster"))


K2_SHAPE = _k2_shape()


def _sqdist(c, p):
    """(L, 3) centres x (P, 3) points -> (L, P) f32, each operation rounded."""
    d = [(c[:, None, a] - p[None, :, a]).astype(F32) for a in range(3)]
    return ((d[0] * d[0]) + (d[1] * d[1])) + (d[2] * d[2])


def k2_scan(xyz, ctr, radius, ns, mask=None, cluster=None, warps=K2_SHAPE[0],
            chunks=K2_SHAPE[1], stats=None):
    """Emulated K2: (B, N, 3), (B, M, 3) f32 -> (idx (B, M, ns), cnt (B, M))
    int32. `stats`, a dict, collects the rounds each group ran."""
    b, n, _ = xyz.shape
    m = ctr.shape[1]
    r2 = F32(radius) * F32(radius)
    c = (bg.ball_query_cluster_size(b, m, n, K2_SHAPE, H100_SMS) if cluster is None
         else cluster)
    nchunks = -(-n // 32)
    nw = c * warps
    idx = np.zeros((b, m, ns), np.int32)
    cnt = np.zeros((b, m), np.int32)
    for k in range(b):
        pts = np.full((nchunks * 32, 3), np.inf, F32)
        pts[:n] = xyz[k]
        if mask is not None:
            pts[:n][~mask[k]] = np.inf
        for g0 in range(0, m, 32):
            lanes = ctr[k, g0:g0 + 32].astype(F32)
            nl = lanes.shape[0]
            out = idx[k, g0:g0 + nl]
            base = np.zeros(nl, np.int64)
            best_d = np.full((nw, nl), np.inf, F32)        # per warp, as the lanes keep it
            best_c = np.full((nw, nl), -1, np.int64)
            first = np.full(nl, -1, np.int64)
            rounds, q0 = 0, 0
            while q0 < nchunks:
                rounds += 1
                q = min(nw * chunks, nchunks - q0)
                runs = [(q0 + v * q // nw, q0 + (v + 1) * q // nw) for v in range(nw)]
                counts = np.zeros((nw, nl), np.int64)
                hits = {}
                for v, (c0, c1) in enumerate(runs):
                    assert c1 - c0 <= chunks
                    for ch in range(c0, c1):
                        d2 = _sqdist(lanes, pts[ch * 32:(ch + 1) * 32])
                        hits[v, ch] = d2 < r2
                        counts[v] += hits[v, ch].sum(1)
                        cmin = np.fmin.reduce(d2, axis=1)
                        better = cmin < best_d[v]
                        best_d[v][better] = cmin[better]
                        best_c[v][better] = ch
                # the exchange: each warp's exclusive prefix in (rank, warp) order
                pre = base[None, :] + np.cumsum(counts, axis=0) - counts
                for v, (c0, c1) in enumerate(runs):
                    for lane in range(nl):
                        pos = pre[v, lane]
                        for ch in range(c0, c1):
                            for j in np.flatnonzero(hits[v, ch][lane]):
                                if pos >= ns:
                                    break
                                if pos == 0:
                                    first[lane] = ch * 32 + j
                                out[lane, pos] = ch * 32 + j
                                pos += 1
                base += counts.sum(0)
                if (base >= ns).all():
                    break
                q0 += nw * chunks
            if stats is not None:
                stats.setdefault("rounds", []).append(rounds)
            cn = np.minimum(base, ns)
            cnt[k, g0:g0 + nl] = cn
            for lane in range(nl):
                if first[lane] >= 0:
                    out[lane, cn[lane]:] = first[lane]
                if base[lane] > 0:
                    continue
                d, i = F32(np.inf), INT_MAX
                for v in range(nw):               # each warp's candidate, then argmin_better
                    if best_c[v, lane] < 0:
                        continue
                    ch = best_c[v, lane]
                    d2 = _sqdist(lanes[lane:lane + 1], pts[ch * 32:(ch + 1) * 32])[0]
                    j = int(np.flatnonzero(d2 == best_d[v, lane])[0])
                    if best_d[v, lane] < d or (best_d[v, lane] == d and ch * 32 + j < i):
                        d, i = best_d[v, lane], ch * 32 + j
                out[lane, :] = 0 if i == INT_MAX else i
    return idx, cnt


def _case(name, rs):
    """(xyz, centres, radius, ns, mask or None) of one case."""
    if name == "random":
        xyz = rs.randn(2, 700, 3).astype(F32) * 2.0
        return xyz, xyz[:, ::9].copy(), 1.3, 16, None
    if name == "saturated":
        xyz = (rs.rand(2, 600, 3) * 0.3).astype(F32)
        return xyz, xyz[:, :40].copy(), 1.0, 64, None
    if name == "empty":
        xyz = rs.randn(1, 400, 3).astype(F32)
        ctr = np.concatenate([xyz[:, :20], xyz[:, 20:45] + 30.0], axis=1)
        return xyz, ctr, 0.7, 8, None
    if name == "ties_at_radius":
        # points at exactly r from a centre (d2 == r2 is not in the ball)
        ax = np.eye(3, dtype=F32)
        shell = np.concatenate([ax * 2.0, -ax * 2.0, ax * 1.5, -ax * 1.999])
        pts = np.concatenate([rs.randn(90, 3).astype(F32) * 3.0, shell,
                              rs.randn(200, 3).astype(F32) * 3.0])[None]
        ctr = np.zeros((1, 5, 3), F32)
        ctr[0, 1:, 0] = [0.5, 1.0, 0.25, -0.5]
        return pts, ctr, 2.0, 16, None
    if name == "duplicates":
        # the same points in several chunks and warps' runs: equal nearest
        # d2 across them (empty balls) and equal in-ball points
        base = rs.randn(1, 100, 3).astype(F32) * 3.0
        xyz = np.concatenate([base, base[:, ::-1], base, base[:, :33]], axis=1)
        ctr = np.concatenate([xyz[:, ::11], xyz[:, :12] + F32(20.0)], axis=1)
        return xyz, ctr, 1.5, 24, None
    if name == "masked":
        xyz = rs.randn(2, 900, 3).astype(F32) * 1.5
        mask = rs.rand(2, 900) > 0.3
        ctr = np.concatenate([xyz[:, :50], xyz[:, 50:70] + 25.0], axis=1)
        return xyz, ctr, 1.2, 32, mask
    if name == "all_masked":
        xyz = rs.randn(2, 300, 3).astype(F32)
        mask = np.zeros((2, 300), bool)
        mask[1, 150:] = rs.rand(150) > 0.5       # the second cloud keeps a few
        return xyz, xyz[:, :37].copy(), 1.0, 8, mask
    if name == "n1":
        xyz = rs.randn(1, 1, 3).astype(F32)
        ctr = np.concatenate([xyz, xyz + 5.0], axis=1)
        return xyz, ctr, 1.0, 4, None
    if name == "n31_ns_past_n":
        xyz = rs.randn(1, 31, 3).astype(F32)
        return xyz, xyz[:, :7].copy(), 2.5, 64, None
    if name == "ns1":
        xyz = rs.randn(2, 333, 3).astype(F32) * 2.0
        return xyz, xyz[:, ::5].copy(), 1.0, 1, None
    if name == "b3_ragged_m":
        # three different clouds, N off every chunk and round, M = 70 (not a
        # multiple of a group's 32 centres)
        xyz = np.stack([rs.randn(1001, 3) * s for s in (1.0, 2.5, 6.0)]).astype(F32)
        return xyz, xyz[:, 3::14][:, :70].copy(), 1.5, 64, None
    raise ValueError(name)


CASES = ("random", "saturated", "empty", "ties_at_radius", "duplicates", "masked",
         "all_masked", "n1", "n31_ns_past_n", "ns1", "b3_ragged_m")
# the kernel's own sizes (cluster: the wrapper's choice), and small ones so
# that a small cloud takes several rounds over several ranks
DESIGNS = {"kernel": {}, "c16": {"cluster": 16}, "small_rounds": {"cluster": 2, "warps": 2,
                                                                  "chunks": 2}}


@pytest.fixture
def rs():
    return np.random.RandomState(7)


@pytest.mark.parametrize("design", sorted(DESIGNS))
@pytest.mark.parametrize("case", CASES)
def test_k2_scan_matches_plain_and_jax(rs, case, design):
    xyz, ctr, radius, ns, mask = _case(case, rs)
    idx, cnt = k2_scan(xyz, ctr, radius, ns, mask, **DESIGNS[design])
    tm = None if mask is None else torch.from_numpy(mask)
    ip, cp = ball_query_plain(torch.from_numpy(xyz), torch.from_numpy(ctr), radius, ns, tm)
    np.testing.assert_array_equal(idx, ip.numpy())
    np.testing.assert_array_equal(cnt, cp.numpy())
    ji, jc = jax_ball_query(jnp.asarray(xyz), jnp.asarray(ctr), radius, ns,
                            valid_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_array_equal(cnt, np.asarray(jc))
    if mask is None:
        fi, fc = jax_ball_query_fused(jnp.asarray(xyz), jnp.asarray(ctr), radius, ns, tile=8,
                                      interpret=True)
        np.testing.assert_array_equal(idx, np.asarray(fi))
        np.testing.assert_array_equal(cnt, np.asarray(fc))


def test_k2_scan_stops_after_the_round_that_fills_every_ball(rs):
    """A dense cloud fills every ball in the first round of the small
    design; a sparse one runs every round, and both stay exact."""
    dense = (rs.rand(1, 2000, 3) * 0.5).astype(F32)
    sparse = rs.randn(1, 2000, 3).astype(F32) * 20.0
    for xyz, want in ((dense, 1), (sparse, -(-2000 // (2 * 2 * 2 * 32)))):
        stats = {}
        idx, cnt = k2_scan(xyz, xyz[:, :64].copy(), 1.0, 16, cluster=2, warps=2, chunks=2,
                           stats=stats)
        ip, cp = ball_query_plain(torch.from_numpy(xyz), torch.from_numpy(xyz[:, :64].copy()),
                                  1.0, 16)
        np.testing.assert_array_equal(idx, ip.numpy())
        np.testing.assert_array_equal(cnt, cp.numpy())
        assert stats["rounds"] == [want, want]


@pytest.mark.parametrize("b,m,n,want", [(1, 512, 16384, 16), (1, 512, 30609, 16),
                                        (2, 512, 16384, 8), (18, 512, 4096, 2),
                                        (1, 1, 1, 1), (1, 77, 3001, 4),
                                        (64, 512, 1024, 1), (1, 64, 200000, 16)])
def test_k2_cluster_size(b, m, n, want):
    """The wrapper's cluster size: one cloud's 16 groups take 16 CTAs each
    (256 CTAs), the training batch's 288 groups two each (one round); a
    small cloud keeps at least two chunks a warp."""
    assert bg.ball_query_cluster_size(b, m, n, K2_SHAPE, H100_SMS) == want
