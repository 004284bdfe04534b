"""K4's walk (csrc/sorted_ball_query.cu), emulated in numpy, against the
plain version and the JAX package.

The kernel runs only on a card, so its arithmetic is held here by a numpy
emulation of the same walk, in float32 with every operation rounded on its
own (as the kernel's __fmul_rn/__fadd_rn): per tile the hit row sorted by
each block's smallest key; per centre the cull with the block_hitmask gap
expression on the centre itself, the covered test (a block wholly inside
the ball counts without a test and yields its first rows), the skip once
the list is full and a block's smallest key exceeds its largest, and the
per-block gather cut at ns or at the first key above a full list's largest,
merged once per block. It must equal `sorted_ball_query_plain` (raw top and
count) and the JAX package's grouped query (Pallas interpret mode) on
adversarial clouds; the two box predicates are held against a
point-by-point test on random boxes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feat3dnet_tpu.ops import hash_grid as jhg
from feat3dnet_tpu_torch.ops import hash_grid as thg

torch.set_num_threads(2)

F32 = np.float32
BIG_KEY = F32(1e30)
INT_MAX = 0x7FFFFFFF


def _sq3(d):
    """((d0*d0) + d1*d1) + d2*d2 in float32, each operation rounded."""
    d = d.astype(F32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def gap_pass(c, bmin, bmax, r2):
    """The per-centre cull: the box [bmin, bmax] may hold a point with
    d2 < r2 (block_hitmask's gap expression, the centre a box of size 0)."""
    g = np.maximum(np.maximum(bmin - c, c - bmax), F32(0))
    return _sq3(g) < F32(r2)


def covered(c, bmin, bmax, r2):
    """Every point of the box [bmin, bmax] has d2 < r2."""
    f = np.maximum(np.abs(c - bmin), np.abs(c - bmax))
    return _sq3(f) < F32(r2)


def k4_walk(pts4, blk_bbox, centers, radius, ns, tile):
    """Emulated K4: (top (M, ns, 4), cnt (M,), stats): over all centres, the
    blocks scanned point by point, the blocks covered, the blocks visited
    after the skip (they only count) and the merges."""
    r2 = F32(thg._r2(radius))
    np_, nb = pts4.shape[0], blk_bbox.shape[0]
    L = np_ // nb
    m = centers.shape[0]
    keys = pts4[:, 3].astype(np.int64)
    hit = thg._padded_hitmask(torch.from_numpy(centers), torch.from_numpy(blk_bbox),
                              float(r2), tile).numpy().astype(bool)
    top = np.zeros((m, ns, 4), F32)
    top[..., 3] = BIG_KEY
    cnt = np.zeros((m,), np.int32)
    stats = dict(scanned=0, covered=0, skipped=0, merges=0)
    for t in range(hit.shape[0]):
        lst = np.nonzero(hit[t])[0]
        order = np.argsort(keys[lst * L], kind="stable")
        hits, hkey = lst[order], keys[lst * L][order]
        bmin, bmax = blk_bbox[hits, :3], blk_bbox[hits, 3:6]
        for c in range(t * tile, min((t + 1) * tile, m)):
            ctr = centers[c]
            near = gap_pass(ctr, bmin, bmax, r2)
            inside = near & covered(ctr, bmin, bmax, r2)
            lk = np.zeros((0,), np.int64)          # the running list's keys
            lr = np.zeros((0,), np.int64)          # and rows
            kmax, counting, total = INT_MAX, False, 0
            for j in np.nonzero(near)[0]:
                base = int(hits[j]) * L
                if not counting and lk.size == ns and hkey[j] > kmax:
                    counting = True
                stats["skipped"] += counting
                if inside[j]:
                    total += L
                    stats["covered"] += 1
                    if counting:
                        continue
                    rows = base + np.arange(min(ns, L))
                    rows = rows[keys[rows] < kmax]     # a prefix: keys ascend
                else:
                    d2 = _sq3(ctr - pts4[base:base + L, :3])
                    inb = d2 < r2
                    total += int(inb.sum())
                    stats["scanned"] += 1
                    if counting:
                        continue
                    got = []
                    for s0 in range(0, L, 32):          # 32 points a step
                        k = keys[base + s0:base + s0 + 32]
                        take = inb[s0:s0 + 32] & (k < kmax)
                        got.extend((base + s0 + np.nonzero(take)[0]).tolist())
                        if len(got) >= ns or k[-1] >= kmax:
                            break
                    rows = np.asarray(got[:ns], np.int64)
                if rows.size == 0:
                    continue
                stats["merges"] += 1
                ak = np.concatenate([lk, keys[rows]])
                ar = np.concatenate([lr, rows])
                o = np.argsort(ak, kind="stable")[:ns]
                lk, lr = ak[o], ar[o]
                if lk.size == ns:
                    kmax = int(lk[-1])
            top[c, :lr.size] = pts4[lr]
            cnt[c] = total
    return top, cnt, stats


def _layout(xyz, valid=None, block=64, bucket=None):
    n = xyz.shape[0]
    if bucket is not None:
        pad = np.zeros((bucket, 3), F32)
        pad[:n] = xyz
        valid = (np.arange(bucket) < n) if valid is None else np.pad(valid, (0, bucket - n))
        xyz = pad
    return thg.build_sorted_cloud_host(xyz, valid, cell_size=2.0, block_size=block)


def _case(name, rs):
    """(sorted cloud, centres, radius, tile) of one adversarial case."""
    if name == "sphere_ties":
        # points on the sphere of radius 3 around lattice centres: many at
        # d2 == r2 exactly after rounding, on an axis ((3, 0, 0)) and on a
        # diagonal ((1, 2, 2)); and a lattice, so box faces sit at the
        # centres' distance
        ctr = (rs.randint(-4, 5, (40, 3))).astype(F32)
        u = rs.randn(40, 12, 3)
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        shell = (ctr[:, None] + 3.0 * u).reshape(-1, 3)
        exact = np.array([[3, 0, 0], [0, -3, 0], [1, 2, 2], [-2, 1, -2]], F32)
        grid = np.stack(np.meshgrid(*[np.arange(-5, 6)] * 3), -1).reshape(-1, 3)
        xyz = np.concatenate([shell, (ctr[:, None] + exact).reshape(-1, 3), ctr,
                              grid[rs.rand(grid.shape[0]) < 0.4]]).astype(F32)
        sc = _layout(xyz[rs.permutation(xyz.shape[0])], block=32)
        return sc, sc.pts4[:, :3].copy(), 3.0, 24
    if name == "faces_dupes":
        xyz = np.round(rs.rand(500, 3) * 12.0).astype(F32)     # lattice: ties on faces
        xyz[200:260] = xyz[:60]                                  # duplicate points
        sc = _layout(xyz[rs.permutation(500)], block=32)
        return sc, sc.pts4[:, :3].copy(), 2.0, 32
    if name == "covered_cluster":
        # dense clusters: whole blocks lie inside a 2 m ball
        xyz = np.concatenate([rs.randn(300, 3) * 0.15, rs.randn(200, 3) * 0.2 + 6.0,
                              (rs.rand(100, 3) - 0.5) * 20]).astype(F32)
        sc = _layout(xyz[rs.permutation(600)], block=32)
        return sc, sc.pts4[:, :3].copy(), 2.0, 64
    if name == "padding_straddle":
        # a bucket a quarter padding (at +1e9, padding centres included);
        # tile 48 does not divide the real count, so a tile holds both
        xyz = ((rs.rand(372, 3) - 0.5) * 14.0).astype(F32)
        sc = _layout(xyz, valid=rs.rand(372) > 0.1, block=32, bucket=512)
        return sc, sc.pts4[:, :3].copy(), 2.0, 48
    if name == "far_centres":
        # a cloud 5 km out, a fifth of it invalid (at +1e9, sorted last):
        # centres at +1e9 cover those blocks, centres at +2e9 see nothing
        xyz = ((rs.rand(448, 3) - 0.5) * 10.0 + 5000.0).astype(F32)
        sc = _layout(xyz, valid=rs.rand(448) > 0.2, block=64)
        ctr = np.concatenate([sc.pts4[:, :3], np.full((20, 3), 2e9, F32),
                              np.full((5, 3), 1e9, F32)])
        return sc, ctr, 2.0, 40
    raise KeyError(name)


CASES = ["sphere_ties", "faces_dupes", "covered_cluster", "padding_straddle", "far_centres"]


@pytest.mark.parametrize("ns", [1, 33, 64])
@pytest.mark.parametrize("case", CASES)
def test_walk_equals_plain(case, ns):
    rs = np.random.RandomState(CASES.index(case))
    sc, ctr, radius, tile = _case(case, rs)
    top, cnt, stats = k4_walk(sc.pts4, sc.blk_bbox, ctr, radius, ns, tile)
    tp, cp = thg.sorted_ball_query_plain(torch.from_numpy(sc.pts4), torch.from_numpy(ctr),
                                         radius, ns)
    np.testing.assert_array_equal(cnt, cp.numpy())
    np.testing.assert_array_equal(top, tp.numpy())
    assert stats["merges"] > 0
    if case in ("covered_cluster", "padding_straddle", "far_centres"):
        assert stats["covered"] > 0, "some blocks should lie wholly inside a ball"
    if ns == 1:
        assert stats["skipped"] > 0, "some blocks should only count"
    if case == "sphere_ties":                     # the boundary is exercised
        d2 = ((ctr[:, None] - sc.pts4[None, :, :3]) ** 2).sum(-1)
        assert (d2 == F32(9.0)).any()


@pytest.mark.parametrize("case", ["faces_dupes", "padding_straddle", "far_centres"])
def test_walk_equals_jax(case):
    """The emulated walk, finished as the pipeline finishes it, equals the
    JAX package's grouped query (its Pallas kernel in interpret mode).
    Not on sphere_ties: there the JAX kernel, interpreted on the CPU, rounds
    some distances at d2 == r2 otherwise than ((dx*dx) + dy*dy) + dz*dz, and
    its counts differ from the plain version's by a few points on about a
    tenth of the centres (the lattice cases' distances are exact integers)."""
    rs = np.random.RandomState(CASES.index(case))
    sc, ctr, radius, tile = _case(case, rs)
    ns = 33
    top, cnt, _ = k4_walk(sc.pts4, sc.blk_bbox, ctr, radius, ns, tile)
    jsc = jhg.SortedCloud(pts4=jnp.asarray(sc.pts4), blk_bbox=jnp.asarray(sc.blk_bbox),
                          orig_idx=None, inv_perm=None, block_size=sc.block_size)
    want = jhg.ball_query_grouped_sorted(jsc, jnp.asarray(ctr), radius, ns, tile=128)
    got = thg._finish_grouped(torch.from_numpy(top), torch.from_numpy(cnt),
                              torch.from_numpy(ctr), ns)
    for name, a, b in zip(("grouped", "idx", "cnt"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _box_points(rs, bmin, bmax, k):
    """Corners, face points and interior points of the box, in float32."""
    corners = np.stack(np.meshgrid(*[[0, 1]] * 3, indexing="ij"), -1).reshape(-1, 3)
    t = np.concatenate([corners, rs.rand(k, 3),
                        np.where(rs.rand(k, 3) < 0.5, rs.randint(0, 2, (k, 3)),
                                 rs.rand(k, 3))])
    p = (bmin + t * (bmax - bmin)).astype(F32)
    return np.clip(p, bmin, bmax)


@pytest.mark.parametrize("where", ["origin", "5000m", "minus_5000m", "1e9"])
def test_box_predicates_against_points(where):
    """Held point by point on random boxes: the cull passes every box that
    holds an in-ball point, the covered test passes only boxes whose every
    point is in the ball; a box of size 0 passes either iff its point is in
    the ball."""
    rs = np.random.RandomState(11)
    off = {"origin": 0.0, "5000m": 5000.0, "minus_5000m": -5000.0, "1e9": 1e9}[where]
    r2 = F32(thg._r2(2.0))
    n_cov = n_cull = 0
    for i in range(300):
        size = 0.0 if i % 5 == 0 else rs.rand() * rs.choice([0.5, 2.0, 6.0])
        bmin = (off + (rs.rand(3) - 0.5) * 8.0).astype(F32)
        bmax = (bmin + size * rs.rand(3)).astype(F32)
        c = (off + (rs.rand(3) - 0.5) * 8.0).astype(F32)
        if i % 7 == 0:                                   # a centre inside the box
            c = _box_points(rs, bmin, bmax, 1)[-1]
        p = _box_points(rs, bmin, bmax, 200)
        inb = _sq3(c - p) < r2
        g, f = gap_pass(c, bmin, bmax, r2), covered(c, bmin, bmax, r2)
        if not g:
            n_cull += 1
            assert not inb.any()
        if f:
            n_cov += 1
            assert g and inb.all()
        if size == 0.0:
            assert g == f == bool(inb[0])
    if where != "1e9":                # 1e9 spacing is 64: most boxes collapse
        assert n_cov > 5 and n_cull > 5


def test_plain_equals_xla_ball_query_on_sphere_ties():
    """The port's plain sorted ball query, finished as the pipeline finishes
    it, equals the JAX package's XLA ball query (neighborhoods.ball_query,
    the reference the Pallas kernels stand in for) on sphere_ties, whose
    points sit at d2 == r2 exactly: in idx, cnt and the grouped points."""
    from feat3dnet_tpu.ops import neighborhoods as jnb

    rs = np.random.RandomState(CASES.index("sphere_ties"))
    sc, ctr, radius, _ = _case("sphere_ties", rs)
    keys = sc.pts4[:, 3].astype(np.int64)
    real = sc.pts4[:, 0] < 5e8
    n = int(real.sum())
    xyz = np.zeros((n, 3), F32)                      # the cloud in its original order
    xyz[keys[real]] = sc.pts4[real, :3]
    c = ctr[real]
    ns = 33
    top, cnt = thg.sorted_ball_query_plain(torch.from_numpy(sc.pts4), torch.from_numpy(c),
                                           radius, ns)
    grouped, idx, cnt = thg._finish_grouped(top, cnt, torch.from_numpy(c), ns)
    idx_j, cnt_j = jnb.ball_query(jnp.asarray(xyz)[None], jnp.asarray(c)[None], radius, ns)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j)[0])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j)[0])
    np.testing.assert_array_equal(grouped.numpy(),
                                  np.asarray(jnb.group_points(jnp.asarray(xyz)[None], idx_j))[0])
    d2 = ((c[:, None] - xyz[None]) ** 2).sum(-1)
    assert (d2 == F32(9.0)).any()                    # the boundary is exercised
