"""K5's walk (csrc/ball_max.cu), emulated in numpy, against the plain
version and the JAX package.

The kernel runs only on a card, so its design is held here by a numpy
emulation of the same steps, in float32 with every operation rounded on its
own: the pre-pass (each block's value maximum; per tile of centres its box
and its hit row, a block listed iff its box comes within r of the tile's
box and its maximum exceeds the smallest start value of the tile's
centres), then per centre the own block first (when the centres are the
sorted rows), and per 32 listed blocks the value skip, K4's per-centre cull
and covered test (a covered block raises the running maximum by its block
maximum, untested), and a point-by-point scan of the rest, each skipped if
its maximum no longer exceeds the running maximum. It must equal
`ball_max_plain` on K4's adversarial clouds under several value fields, and
the JAX package's `ball_max_sorted` (Pallas interpret mode) on all but
`sphere_ties` (see tests/test_torch_k4_walk.py: JAX's interpreted kernel
rounds some distances at d2 == r2 otherwise).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feat3dnet_tpu.ops import hash_grid as jhg
from feat3dnet_tpu_torch.ops import hash_grid as thg
from tests.test_torch_k4_walk import CASES, F32, _case, _sq3, covered, gap_pass

torch.set_num_threads(2)

BIG = F32(1e30)


def _fmax(a, initial):
    """fmaxf over a (NaN dropped), starting from `initial`."""
    return F32(np.fmax.reduce(np.asarray(a, F32), initial=F32(initial)))


def k5_walk(pts4, blk_bbox, values, radius, tile, centers=None):
    """Emulated K5: (out (M,), stats) with, over all centres, the blocks
    scanned point by point, the blocks covered, the blocks dropped by
    value, and the tiles whose hit row is empty."""
    r2 = F32(thg._r2(radius))
    np_, nb = pts4.shape[0], blk_bbox.shape[0]
    L = np_ // nb
    own_rows = centers is None
    ctr = pts4[:, :3] if own_rows else centers.astype(F32)
    m = ctr.shape[0]
    values = values.astype(F32)
    blkmax = np.fmax.reduce(values.reshape(nb, L), axis=1, initial=-np.inf).astype(F32)
    bmin, bmax = blk_bbox[:, :3], blk_bbox[:, 3:6]
    out = np.empty((m,), F32)
    stats = dict(scanned=0, covered=0, dropped=0, empty_tiles=0)

    def scan(c, b, best):
        rows = slice(b * L, (b + 1) * L)
        inb = _sq3(c - pts4[rows, :3]) < r2
        return _fmax(values[rows][inb], best)

    for t0 in range(0, m, tile):
        cs = ctr[t0:t0 + tile]
        # ---- pre-pass: the tile's box and hit row
        lo = np.fmin.reduce(cs, axis=0, initial=np.inf).astype(F32)
        hi = np.fmax.reduce(cs, axis=0, initial=-np.inf).astype(F32)
        start = -BIG if (~(cs[:, 0] >= F32(5e8))).any() else BIG
        g = np.maximum(np.maximum(bmin - hi, lo - bmax), F32(0))
        listed = np.nonzero((_sq3(g) < r2) & (blkmax > start))[0]
        stats["empty_tiles"] += listed.size == 0
        for c_i in range(t0, t0 + cs.shape[0]):
            c = ctr[c_i]
            best = BIG if c[0] >= F32(5e8) else -BIG
            own = -1
            if own_rows:                                   # the own block first
                own = c_i // L
                if blkmax[own] > best:
                    if gap_pass(c, bmin[own], bmax[own], r2) and covered(c, bmin[own],
                                                                        bmax[own], r2):
                        best = blkmax[own]
                        stats["covered"] += 1
                    else:
                        best = scan(c, own, best)
                        stats["scanned"] += 1
                else:
                    stats["dropped"] += 1
            for h0 in range(0, listed.size, 32):
                grp = listed[h0:h0 + 32]
                bm = blkmax[grp]
                live = (grp != own) & (bm > best)
                stats["dropped"] += int(((grp != own) & ~live).sum())
                pas = live & gap_pass(c, bmin[grp], bmax[grp], r2)
                cov = pas & covered(c, bmin[grp], bmax[grp], r2)
                stats["covered"] += int(cov.sum())
                best = _fmax(bm[cov], best)
                rest = pas & ~cov & (bm > best)
                for b, b_max in zip(grp[rest], bm[rest]):
                    if b_max <= best:                          # raised since the ballot
                        stats["dropped"] += 1
                        continue
                    best = scan(c, b, best)
                    stats["scanned"] += 1
            out[c_i] = best
    return out, stats


def _values(kind, pts4, rs):
    """A per-row value field: `random` (uniform), `ties` (four levels, so a
    ball's maximum is shared), `constant`, or `smooth` (a field of the
    coordinates, as attention varies over a cloud)."""
    n = pts4.shape[0]
    xyz = np.where(pts4[:, :3] > 5e8, F32(0), pts4[:, :3])
    v = {"random": lambda: rs.rand(n),
         "ties": lambda: rs.randint(0, 4, n) / 4.0,
         "constant": lambda: np.full(n, 0.25),
         "smooth": lambda: np.sin(xyz[:, 0] * 0.7) * np.cos(xyz[:, 1] * 0.5) + 0.1 * xyz[:, 2]}
    return v[kind]().astype(F32)


VALUES = ["random", "ties", "constant", "smooth"]


def _k5_case(case, kind):
    """K4's case (its radius: sphere_ties' exact d2 == r2 points, covered
    blocks) with a value field."""
    rs = np.random.RandomState(CASES.index(case))
    sc, ctr, radius, tile = _case(case, rs)
    return sc, ctr, radius, tile, _values(kind, sc.pts4, np.random.RandomState(7))


@pytest.mark.parametrize("kind", VALUES)
@pytest.mark.parametrize("case", CASES)
def test_walk_equals_plain(case, kind):
    sc, ctr, radius, tile, vals = _k5_case(case, kind)
    pts4 = torch.from_numpy(sc.pts4)
    rows = np.array_equal(ctr, sc.pts4[:, :3])
    want = thg.ball_max_plain(pts4, torch.from_numpy(vals), radius,
                              centers=torch.from_numpy(ctr)).numpy()
    got, stats = k5_walk(sc.pts4, sc.blk_bbox, vals, radius, tile,
                         centers=None if rows else ctr)
    np.testing.assert_array_equal(got, want)
    # given centres (a centre list, no own block): every third row, padding included
    sub = ctr[::3].copy()
    got_sub, _ = k5_walk(sc.pts4, sc.blk_bbox, vals, radius, tile, centers=sub)
    np.testing.assert_array_equal(got_sub, thg.ball_max_plain(
        pts4, torch.from_numpy(vals), radius, centers=torch.from_numpy(sub)).numpy())
    assert stats["scanned"] > 0
    if kind == "constant" and rows:            # after the own block every block drops
        assert stats["dropped"] > 0 and stats["scanned"] <= ctr.shape[0]
    if case == "covered_cluster":
        assert stats["covered"] > 0, "some blocks should lie wholly inside a ball"
    if case in ("padding_straddle", "far_centres"):
        assert (got[ctr[:, 0] >= 5e8] == BIG).all()


def test_padding_tiles_list_nothing():
    """A tile of padding centres lists no block (their start, +1e30, is
    above every block maximum), unless a value exceeds 1e30."""
    rs = np.random.RandomState(3)
    sc, ctr, _, _ = _case("padding_straddle", rs)
    vals = _values("random", sc.pts4, rs)
    _, stats = k5_walk(sc.pts4, sc.blk_bbox, vals, 0.5, 32)
    assert stats["empty_tiles"] >= 3
    big = vals.copy()
    big[sc.pts4[:, 0] > 5e8] = F32(2e30)
    got, stats = k5_walk(sc.pts4, sc.blk_bbox, big, 0.5, 32)
    want = thg.ball_max_plain(torch.from_numpy(sc.pts4), torch.from_numpy(big), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[sc.pts4[:, 0] > 5e8] == F32(2e30)).all() and stats["empty_tiles"] == 0


@pytest.mark.parametrize("case", [c for c in CASES if c != "sphere_ties"])
def test_walk_equals_jax(case):
    """The emulated walk equals the JAX package's ball max (its Pallas
    kernel in interpret mode), on every sorted row and on given centres."""
    sc, ctr, radius, tile, vals = _k5_case(case, "smooth")
    rows = np.array_equal(ctr, sc.pts4[:, :3])
    got, _ = k5_walk(sc.pts4, sc.blk_bbox, vals, radius, tile, centers=None if rows else ctr)
    want = jhg.ball_max_sorted(jnp.asarray(sc.pts4), jnp.asarray(sc.blk_bbox),
                               jnp.asarray(vals), radius, tile=128, interpret=True,
                               centers=jnp.asarray(ctr))
    np.testing.assert_array_equal(got, np.asarray(want))
