"""Morton-culled exact ball query and ball max (port of feat3dnet_tpu/ops/hash_grid.py).

The dense ball query scans the whole cloud for every centre, O(M·N). The
extraction's attention pass makes every point a centre, so this module
cuts the work by locality and stays index-exact against the dense op:

  1. `build_sorted_cloud` sorts the points by the Morton code of their
     grid cell (cell = radius) into blocks of L consecutive points, each
     block re-sorted by original index; invalid points go to +1e9;
  2. `block_hitmask` tests each (centre tile, point block) pair of
     bounding boxes with the exact gap expression, so a block that can hold
     no in-ball point of the tile is never visited;
  3. kernel K4 (`sorted_ball_query`, csrc/sorted_ball_query.cu) culls the
     tile's hit blocks again per centre, walks them in the order of their
     smallest keys and keeps, per centre, the ns smallest ORIGINAL indices
     among the in-ball points, and the true in-ball count; `_finish_grouped`
     applies the reference's repeat-pad and empty-ball rule;
  4. kernel K5 (`ball_max_sorted`, csrc/ball_max.cu) is the NMS primitive:
     per centre, the maximum of a per-point value over its radius ball; it
     makes its own per-tile hit rows and per-block value maxima, culls per
     centre as K4 does, and skips a block whose maximum cannot raise the
     centre's running maximum.

Several clouds of one bucket go through K4 and K5 at once as a union
(`build_sorted_cloud_batch`, each cloud's layout concatenated, keys kept
local): `segment=` names the points per cloud, and a pair counts only if
the centre's tile and the point's block belong to one cloud (the JAX
pipeline's `cloud_mask`), so each cloud's outputs equal its own run's.

K4 and K5 launch on CUDA tensors; CPU tensors take their plain versions,
which scan the cloud in (centre chunk x point chunk) tiles without the cull
and never hold an (M, N) array. The Morton layout is built with torch ops
on the cloud's own device (`build_sorted_cloud`, the JAX device builder);
its numpy twin `build_sorted_cloud_host`, bit-equal to the JAX package's
numpy layout, stays as the oracle of the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.ops.neighborhoods import pairwise_sqdist
from feat3dnet_tpu_torch.utils.profiling import spanned

_FAR = 1.0e9          # coordinate of invalid points
_FAR_CENTER = 2.0e9   # coordinate of invalid / padding centres (never 0 away from _FAR)
_BIG = 1.0e30         # key of an empty slot; initial ball max of a padding centre


@dataclasses.dataclass
class SortedCloud:
    """Morton-block layout of one cloud (numpy from the host layout, or
    tensors after `to`)."""

    pts4: object       # (Np, 4) f32: xyz (invalid -> 1e9) | original index
    blk_bbox: object   # (NB, 8) f32: min xyz | max xyz | 0 0
    orig_idx: object   # (Np,) int32 original index per sorted row
    inv_perm: object   # (N,) int32 sorted row of each original point
    block_size: int

    def to(self, device) -> "SortedCloud":
        def t(a):
            return None if a is None else torch.as_tensor(a).to(device)
        return SortedCloud(t(self.pts4), t(self.blk_bbox), t(self.orig_idx),
                           t(self.inv_perm), self.block_size)


def _r2(radius: float) -> float:
    """The JAX kernels' squared radius: float(radius)**2 rounded to f32."""
    return float(np.float32(float(radius) ** 2))


# ---- host layout ------------------------------------------------------------

def build_sorted_cloud_host(xyz, valid_mask=None, cell_size: float = 2.0,
                            block_size: int = 256) -> SortedCloud:
    """Morton-block layout of one (N, 3) host cloud, in numpy.

    Bit-equal to the JAX package's numpy layout: stable sort by the 30-bit
    Morton code of the clipped cell (invalid and non-finite points last, at
    +1e9), padding to a multiple of the block with rows that carry unique
    keys n, n+1, ... at +1e9, then a stable re-sort of every block by
    original index.
    """
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    L = block_size
    if valid_mask is None:
        valid_mask = np.ones((n,), bool)
    valid_mask = np.asarray(valid_mask, bool) & np.isfinite(xyz).all(axis=1)
    pts = np.where(valid_mask[:, None], xyz, np.float32(_FAR))

    finite_min = np.min(np.where(valid_mask[:, None], pts, np.float32(_FAR)), axis=0)
    cell = np.clip((pts - finite_min) / np.float32(cell_size), 0, 1023).astype(np.int32)

    def spread(x):
        x = x.astype(np.uint32)
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    key = (spread(cell[:, 0]) | (spread(cell[:, 1]) << np.uint32(1))
           | (spread(cell[:, 2]) << np.uint32(2))).astype(np.int64)
    key[~valid_mask] = 1 << 30

    order1 = np.argsort(key, kind="stable").astype(np.int32)
    pad = -n % L
    order1 = np.pad(order1, (0, pad))
    np_ = n + pad
    blk = np.arange(np_, dtype=np.int64) // L
    pad_flag = np.arange(np_) >= n
    key2 = blk * (2 * np_) + order1 + np.where(pad_flag, np_, 0)
    order2 = np.argsort(key2, kind="stable")
    final_orig = order1[order2]
    sorted_pts = pts[final_orig]
    pad2 = pad_flag[order2]
    sorted_pts[pad2] = np.float32(_FAR)

    key_chan = final_orig.astype(np.float32)
    key_chan[pad2] = n + np.arange(pad2.sum(), dtype=np.float32)
    pts4 = np.concatenate([sorted_pts, key_chan[:, None]], axis=1)
    bmin = sorted_pts.reshape(-1, L, 3).min(axis=1)
    bmax = sorted_pts.reshape(-1, L, 3).max(axis=1)
    blk_bbox = np.concatenate(
        [bmin, bmax, np.zeros((bmin.shape[0], 2), np.float32)], axis=1)

    inv_perm = np.zeros((np_,), np.int32)
    real = ~pad_flag[order2]
    inv_perm[final_orig[real]] = np.arange(np_, dtype=np.int32)[real]
    return SortedCloud(pts4=pts4, blk_bbox=blk_bbox,
                       orig_idx=final_orig.astype(np.int32),
                       inv_perm=inv_perm[:n], block_size=L)


# ---- device layout ----------------------------------------------------------

def build_sorted_cloud(xyz: torch.Tensor, valid_mask: Optional[torch.Tensor] = None,
                       cell_size: float = 2.0, block_size: int = 256) -> SortedCloud:
    """Morton-block layout of one (N, 3) cloud, built with torch ops on the
    tensor's own device (port of the JAX device builder): the one-cloud
    case of `build_sorted_cloud_batch`.

    Every field is bit-equal to `build_sorted_cloud_host`. Nothing here
    waits on the device: the pad keys come from a cumulative sum and
    inv_perm from a scatter whose pad rows land in a dummy slot, where the
    numpy version counts and masks on the host.
    """
    sc = build_sorted_cloud_batch(xyz[None], None if valid_mask is None else valid_mask[None],
                                  cell_size=cell_size, block_size=block_size)
    return dataclasses.replace(sc, orig_idx=sc.orig_idx[0], inv_perm=sc.inv_perm[0])


def build_sorted_cloud_batch(xyz: torch.Tensor, valid_mask: Optional[torch.Tensor] = None,
                             cell_size: float = 2.0, block_size: int = 256) -> SortedCloud:
    """Morton-block layouts of B clouds of one bucket, (B, N, 3), in one
    build on the tensor's device: the union that K4 and K5 take with
    `segment` = the padded points per cloud.

    Each cloud's rows are bit-equal to `build_sorted_cloud_host` on it:
    pts4 (B·Np, 4) and blk_bbox (B·Np / L, 8) row-stacked, each cloud's
    key channel its LOCAL original index; orig_idx (B, Np) and inv_perm
    (B, N) local. The means: a per-cloud finite minimum, and each of the
    two stable sorts run along the cloud axis, one sort of B rows. No host
    sync (see `build_sorted_cloud`).
    """
    b, n, L = xyz.shape[0], xyz.shape[1], block_size
    dev = xyz.device
    pts = xyz.to(torch.float32)
    valid = torch.isfinite(pts).all(dim=2)
    if valid_mask is not None:
        valid = valid & valid_mask.to(device=dev, dtype=torch.bool)
    pts = torch.where(valid[..., None], pts, _FAR)

    finite_min = pts.min(dim=1, keepdim=True).values       # per cloud; invalid at +1e9
    # divide by a device tensor: CUDA turns a division by a host scalar into
    # a product with its reciprocal, which rounds unlike numpy's f32 divide
    # (torch.full fills on the device; torch.tensor would copy and wait)
    cell = torch.full((), cell_size, dtype=torch.float32, device=dev)
    grid = torch.clamp((pts - finite_min) / cell, 0, 1023).to(torch.int32)
    # invalid points last
    key = torch.where(valid, _morton30(grid.reshape(-1, 3)).reshape(b, n), 1 << 30)

    order1 = torch.argsort(key, dim=1, stable=True)          # local indices
    pad = -n % L
    np_ = n + pad
    order1 = torch.cat([order1, order1.new_zeros((b, pad))], dim=1)  # pad rows alias point 0
    row = torch.arange(np_, dtype=torch.int64, device=dev)
    pad_flag = row >= n
    # each block re-sorted by original index, its pad rows last
    key2 = (row // L) * (2 * np_) + order1 + pad_flag.to(torch.int64) * np_
    order2 = torch.argsort(key2, dim=1, stable=True)
    final_orig = torch.gather(order1, 1, order2)
    pad2 = pad_flag[order2]
    sorted_pts = torch.where(pad2[..., None], _FAR,
                             torch.gather(pts, 1, final_orig[..., None].expand(-1, -1, 3)))

    # pad rows get unique keys n, n + 1, ... in the key channel
    key_chan = torch.where(pad2, n - 1 + torch.cumsum(pad2.to(torch.int64), 1), final_orig)
    pts4 = torch.cat([sorted_pts, key_chan.to(torch.float32)[..., None]], dim=2).reshape(-1, 4)
    blocks = sorted_pts.reshape(-1, L, 3)
    blk_bbox = torch.cat([blocks.min(dim=1).values, blocks.max(dim=1).values,
                          sorted_pts.new_zeros((b * np_ // L, 2))], dim=1)

    inv_perm = torch.zeros((b, np_ + 1), dtype=torch.int32, device=dev)
    inv_perm.scatter_(1, torch.where(pad2, np_, final_orig), row.to(torch.int32).expand(b, -1))
    return SortedCloud(pts4=pts4, blk_bbox=blk_bbox, orig_idx=final_orig.to(torch.int32),
                       inv_perm=inv_perm[:, :n], block_size=L)


def estimate_ball_points(xyz, radius: float) -> float:
    """Host density proxy: mean points per occupied radius-sized cell times
    4π/3, the estimated population of a radius ball around a typical point
    (chooses the block size under hash_block=0)."""
    xyz = np.asarray(xyz, np.float32)
    pts = xyz[np.isfinite(xyz).all(axis=1)]
    if pts.shape[0] == 0:
        return 0.0
    cells = np.floor(pts / np.float32(radius)).astype(np.int64)
    key = ((cells[:, 0] * 73856093) ^ (cells[:, 1] * 19349663)
           ^ (cells[:, 2] * 83492791))
    return float(pts.shape[0] / np.unique(key).size * (4.0 * np.pi / 3.0))


def _morton30(cell: torch.Tensor) -> torch.Tensor:
    """(M, 3) ints in [0, 1023] -> (M,) 30-bit Morton codes (int64)."""
    def spread(x):
        x = x.to(torch.int64)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(cell[:, 0]) | (spread(cell[:, 1]) << 1) | (spread(cell[:, 2]) << 2)


def sort_centers(centers: torch.Tensor, valid: Optional[torch.Tensor] = None,
                 cell_size: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatially order arbitrary (M, 3) centres (invalid ones at +2e9):
    returns (sorted_centers, order), a stable sort by Morton code."""
    c = centers.to(torch.float32)
    if valid is not None:
        c = torch.where(valid[:, None], c, torch.full_like(c, _FAR_CENTER))
    cell = torch.clamp((c - c.min(dim=0).values) / cell_size, 0, 1023).to(torch.int32)
    order = torch.argsort(_morton30(cell), stable=True)
    return c[order], order.to(torch.int32)


# ---- the cull --------------------------------------------------------------

def tile_bbox(centers: torch.Tensor, tile: int) -> torch.Tensor:
    """(Mp, 3) -> (Mp / tile, 8) per-tile boxes: min xyz | max xyz | 0 0."""
    c = centers.reshape(-1, tile, 3)
    lo, hi = c.min(dim=1).values, c.max(dim=1).values
    return torch.cat([lo, hi, lo.new_zeros((lo.shape[0], 2))], dim=1)


def _gap_hits(tbox: torch.Tensor, blk_bbox: torch.Tensor, r2: float) -> torch.Tensor:
    """(..., Ti, 8) x (..., NB, 8) boxes -> (..., Ti, NB) bool, the gap test."""
    lo = blk_bbox[..., None, :, :3] - tbox[..., :, None, 3:6]
    hi = tbox[..., :, None, :3] - blk_bbox[..., None, :, 3:6]
    gap = torch.clamp(torch.maximum(lo, hi), min=0.0)
    g2 = gap * gap
    return (g2[..., 0] + g2[..., 1]) + g2[..., 2] < r2


def block_hitmask(tbox: torch.Tensor, blk_bbox: torch.Tensor, r2: float,
                  chunk: int = 1 << 22) -> torch.Tensor:
    """(Ti, 8) tile boxes x (NB, 8) block boxes -> (Ti, NB) bool: block j
    can hold a point within sqrt(r2) of some point of tile i's box.

    The gap expression ((g0·g0 + g1·g1) + g2·g2) < r2 rounds like the
    per-point distance, so the cull is never stricter than the point test.
    Computed in tile chunks of `chunk` pairs.
    """
    nb = blk_bbox.shape[0]
    out = torch.empty((tbox.shape[0], nb), dtype=torch.bool, device=tbox.device)
    step = max(1, chunk // max(nb, 1))
    for t0 in range(0, tbox.shape[0], step):
        out[t0:t0 + step] = _gap_hits(tbox[t0:t0 + step], blk_bbox, r2)
    return out


def _segments(name: str, np_: int, m: int, segment: Optional[int], tile: int = 1,
              block: int = 1) -> Tuple[int, int]:
    """(clouds, centres per cloud) of a union of `segment`-point clouds
    whose m centres split evenly over the clouds; (1, m) for one cloud
    (segment None or all the points). Raises when the clouds do not split
    into whole tiles and blocks (the plain versions have neither)."""
    if segment is None or segment == np_:
        return 1, m
    if (segment < 1 or np_ % segment or segment % tile or segment % block
            or m % (np_ // segment) or (m // (np_ // segment)) % tile):
        raise ValueError(f"{name}: segment={segment} must divide the {np_} points into "
                         f"clouds of whole tiles ({tile}) and blocks ({block}), and the "
                         f"{m} centres evenly over them in whole tiles")
    return np_ // segment, m // (np_ // segment)


def _padded_hitmask(centers: torch.Tensor, blk_bbox: torch.Tensor, r2: float,
                    tile: int, n_clouds: int = 1, chunk: int = 1 << 22) -> torch.Tensor:
    """Hit mask for centres padded to a whole tile with +2e9 rows, as uint8.
    With n_clouds > 1 (the centres and blocks split evenly into that many
    clouds, in whole tiles) only the block-diagonal pairs of a tile and a
    block of one cloud are tested; the others are 0, the AND with the JAX
    pipeline's `cloud_mask`."""
    if n_clouds == 1:
        pad = -centers.shape[0] % tile
        cp = torch.cat([centers, centers.new_full((pad, 3), _FAR_CENTER)]) if pad else centers
        return block_hitmask(tile_bbox(cp, tile), blk_bbox, r2).to(torch.uint8).contiguous()
    tb = tile_bbox(centers, tile).reshape(n_clouds, -1, 8)
    bb = blk_bbox.reshape(n_clouds, -1, 8)
    tpc, bpc = tb.shape[1], bb.shape[1]
    out = torch.zeros((n_clouds, tpc, n_clouds, bpc), dtype=torch.uint8, device=tb.device)
    step = max(1, chunk // (tpc * bpc))
    for b0 in range(0, n_clouds, step):
        b1 = min(b0 + step, n_clouds)
        # the diagonal of clouds [b0, b1) as a (tpc, bpc, clouds) view
        torch.diagonal(out[b0:b1, :, b0:b1, :], dim1=0, dim2=2).copy_(
            _gap_hits(tb[b0:b1], bb[b0:b1], r2).permute(1, 2, 0))
    return out.reshape(n_clouds * tpc, n_clouds * bpc)


# ---- K4: the sorted ball query ----------------------------------------------

def _check_sorted_inputs(name, pts4, blk_bbox, centers):
    if (pts4.dtype != torch.float32 or pts4.dim() != 2 or pts4.shape[1] != 4
            or blk_bbox.dtype != torch.float32 or blk_bbox.dim() != 2
            or blk_bbox.shape[1] != 8 or centers.dtype != torch.float32
            or centers.dim() != 2 or centers.shape[1] != 3):
        raise ValueError(f"{name}: want pts4 (Np, 4), blk_bbox (NB, 8), centers (M, 3) "
                         f"float32, got {tuple(pts4.shape)} {pts4.dtype}, "
                         f"{tuple(blk_bbox.shape)}, {tuple(centers.shape)} {centers.dtype}")
    if not (pts4.device == blk_bbox.device == centers.device):
        raise ValueError(f"{name}: inputs on different devices")
    np_, nb = pts4.shape[0], blk_bbox.shape[0]
    if nb == 0 or np_ % nb or (np_ // nb) % 32:
        raise ValueError(f"{name}: {np_} points in {nb} blocks; the block size must "
                         "be a multiple of 32")
    if np_ >= (1 << 24):
        raise ValueError(f"{name}: keys ride f32, exact only below 2^24 points")
    return np_ // nb


def _plain_clouds(name: str, np_: int, m: int, segment: Optional[int], device):
    """For the plain versions of a union of `segment`-point clouds, m
    centres split evenly over them: (span, mask), where span(m0, m1) is
    the point range of the clouds of centres [m0, m1) and mask(m0, m1, n0,
    n1) the chunk's pairs of one cloud (None for one cloud)."""
    n_clouds, cpc = _segments(name, np_, m, segment)
    if n_clouds == 1:
        return lambda m0, m1: (0, np_), lambda m0, m1, n0, n1: None

    def span(m0, m1):
        return (m0 // cpc) * segment, -(-m1 // cpc) * segment

    def mask(m0, m1, n0, n1):
        c = torch.arange(m0, m1, device=device) // cpc
        return c[:, None] == torch.arange(n0, n1, device=device)[None, :] // segment
    return span, mask


def sorted_ball_query_plain(pts4: torch.Tensor, centers: torch.Tensor, radius: float,
                            nsample: int, chunk_m: int = 2048, chunk_n: int = 8192,
                            segment: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: per centre, the `nsample` in-ball points
    (d2 < r2, strict) with the smallest keys (pts4 column 3), ascending, as
    (M, ns, 4) rows [x y z key]; slots past the count are [0 0 0 1e30].
    Also the true in-ball count (M,) int32. A running top-ns over point
    chunks: O(chunk_m · chunk_n) memory, no cull. segment: the points per
    cloud of a union (`build_sorted_cloud_batch`), the centres split evenly
    over its clouds; a pair counts only within one cloud."""
    r2 = _r2(radius)
    m, np_ = centers.shape[0], pts4.shape[0]
    dev = pts4.device
    span, pair_mask = _plain_clouds("sorted_ball_query_plain", np_, m, segment, dev)
    top = torch.empty((m, nsample, 4), dtype=torch.float32, device=dev)
    cnt = torch.empty((m,), dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    for m0 in range(0, m, chunk_m):
        c = centers[m0:m0 + chunk_m]
        cm = c.shape[0]
        best_k = torch.full((cm, nsample), float("inf"), dtype=torch.float32, device=dev)
        best_r = torch.zeros((cm, nsample), dtype=torch.int64, device=dev)
        count = torch.zeros((cm,), dtype=torch.int64, device=dev)
        lo, hi = span(m0, m0 + cm)
        for n0 in range(lo, hi, chunk_n):
            p = pts4[n0:min(n0 + chunk_n, hi)]
            in_ball = pairwise_sqdist(c, p[:, :3]) < r2               # (cm, cn)
            same = pair_mask(m0, m0 + cm, n0, n0 + p.shape[0])
            if same is not None:
                in_ball = in_ball & same
            count += in_ball.sum(dim=1)
            keys = torch.where(in_ball, p[None, :, 3], inf)
            rows = torch.arange(n0, n0 + p.shape[0], device=dev).expand(cm, -1)
            best_k, pos = torch.topk(torch.cat([best_k, keys], dim=1), nsample,
                                     dim=1, largest=False, sorted=True)
            best_r = torch.gather(torch.cat([best_r, rows], dim=1), 1, pos)
        filled = torch.isfinite(best_k)
        xyz = torch.where(filled[..., None], pts4[best_r][..., :3], 0.0)
        key = torch.where(filled, best_k, _BIG)
        top[m0:m0 + cm] = torch.cat([xyz, key[..., None]], dim=-1)
        cnt[m0:m0 + cm] = count.to(torch.int32)
    return top, cnt


@spanned("f3d.k4.sorted_ball_query")
def sorted_ball_query(pts4: torch.Tensor, blk_bbox: torch.Tensor, centers: torch.Tensor,
                      radius: float, nsample: int, tile: int = 128,
                      segment: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw Morton-culled ball query through kernel K4: the sorted
    layout (pts4, blk_bbox) and (M, 3) centres (spatially ordered for the
    cull to pay) -> (top (M, ns, 4), cnt_raw (M,) int32), the contract of
    `sorted_ball_query_plain`. segment: the points per cloud of a union of
    clouds (`build_sorted_cloud_batch`; whole tiles and blocks, the centres
    split evenly over the clouds): the hit mask keeps only the tile-block
    pairs of one cloud, so each cloud's rows equal its own run's.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (several blocks per tile of `tile` centres, each walking the tile's
    hit list with a per-centre cull), and anything it does not take raises.
    """
    if pts4.device.type == "cpu" and segment is None:
        return sorted_ball_query_plain(pts4, centers, radius, nsample)
    if pts4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sorted_ball_query: unsupported device {pts4.device}")
    L = _check_sorted_inputs("sorted_ball_query", pts4, blk_bbox, centers)
    n_clouds, _ = _segments("sorted_ball_query", pts4.shape[0], centers.shape[0], segment,
                            tile, L)
    if pts4.device.type == "cpu":
        return sorted_ball_query_plain(pts4, centers, radius, nsample, segment=segment)
    if not 1 <= nsample <= 64 or tile < 1:
        raise ValueError(f"sorted_ball_query: nsample={nsample} (1..64), tile={tile}")
    pts4, blk_bbox, centers = pts4.contiguous(), blk_bbox.contiguous(), centers.contiguous()
    m = centers.shape[0]
    r2 = _r2(radius)
    hit = _padded_hitmask(centers, blk_bbox, r2, tile, n_clouds)
    top = torch.empty((m, nsample, 4), dtype=torch.float32, device=pts4.device)
    cnt = torch.empty((m,), dtype=torch.int32, device=pts4.device)
    kernels.launch_sorted_ball_query(pts4, blk_bbox, hit, L, centers, tile, r2, nsample,
                                     top, cnt)
    sorted_ball_query.launches += 1
    return top, cnt


sorted_ball_query.launches = 0
sorted_ball_query.plain = sorted_ball_query_plain


def _finish_grouped(top: torch.Tensor, cnt_raw: torch.Tensor, centers: torch.Tensor,
                    ns: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw top-ns rows -> (grouped (M, ns, 3) absolute coords, idx (M, ns)
    int32, cnt (M,) int32 capped at ns): slots past the count repeat slot
    0; an empty ball gets the centre itself in every slot and index 0."""
    cnt = torch.clamp(cnt_raw, max=ns).to(torch.int32)
    slot = torch.arange(ns, dtype=torch.int32, device=top.device)
    filled = slot[None, :] < cnt[:, None]
    empty = (cnt == 0)[:, None]
    key = top[:, :, 3]
    idx = torch.where(filled, key, key[:, 0:1])
    idx = torch.where(empty, 0.0, idx).to(torch.int32)
    grouped = torch.where(filled[..., None], top[:, :, :3], top[:, 0:1, :3])
    grouped = torch.where(empty[..., None], centers.to(torch.float32)[:, None, :], grouped)
    return grouped, idx, cnt


def ball_query_grouped_sorted(sc: SortedCloud, centers: torch.Tensor, radius: float,
                              nsample: int, tile: int = 128, segment: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact grouped ball query against a Morton-sorted cloud (tensors):
    (grouped (M, ns, 3) absolute coords, idx (M, ns) int32 original
    indices, cnt (M,) int32 capped at ns). Empty balls hold the centre;
    `hashed_ball_query` restores the nearest-point fallback. segment: a
    union of clouds, as `sorted_ball_query` (idx then local per cloud)."""
    top, cnt_raw = sorted_ball_query(sc.pts4, sc.blk_bbox, centers, radius, nsample,
                                     tile=tile, segment=segment)
    return _finish_grouped(top, cnt_raw, centers, nsample)


# ---- K5: the ball max ---------------------------------------------------------

def _init_ballmax(centers: torch.Tensor) -> torch.Tensor:
    """-1e30 for real centres, +1e30 for invalid / padding ones (x >= 5e8)."""
    return torch.where(centers[:, 0] >= 5.0e8, _BIG, -_BIG).to(torch.float32)


def ball_max_plain(pts4: torch.Tensor, values: torch.Tensor, radius: float,
                   centers: Optional[torch.Tensor] = None, chunk_m: int = 2048,
                   chunk_n: int = 8192, segment: Optional[int] = None) -> torch.Tensor:
    """Plain version of K5: per centre, the max of `values` (per sorted
    row) over the points with d2 < r2, starting from `_init_ballmax`.
    segment: a union of clouds, as `sorted_ball_query_plain`."""
    if centers is None:
        centers = pts4[:, :3]
    r2 = _r2(radius)
    vals = values.to(torch.float32)
    out = _init_ballmax(centers)
    neg = torch.tensor(-_BIG, dtype=torch.float32, device=pts4.device)
    span, pair_mask = _plain_clouds("ball_max_plain", pts4.shape[0], centers.shape[0], segment,
                                    pts4.device)
    for m0 in range(0, centers.shape[0], chunk_m):
        c = centers[m0:m0 + chunk_m]
        best = out[m0:m0 + chunk_m]
        lo, hi = span(m0, m0 + c.shape[0])
        for n0 in range(lo, hi, chunk_n):
            n1 = min(n0 + chunk_n, hi)
            in_ball = pairwise_sqdist(c, pts4[n0:n1, :3]) < r2
            same = pair_mask(m0, m0 + c.shape[0], n0, n1)
            if same is not None:
                in_ball = in_ball & same
            neigh = torch.where(in_ball, vals[None, n0:n1], neg)
            best = torch.maximum(best, neigh.amax(dim=1))
        out[m0:m0 + chunk_m] = best
    return out


@spanned("f3d.k5.ball_max")
def ball_max_sorted(pts4: torch.Tensor, blk_bbox: torch.Tensor, values: torch.Tensor,
                    radius: float, tile: int = 512,
                    centers: Optional[torch.Tensor] = None,
                    segment: Optional[int] = None) -> torch.Tensor:
    """Per centre (default: every sorted point), the max of `values` (Np,)
    over its radius ball, through kernel K5: the NMS primitive, a point
    survives iff its own value ties its ball max. +1e30 for invalid
    centres. segment: a union of clouds, as `sorted_ball_query` (K5's
    pre-pass lists only the blocks of the tile's own cloud). CPU tensors
    take `ball_max_plain`; CUDA tensors launch the
    kernel (a pre-pass of block maxima and per-tile hit rows, `tile`
    centres a row, then blocks of a few centres each walking their tile's
    hit list with a per-centre cull and value skip), and anything it does
    not take raises."""
    if pts4.device.type == "cpu" and segment is None:
        return ball_max_plain(pts4, values, radius, centers)
    if pts4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ball_max_sorted: unsupported device {pts4.device}")
    L = _check_sorted_inputs("ball_max_sorted", pts4, blk_bbox,
                             pts4[:, :3] if centers is None else centers)
    m = pts4.shape[0] if centers is None else centers.shape[0]
    n_clouds, per_cloud = _segments("ball_max_sorted", pts4.shape[0], m, segment, tile, L)
    if pts4.device.type == "cpu":
        return ball_max_plain(pts4, values, radius, centers, segment=segment)
    if (values.dtype != torch.float32 or values.shape != (pts4.shape[0],)
            or values.device != pts4.device):
        raise ValueError(f"ball_max_sorted: want values ({pts4.shape[0]},) float32 on "
                         f"{pts4.device}, got {tuple(values.shape)} {values.dtype}")
    if tile % 32 or not 32 <= tile <= 512:
        raise ValueError(f"ball_max_sorted: tile={tile} must be a multiple of 32 in "
                         "[32, 512]")
    pts4, values, blk_bbox = pts4.contiguous(), values.contiguous(), blk_bbox.contiguous()
    if centers is not None:
        centers = centers.contiguous()
    nb = blk_bbox.shape[0]
    dev = pts4.device
    hit = torch.empty((-(-m // tile), nb), dtype=torch.uint8, device=dev)
    blkmax = torch.empty((nb,), dtype=torch.float32, device=dev)
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    kernels.launch_ball_max(pts4, values, blk_bbox, centers, m, tile, _r2(radius), hit,
                            blkmax, out, *((per_cloud, nb // n_clouds) if n_clouds > 1 else (0, 0)))
    ball_max_sorted.launches += 1
    return out


ball_max_sorted.launches = 0
ball_max_sorted.plain = ball_max_plain


# ---- the drop-in exact ball query ----------------------------------------------

def _nearest_valid_chunked(centers: torch.Tensor, pts: torch.Tensor,
                           valid_mask: Optional[torch.Tensor] = None,
                           chunk_m: int = 1024, chunk_n: int = 4096) -> torch.Tensor:
    """Per centre, the nearest VALID point's index (the first on ties), in
    (chunk_m, chunk_n) tiles with a running (min d2, argmin) carry."""
    m, n = centers.shape[0], pts.shape[0]
    out = torch.zeros((m,), dtype=torch.int32, device=pts.device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=pts.device)
    for m0 in range(0, m, chunk_m):
        c = centers[m0:m0 + chunk_m].to(torch.float32)
        best_d = torch.full((c.shape[0],), float("inf"), dtype=torch.float32,
                            device=pts.device)
        best_i = torch.zeros((c.shape[0],), dtype=torch.int64, device=pts.device)
        for n0 in range(0, n, chunk_n):
            d2 = pairwise_sqdist(c, pts[n0:n0 + chunk_n].to(torch.float32))
            if valid_mask is not None:
                d2 = torch.where(valid_mask[None, n0:n0 + chunk_n], d2, inf)
            loc_d, loc_i = d2.min(dim=1)                       # first minimum
            upd = loc_d < best_d                               # strict: earliest tie
            best_d = torch.where(upd, loc_d, best_d)
            best_i = torch.where(upd, loc_i + n0, best_i)
        out[m0:m0 + chunk_m] = best_i.to(torch.int32)
    return out


def hashed_ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                      nsample: int, valid_mask: Optional[torch.Tensor] = None,
                      center_valid: Optional[torch.Tensor] = None,
                      cell_size: Optional[float] = None, block_size: int = 256,
                      tile: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in exact replacement for ops.ball_query (B = 1, scalar radius):
    (idx (1, M, ns) int32, cnt (1, M) int32), index-exact including the
    ns smallest original indices of saturated balls, repeat-pad, and the
    per-centre nearest valid point for empty balls. Centres that
    `center_valid` masks get zero rows. The layout is built and the query
    runs on the tensors' device (K4 on CUDA)."""
    if xyz.dim() != 3 or xyz.shape[0] != 1:
        raise ValueError("hashed_ball_query: the hashed path is per cloud (B = 1)")
    dev = xyz.device
    cell = float(radius) if cell_size is None else float(cell_size)
    x, c = xyz[0].to(torch.float32), centers[0].to(torch.float32)
    m = c.shape[0]
    vm = None if valid_mask is None else valid_mask[0]
    cv = None if center_valid is None else center_valid[0]
    sc = build_sorted_cloud(x, vm, cell_size=cell, block_size=block_size)
    c_sorted, order = sort_centers(c, cv, cell_size=cell)
    _, idx_s, cnt_s = ball_query_grouped_sorted(sc, c_sorted, radius, nsample, tile=tile)
    inv = torch.empty((m,), dtype=torch.int64, device=dev)
    inv[order.long()] = torch.arange(m, device=dev)
    idx, cnt = idx_s[inv], cnt_s[inv]

    need = cnt == 0
    if cv is not None:
        need = need & cv
    if bool(need.any()):
        nearest = _nearest_valid_chunked(c, x, vm)
        idx = torch.where(need[:, None], nearest[:, None], idx)
    return idx[None], cnt[None]
