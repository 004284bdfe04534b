"""Build, load and bind the port's hand-written CUDA kernels.

The sources live in `feat3dnet_tpu_torch/csrc/`. At first use they are
compiled by nvcc for `sm_90a`, one process per source in parallel, and
linked into one shared library with a plain C interface, which is loaded with ctypes (no PyTorch headers, so the build
takes seconds). The library goes to `build/feat3dnet_tpu_torch/<hash>/`
beside the package, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused within a checkout.

Nothing here runs at import: the CPU tests import every module on a
machine without nvcc. A missing nvcc or a failed build raises.

`build(csrc_dir)` builds another tree's sources the same way (a parent
commit's `csrc/`, for A/B runs in `chip_smoke.py --parent`).

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()` after the launch; `check` raises on a non-zero code.
The op wrappers (ops/fps.py, ops/batch_group.py, ops/fused_describe.py,
ops/hash_grid.py, ops/fused_train.py, ops/interpolate.py) validate tensors,
allocate outputs and count launches; the `launch_*` functions below only
pass pointers.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("fps.cu", "ball_query.cu", "fused_describe.cu", "sorted_ball_query.cu",
           "ball_max.cu", "fused_detect.cu", "fused_train.cu", "three_interp.cu")
HEADERS = ("common.cuh", "slot_layer.cuh", "tc_mma.cuh", "tower_pool.cuh",
           "block_cull.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libf3d_kernels.so"


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str          # the shared library
    seconds: float     # nvcc wall time (0.0 when an existing build was reused)
    ptxas: str         # nvcc's -Xptxas -v report (registers, smem, spills)


def build_dir() -> str:
    """`build/feat3dnet_tpu_torch/` at the root of the checkout."""
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "feat3dnet_tpu_torch")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=None)
def build(csrc_dir: str = CSRC_DIR, sources: tuple = SOURCES,
          headers: tuple = HEADERS) -> BuildInfo:
    """Compile csrc_dir's `sources` into one shared library, once per hash
    of them and their `headers`: one nvcc process per source, all started
    together, then one link."""
    h = hashlib.sha256()
    for name in sources + headers:
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(build_dir(), h.hexdigest()[:16])
    lib = os.path.join(out_dir, _LIB_NAME)
    log = os.path.join(out_dir, "ptxas.txt")
    if os.path.isfile(lib):
        with open(log) as f:
            return BuildInfo(lib, 0.0, f.read())
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = os.path.join(out_dir, f"{src}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(csrc_dir, src), "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    report, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        report.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    tmp = f"{lib}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{proc.stdout}\n{proc.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    with open(log, "w") as f:
        f.write("".join(report))
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, "".join(report))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    lib = ctypes.CDLL(build().path)
    lib.f3d_error_string.argtypes = [_I]
    lib.f3d_error_string.restype = ctypes.c_char_p
    # xyz, mask|NULL, scratch|NULL, b, n, npoint, cluster, out, stream
    lib.f3d_fps.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P]
    lib.f3d_fps.restype = _I
    # cluster
    lib.f3d_fps_max_smem_points.argtypes = [_I]
    lib.f3d_fps_max_smem_points.restype = _I
    # n, cluster, out (host int32 (2,): smem bytes, active clusters)
    lib.f3d_fps_occupancy.argtypes = [_I, _I, _P]
    lib.f3d_fps_occupancy.restype = _I
    # xyz, centers, mask|NULL, b, n, m, r2, ns, cluster, stop, idx, cnt, stream
    lib.f3d_ball_query.argtypes = [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P, _P, _P]
    lib.f3d_ball_query.restype = _I
    # xyz, centers, mask|NULL, radii (b, m), b, n, m, ns, cluster, stop, idx, cnt, stream
    lib.f3d_ball_query_radii.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.f3d_ball_query_radii.restype = _I
    # out (host int32 (3,): warps a CTA, chunks a warp per round, largest cluster)
    lib.f3d_ball_query_shape.argtypes = [_P]
    lib.f3d_ball_query_shape.restype = None
    # packed, ns, batch, weights, layers (host int32 array), extra (host
    # int32 (n, 2) or NULL), n_det, n_det2, n_desc, mode, r2, inv_r, desc,
    # att, stream
    lib.f3d_fused_describe.argtypes = [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                                       _P, _P, _P]
    lib.f3d_fused_describe.restype = _I
    # as f3d_fused_describe, then the stage to stop after, then the stream
    lib.f3d_fused_describe_split.argtypes = lib.f3d_fused_describe.argtypes[:-1] + [_I, _P]
    lib.f3d_fused_describe_split.restype = _I
    # ns, layers, n_det, n_det2, n_desc, mode, out (host int32 (2,): smem
    # bytes, blocks per SM)
    lib.f3d_fused_describe_occupancy.argtypes = [_I, _P, _I, _I, _I, _I, _P]
    lib.f3d_fused_describe_occupancy.restype = _I
    # pts4, blk_bbox, np, hit (tiles x nb u8), nb, block, centers, m, tile,
    # r2, ns, top, cnt, stream
    lib.f3d_sorted_ball_query.argtypes = [_P, _P, _I, _P, _I, _I, _P, _I, _I, _F, _I,
                                          _P, _P, _P]
    lib.f3d_sorted_ball_query.restype = _I
    # pts4, values, np, blk_bbox, nb, centers|NULL, m, tile, r2, hit, blkmax,
    # out, centres per cloud, blocks per cloud (0, 0: one cloud), stage, stream
    lib.f3d_ball_max.argtypes = [_P, _P, _I, _P, _I, _P, _I, _I, _F, _P, _P, _P, _I, _I, _I,
                                 _P]
    lib.f3d_ball_max.restype = _I
    # clusters, ns, batch, weights, layers (host int32 array), extra (host
    # int32 (n, 2)), n_det, n_det2, folded, bf16, r, inv_r, r2, out, stream
    lib.f3d_fused_detect.argtypes = [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P,
                                     _P]
    lib.f3d_fused_detect.restype = _I
    # as f3d_fused_detect, then the stage to stop after, then the stream
    lib.f3d_fused_detect_split.argtypes = lib.f3d_fused_detect.argtypes[:-1] + [_I, _P]
    lib.f3d_fused_detect_split.restype = _I
    # ns, layers, n_det, n_det2, bf16, out (host int32 (2,): smem bytes,
    # blocks per SM)
    lib.f3d_fused_detect_occupancy.argtypes = [_I, _P, _I, _I, _I, _P]
    lib.f3d_fused_detect_occupancy.restype = _I
    # x, ns, gp, g_total, cin0, weights, convs (host int32 (n, 9)), n, nblk,
    # part, stream
    lib.f3d_train_stats.argtypes = [_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P]
    lib.f3d_train_stats.restype = _I
    # x, ns, gp, cin0, weights, convs, n, nblk, pooled, stream
    lib.f3d_train_final.argtypes = [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P]
    lib.f3d_train_final.restype = _I
    # as f3d_train_final, then the stage to stop after, then the stream
    lib.f3d_train_final_split.argtypes = lib.f3d_train_final.argtypes[:-1] + [_I, _P]
    lib.f3d_train_final_split.restype = _I
    # x, ns, gp, cin0, weights, convs, n, vecs (host int32), nblk, dpool, part, stream
    lib.f3d_train_bwd_top.argtypes = [_P, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P]
    lib.f3d_train_bwd_top.restype = _I
    # x, ns, gp, g_total, cin0, weights, convs, n, vecs, nblk, is_top, src,
    # src_bf16, dw_part, db_part, out, out_bf16, bst_part|NULL, stream
    lib.f3d_train_bwd.argtypes = [_P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P, _I, _P,
                                  _P, _P, _I, _P, _P]
    lib.f3d_train_bwd.restype = _I
    # as f3d_train_bwd, then the stage to stop after, then the stream
    lib.f3d_train_bwd_split.argtypes = lib.f3d_train_bwd.argtypes[:-1] + [_I, _P]
    lib.f3d_train_bwd_split.restype = _I
    # kind, ns, gp, cin0, convs, n, is_top, out (host int32 (2,): smem bytes, blocks per SM)
    lib.f3d_train_occupancy.argtypes = [_I, _I, _I, _I, _P, _I, _I, _P]
    lib.f3d_train_occupancy.restype = _I
    # unknown, known, feats, b, n, m, c, out, idx, w, stream
    lib.f3d_three_interp.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    lib.f3d_three_interp.restype = _I
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().f3d_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def fps_max_smem_points(cluster: int) -> int:
    """Largest cloud whose slices fit in the shared memory of a cluster of
    `cluster` blocks (larger ones need the scratch array)."""
    return library().f3d_fps_max_smem_points(cluster)


def launch_fps(xyz, mask, scratch, npoint, cluster, out) -> None:
    """cluster: blocks per cloud (1, 2, 4, 8 or 16)."""
    b, n, _ = xyz.shape
    with torch.cuda.device(xyz.device):
        check(library().f3d_fps(_ptr(xyz), _ptr(mask), _ptr(scratch), b, n,
                                npoint, cluster, _ptr(out), _stream(xyz)), "fps")


def fps_occupancy(n: int, cluster: int):
    """(dynamic shared-memory bytes a block, clusters resident at once) of
    K1's launch for clouds of n points."""
    out = torch.zeros(2, dtype=torch.int32)
    check(library().f3d_fps_occupancy(n, cluster, _ptr(out)), "fps_occupancy")
    return int(out[0]), int(out[1])


@functools.lru_cache(maxsize=None)
def ball_query_shape():
    """(warps a CTA, 32-point chunks a warp takes per round at most,
    largest cluster) of K2 as csrc/ball_query.cu defines them."""
    out = torch.zeros(3, dtype=torch.int32)
    library().f3d_ball_query_shape(_ptr(out))
    return tuple(int(v) for v in out)


# K2's stops as csrc/ball_query.cu numbers them: the kernel ends after every
# round's count (no exchange) or after the exchange (no writes)
BALL_QUERY_STOPS = {"count": 1, "exchange": 2}


def launch_ball_query(xyz, centers, mask, r2, ns, cluster, idx, cnt,
                      stop: Optional[str] = None, radii=None) -> None:
    """cluster: CTAs a group of 32 centres (1, 2, 4, 8 or 16); stop: a key
    of BALL_QUERY_STOPS for the time split (idx and cnt not written);
    radii: a contiguous (b, m) f32 tensor of each centre's radius (the
    per-centre entry point, which squares them and ignores r2), or None."""
    b, n, _ = xyz.shape
    m = centers.shape[1]
    stop = 0 if stop is None else BALL_QUERY_STOPS[stop]
    with torch.cuda.device(xyz.device):
        if radii is None:
            check(library().f3d_ball_query(_ptr(xyz), _ptr(centers), _ptr(mask), b, n,
                                           m, r2, ns, cluster, stop,
                                           _ptr(idx), _ptr(cnt), _stream(xyz)), "ball_query")
        else:
            check(library().f3d_ball_query_radii(_ptr(xyz), _ptr(centers), _ptr(mask),
                                                 _ptr(radii), b, n, m, ns, cluster, stop,
                                                 _ptr(idx), _ptr(cnt), _stream(xyz)),
                  "ball_query_radii")


# K3's modes, as csrc/fused_describe.cu numbers them
DESCRIBE_MODES = {"f32": 0, "bf16": 1, "stream": 2, "matmul": 3, "matmul_2d": 4}


# K3's stages as csrc/fused_describe.cu numbers them for a detector of
# n_det per-slot convs: a split launch returns from each cluster after one;
# the candidate stages leave the count of a pooled conv's candidates per
# block in desc
def describe_stops(n_det: int) -> dict:
    names = (("input",) + tuple(f"det_conv{i}" for i in range(n_det - 1))
             + ("top_product", "top_pool", "heads", "rotation", "desc_convs", "mid_product",
                "mid_pool", "top_candidates", "mid_candidates"))
    return {name: i + 1 for i, name in enumerate(names)}


def launch_fused_describe(packed, ns, weights, layers, extra, n_det, n_det2, n_desc, mode,
                          r2, inv_r, desc, att, stop: Optional[str] = None) -> None:
    """layers: host int32 tensor of (cin, cout, w_offset, b_offset) rows;
    extra: host int32 (n, 2) tensor of the layers' fragment and column-norm
    offsets; mode: a key of
    DESCRIBE_MODES; stop: a key of describe_stops(n_det) for the time split
    of those two modes (desc and att not written)."""
    batch = packed.shape[1]
    args = [_ptr(packed), ns, batch, _ptr(weights), _ptr(layers), _ptr(extra), n_det, n_det2,
            n_desc, DESCRIBE_MODES[mode], r2, inv_r, _ptr(desc), _ptr(att)]
    with torch.cuda.device(packed.device):
        if stop is None:
            check(library().f3d_fused_describe(*args, _stream(packed)), "fused_describe")
        else:
            check(library().f3d_fused_describe_split(*args, describe_stops(n_det)[stop],
                                                     _stream(packed)), "fused_describe_split")


def describe_occupancy(ns: int, layers, n_det: int, n_det2: int, n_desc: int, mode: str):
    """(dynamic shared-memory bytes, blocks per SM) of K3's launch in `mode`."""
    out = torch.zeros(2, dtype=torch.int32)
    check(library().f3d_fused_describe_occupancy(ns, _ptr(layers), n_det, n_det2, n_desc,
                                                 DESCRIBE_MODES[mode], _ptr(out)),
          "fused_describe_occupancy")
    return int(out[0]), int(out[1])


def launch_sorted_ball_query(pts4, blk_bbox, hit, block, centers, tile, r2, ns, top,
                             cnt) -> None:
    """hit: (tiles, nb) uint8 device tensor, one row per tile of centres;
    blk_bbox: (nb, 8) float32, each block's box."""
    with torch.cuda.device(pts4.device):
        check(library().f3d_sorted_ball_query(
            _ptr(pts4), _ptr(blk_bbox), pts4.shape[0], _ptr(hit), hit.shape[1], block,
            _ptr(centers), centers.shape[0], tile, r2, ns, _ptr(top), _ptr(cnt),
            _stream(pts4)), "sorted_ball_query")


# K5's stages as csrc/ball_max.cu numbers them (0 runs both): the pre-pass
# alone, the walk alone on an earlier pre-pass's scratch (the time split)
BALL_MAX_STAGES = {"prep": 1, "walk": 2}


def launch_ball_max(pts4, values, blk_bbox, centers, m, tile, r2, hit, blkmax, out,
                    seg_centres=0, seg_blocks=0) -> None:
    """centers: (m, 3) float32, or None for every sorted row (m == Np);
    hit: (ceil(m / tile), nb) uint8 and blkmax (nb,) float32 scratch;
    seg_centres, seg_blocks: centres and blocks per cloud of a union of
    clouds (0, 0: one cloud)."""
    with torch.cuda.device(pts4.device):
        check(library().f3d_ball_max(
            _ptr(pts4), _ptr(values), pts4.shape[0], _ptr(blk_bbox), blk_bbox.shape[0],
            _ptr(centers), m, tile, r2, _ptr(hit), _ptr(blkmax), _ptr(out), seg_centres,
            seg_blocks, 0, _stream(pts4)), "ball_max")


# K6's stages as csrc/fused_detect.cu numbers them for a detector of
# n_det per-slot convs: a split launch returns from each cluster after one
def detect_stops(n_det: int) -> dict:
    names = ("input",) + tuple(f"conv{i}" for i in range(n_det)) + ("candidates", "pool")
    return {name: i + 1 for i, name in enumerate(names)}


def launch_fused_detect(clusters, weights, layers, extra, n_det, n_det2, folded, bf16, r,
                        inv_r, r2, out, stop: Optional[str] = None) -> None:
    """layers: host int32 tensor of (cin, cout, w, b, mu, mul, beta) rows;
    extra: host int32 (n, 2) tensor of the layers' fragment and column-norm
    offsets; stop: a key of detect_stops(n_det) for the time split (out not
    written)."""
    b, ns, _ = clusters.shape
    args = [_ptr(clusters), ns, b, _ptr(weights), _ptr(layers), _ptr(extra), n_det, n_det2,
            int(folded), int(bf16), r, inv_r, r2, _ptr(out)]
    with torch.cuda.device(clusters.device):
        if stop is None:
            check(library().f3d_fused_detect(*args, _stream(clusters)), "fused_detect")
        else:
            check(library().f3d_fused_detect_split(*args, detect_stops(n_det)[stop],
                                                   _stream(clusters)), "fused_detect_split")


def detect_occupancy(ns: int, layers, n_det: int, n_det2: int, bf16: bool):
    """(dynamic shared-memory bytes, blocks per SM) of K6's launch."""
    out = torch.zeros(2, dtype=torch.int32)
    check(library().f3d_fused_detect_occupancy(ns, _ptr(layers), n_det, n_det2, int(bf16),
                                               _ptr(out)), "fused_detect_occupancy")
    return int(out[0]), int(out[1])


def launch_train_stats(x, g_total, wts, convs, nblk, part) -> None:
    """convs: host int32 (n, 9) table of (cin, cout, relu, poolcat, w, wt, b, a, c)."""
    ns, gp, cin0 = x.shape
    with torch.cuda.device(x.device):
        check(library().f3d_train_stats(
            _ptr(x), ns, gp, g_total, cin0, _ptr(wts), _ptr(convs), convs.shape[0], nblk,
            _ptr(part), _stream(x)), "train_stats")


# K8's and K10's stages as csrc/fused_train.cu numbers them: a split launch
# returns from each cluster after its stage
FINAL_STOPS = {"recompute": 1}
BWD_STOPS = {"recompute": 1, "dy": 2, "dw": 3, "dcat": 4}


def launch_train_final(x, wts, convs, nblk, pooled, stop: Optional[str] = None) -> None:
    """stop: a key of FINAL_STOPS for the time split (pooled not written)."""
    ns, gp, cin0 = x.shape
    args = [_ptr(x), ns, gp, cin0, _ptr(wts), _ptr(convs), convs.shape[0], nblk, _ptr(pooled)]
    with torch.cuda.device(x.device):
        if stop is None:
            check(library().f3d_train_final(*args, _stream(x)), "train_final")
        else:
            check(library().f3d_train_final_split(*args, FINAL_STOPS[stop], _stream(x)),
                  "train_final_split")


def launch_train_bwd_top(x, wts, convs, vecs, nblk, dpool, part) -> None:
    """vecs: host int32 offsets of (mu, isig) in wts."""
    ns, gp, cin0 = x.shape
    with torch.cuda.device(x.device):
        check(library().f3d_train_bwd_top(
            _ptr(x), ns, gp, cin0, _ptr(wts), _ptr(convs), convs.shape[0], _ptr(vecs), nblk,
            _ptr(dpool), _ptr(part), _stream(x)), "train_bwd_top")


def launch_train_bwd(x, g_total, wts, convs, vecs, nblk, is_top, src, dw_part, db_part,
                     out, bst_part, stop: Optional[str] = None) -> None:
    """vecs: host int32 offsets of (mu, isig, m1, m2, ga, mu_p, isig_p);
    stop: a key of BWD_STOPS for the time split (partial outputs)."""
    ns, gp, cin0 = x.shape
    args = [_ptr(x), ns, gp, g_total, cin0, _ptr(wts), _ptr(convs), convs.shape[0],
            _ptr(vecs), nblk, int(is_top), _ptr(src), int(src.dtype == torch.bfloat16),
            _ptr(dw_part), _ptr(db_part), _ptr(out), int(out.dtype == torch.bfloat16),
            _ptr(bst_part)]
    with torch.cuda.device(x.device):
        if stop is None:
            check(library().f3d_train_bwd(*args, _stream(x)), "train_bwd")
        else:
            check(library().f3d_train_bwd_split(*args, BWD_STOPS[stop], _stream(x)),
                  "train_bwd_split")


# the passes as csrc/fused_train.cu's f3d_train_occupancy numbers them
TRAIN_KINDS = {"train_stats": 0, "train_final": 1, "train_bwd_top": 2, "train_bwd": 3}


def train_occupancy(kind: str, x, convs, is_top: bool = False):
    """(dynamic shared-memory bytes, blocks per SM) of a training pass's
    launch on the tower of `convs` (host int32 (n, 9) table) for x's shape."""
    ns, gp, cin0 = x.shape
    out = torch.zeros(2, dtype=torch.int32)
    check(library().f3d_train_occupancy(TRAIN_KINDS[kind], ns, gp, cin0, _ptr(convs),
                                        convs.shape[0], int(is_top), _ptr(out)),
          "train_occupancy")
    return int(out[0]), int(out[1])


def launch_three_interp(unknown, known, feats, out, idx, w) -> None:
    """K11: unknown (b, n, 3), known (b, m, 3), feats (b, m, c) into out
    (b, n, c), idx (b, n, 3) int32 and w (b, n, 3)."""
    b, n, _ = unknown.shape
    m, c = feats.shape[1], feats.shape[2]
    with torch.cuda.device(unknown.device):
        check(library().f3d_three_interp(_ptr(unknown), _ptr(known), _ptr(feats), b, n, m, c,
                                         _ptr(out), _ptr(idx), _ptr(w), _stream(unknown)),
              "three_interp")
