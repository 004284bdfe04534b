"""Build, load and bind the port's hand-written CUDA kernels.

The sources live in `feat3dnet_tpu_torch/csrc/`. At first use they are
compiled by nvcc for `sm_90a` into one shared library with a plain C
interface, which is loaded with ctypes (no PyTorch headers, so the build
takes seconds). The library goes to `build/feat3dnet_tpu_torch/<hash>/`
beside the package, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused within a checkout.

Nothing here runs at import: the CPU tests import every module on a
machine without nvcc. A missing nvcc or a failed build raises.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()` after the launch; `check` raises on a non-zero code.
The op wrappers (ops/fps.py, ops/batch_group.py, ops/fused_describe.py)
validate tensors, allocate outputs and count launches; the `launch_*`
functions below only pass pointers.
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
SOURCES = ("fps.cu", "ball_query.cu", "fused_describe.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
def build() -> BuildInfo:
    """Compile csrc/*.cu into one shared library, once per source hash."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(build_dir(), h.hexdigest()[:16])
    lib = os.path.join(out_dir, _LIB_NAME)
    log = os.path.join(out_dir, "ptxas.txt")
    if os.path.isfile(lib):
        with open(log) as f:
            return BuildInfo(lib, 0.0, f.read())
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, proc.stdout + proc.stderr)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    lib = ctypes.CDLL(build().path)
    lib.f3d_error_string.argtypes = [_I]
    lib.f3d_error_string.restype = ctypes.c_char_p
    # xyz, mask|NULL, scratch|NULL, b, n, npoint, out, stream
    lib.f3d_fps.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P]
    lib.f3d_fps.restype = _I
    lib.f3d_fps_max_smem_points.argtypes = []
    lib.f3d_fps_max_smem_points.restype = _I
    # xyz, centers, mask|NULL, b, n, m, r2, ns, idx, cnt, stream
    lib.f3d_ball_query.argtypes = [_P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P]
    lib.f3d_ball_query.restype = _I
    # packed, ns, batch, weights, layers (host int32 array), n_det, n_det2,
    # n_desc, r2, inv_r, desc, att, stream
    lib.f3d_fused_describe.argtypes = [_P, _I, _I, _P, _P, _I, _I, _I, _F, _F,
                                       _P, _P, _P]
    lib.f3d_fused_describe.restype = _I
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


def fps_max_smem_points() -> int:
    """Largest cloud whose running-min array fits in one block's shared memory."""
    return library().f3d_fps_max_smem_points()


def launch_fps(xyz, mask, scratch, npoint, out) -> None:
    b, n, _ = xyz.shape
    with torch.cuda.device(xyz.device):
        check(library().f3d_fps(_ptr(xyz), _ptr(mask), _ptr(scratch), b, n,
                                npoint, _ptr(out), _stream(xyz)), "fps")


def launch_ball_query(xyz, centers, mask, r2, ns, idx, cnt) -> None:
    b, n, _ = xyz.shape
    m = centers.shape[1]
    with torch.cuda.device(xyz.device):
        check(library().f3d_ball_query(_ptr(xyz), _ptr(centers), _ptr(mask), b, n,
                                       m, r2, ns, _ptr(idx), _ptr(cnt),
                                       _stream(xyz)), "ball_query")


def launch_fused_describe(packed, ns, weights, layers, n_det, n_det2, n_desc,
                          r2, inv_r, desc, att) -> None:
    """layers: host int32 tensor of (cin, cout, w_offset, b_offset) rows."""
    batch = packed.shape[1]
    with torch.cuda.device(packed.device):
        check(library().f3d_fused_describe(
            _ptr(packed), ns, batch, _ptr(weights), _ptr(layers), n_det, n_det2,
            n_desc, r2, inv_r, _ptr(desc), _ptr(att), _stream(packed)),
            "fused_describe")
