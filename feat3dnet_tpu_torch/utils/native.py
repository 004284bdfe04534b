"""The native point-cloud reader (port of feat3dnet_tpu/utils/native.py,
without morton_pack).

csrc/host/pointcloud_io.cpp is built with g++ at first use, with the JAX
package's Makefile flags, into `build/feat3dnet_tpu_torch/native/<hash>/`
beside the package, keyed by a hash of the source, the compiler and the
flags (as kernels.build keys the CUDA library). Concurrent first uses build
into their own temporary directories and rename one into place. Nothing
builds at import.

`load_processed` / `load_processed_batch` read, crop and resample clouds
exactly as the JAX package's native reader does, bit for bit; the batch
call reads on a pool of C++ threads outside the interpreter's lock. Where
the library cannot be built they raise (`native_available()` says whether
it can); the port has no silent numpy stand-in. A failed read raises
IOError.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host", "pointcloud_io.cpp")
# native/Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
_LIB_NAME = "libf3d_host.so"


@dataclasses.dataclass(frozen=True)
class NativeBuild:
    path: str          # the shared library
    seconds: float     # g++ wall time (0.0 when an existing build was reused)


def build_dir() -> str:
    """`build/feat3dnet_tpu_torch/native/` at the root of the checkout."""
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "feat3dnet_tpu_torch", "native")


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH); the native "
                           "point-cloud reader cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def build() -> NativeBuild:
    """Compile the reader once per hash of its source, compiler and flags."""
    cxx = _cxx()
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    out_dir = os.path.join(build_dir(), h.hexdigest()[:16])
    lib = os.path.join(out_dir, _LIB_NAME)
    if os.path.isfile(lib):
        return NativeBuild(lib, 0.0)
    os.makedirs(build_dir(), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".build_", dir=build_dir())
    try:
        t0 = time.perf_counter()
        cmd = [cxx, *CXX_FLAGS, "-shared", "-o", os.path.join(tmp, _LIB_NAME), SOURCE,
               "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        seconds = time.perf_counter() - t0
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not os.path.isfile(lib):      # not another process's finished build
                raise
            seconds = 0.0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return NativeBuild(lib, seconds)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded, bound reader (built on first use); raises if it cannot be."""
    lib = ctypes.CDLL(build().path)
    f = ctypes.POINTER(ctypes.c_float)
    lib.f3d_load_processed.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_uint64, f]
    lib.f3d_load_processed.restype = ctypes.c_int
    lib.f3d_load_processed_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), f, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.f3d_load_processed_batch.restype = ctypes.c_int
    lib.f3d_read_cloud.argtypes = [ctypes.c_char_p, ctypes.c_int, f, ctypes.c_long]
    lib.f3d_read_cloud.restype = ctypes.c_long
    return lib


@functools.lru_cache(maxsize=None)
def native_available() -> bool:
    """Whether the reader builds and loads here (tried once per process)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_processed(path: str, num_cols: int, crop_radius: float, num_points: int,
                   seed: int) -> np.ndarray:
    """Read, crop and resample one cloud -> (num_points, num_cols) float32."""
    out = np.empty((num_points, num_cols), np.float32)
    rc = library().f3d_load_processed(path.encode(), num_cols, ctypes.c_float(crop_radius),
                                      num_points, ctypes.c_uint64(seed & (2**64 - 1)),
                                      _floats(out))
    if rc != 0:
        raise IOError(f"native loader failed on {path} (rc={rc})")
    return out


def load_processed_batch(paths: Sequence[str], num_cols: int, crop_radius: float,
                         num_points: int, seeds: Sequence[int],
                         num_threads: int = 0) -> np.ndarray:
    """`load_processed` of every path with its seed, on num_threads threads
    (0: one per core) -> (len(paths), num_points, num_cols) float32."""
    n = len(paths)
    out = np.empty((n, num_points, num_cols), np.float32)
    status = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_seeds = np.asarray([s & (2**64 - 1) for s in seeds], np.uint64)
    rc = library().f3d_load_processed_batch(
        c_paths, n, num_cols, ctypes.c_float(crop_radius), num_points,
        c_seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), _floats(out),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    if rc != 0:
        bad: List[str] = [paths[i] for i in np.nonzero(status)[0]]
        raise IOError(f"native batch loader failed on {bad[:3]}")
    return out


def read_cloud(path: str, num_cols: int = 6) -> np.ndarray:
    """A whole .bin cloud -> (rows, num_cols) float32, as data/io.load_point_cloud."""
    rows = os.path.getsize(path) // (4 * num_cols)
    out = np.empty((rows, num_cols), np.float32)
    got = library().f3d_read_cloud(path.encode(), num_cols, _floats(out), rows)
    if got < 0:
        raise IOError(f"native read failed on {path} (rc={got})")
    return out[:got]
