"""SLAM submap binary → framework cloud converter.

Rebuild of the reference's submap_converter.py ingestion tool: submap files
carry a fixed header (timestamps, a 12-double pose block whose elements
10..12 are the submap world XYZ, then feature and point counts), a block of
`numFeatures` 32-D features (skipped), and `numPoints` point records of
which only the 3 float32 coordinates are used. Output: `<count>.bin` with
float32 [xyz | normals] rows plus an appended metadata.txt line
(Idx/Dataset/NumPts/X/Y/Z).

Improvements over the reference:
  * normals can actually be computed (dataprep.normals — the reference
    ships a pure-numpy estimator but writes zeros, submap_converter.py:228-231);
    zeros remain the default for byte-compatibility;
  * a thread pool replaces the multiprocessing fork pool (the work is
    numpy/IO-bound and fork+pickle per file dominates at small files).
"""
from __future__ import annotations

import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

_HEADER_DTYPE = np.dtype("i8,i4,i8,?,f8,f8,f8,f8,f8,f8,f8,f8,f8,f8,f8,f8,i4,i4")
_FEATURE_DIM = 32
_POINT_EXTRA_DTYPE = np.dtype("f4,f4,f4,u1,u1,u1,i8")


def read_submap(path: str) -> Tuple[np.ndarray, Tuple[float, float, float], dict]:
    """Parse one submap binary; returns (points (N,3) f32, world xyz, header)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_HEADER_DTYPE, count=1)[0]
        vals = list(header)
        num_features, num_points = int(vals[16]), int(vals[17])
        # skip the feature block: each feature = 3 f4 position + 32 f4 descriptor
        f.seek(num_features * 4 * (3 + _FEATURE_DIM), os.SEEK_CUR)
        # point records: 3 f4 coordinates + extras, interleaved
        rec = np.dtype([("xyz", "3f4"), ("extra", _POINT_EXTRA_DTYPE)])
        records = np.fromfile(f, dtype=rec, count=num_points)
    points = records["xyz"].astype(np.float32)
    world = (float(vals[10]), float(vals[11]), float(vals[12]))
    return points, world, {"num_features": num_features, "num_points": num_points,
                           "timestamp": int(vals[0])}


def convert_submap(path: str, index: int, out_dir: str,
                   compute_normals: bool = False,
                   metadata_lock: Optional[threading.Lock] = None) -> str:
    """Convert one submap to `<index>.bin` + metadata.txt line in
    out_dir/<parent_dir_of_path>/."""
    points, world, header = read_submap(path)
    if compute_normals and points.shape[0] > 9:
        from feat3dnet_tpu_torch.dataprep.normals import estimate_normals
        normals, _, _ = estimate_normals(points)
    else:
        normals = np.zeros_like(points)

    parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
    dst_dir = os.path.join(out_dir, parent)
    os.makedirs(dst_dir, exist_ok=True)
    out_path = os.path.join(dst_dir, f"{index}.bin")
    np.concatenate([points, normals], axis=1).astype(np.float32).tofile(out_path)

    meta_path = os.path.join(dst_dir, "metadata.txt")
    line = (f"{index}\t{parent}\t\t\t{header['num_points']}"
            f"\t{world[0]}\t{world[1]}\t{world[2]}\n")
    lock = metadata_lock or threading.Lock()
    with lock:
        new = not os.path.isfile(meta_path)
        with open(meta_path, "a") as f:
            if new:
                f.write("Idx\tDataset\tStartIdx\tEndIdx\tNumPts\tX\tY\tZ\n")
            f.write(line)
    return out_path


def convert_submaps(paths: Sequence[str], out_dir: str,
                    compute_normals: bool = False,
                    num_threads: int = 0) -> List[str]:
    """Convert many submaps concurrently (indices follow input order)."""
    num_threads = num_threads or min(8, max(1, os.cpu_count() or 1))
    lock = threading.Lock()
    with ThreadPoolExecutor(num_threads) as pool:
        futures = [pool.submit(convert_submap, p, i, out_dir, compute_normals, lock)
                   for i, p in enumerate(paths)]
        return [f.result() for f in futures]
