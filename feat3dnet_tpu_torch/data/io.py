"""Point-cloud binary IO (numpy-only copy of feat3dnet_tpu/data/io.py).

Formats: cloud .bin = float32 rows of `num_cols` (6 = XYZ + normals);
cloud .txt = comma-delimited ascii; descriptor .bin = float32 rows of
[x y z d_0 ... d_{D-1}].
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def example_data_dir() -> str:
    """Directory of the vendored example clouds (examples/data/*.bin).

    Resolves only the copy that ships with the repository and raises if it
    is missing.
    """
    here = os.path.dirname(os.path.abspath(__file__))
    vendored = os.path.normpath(os.path.join(here, "..", "..", "examples", "data"))
    if not os.path.isfile(os.path.join(vendored, "oxford_270.bin")):
        raise FileNotFoundError(f"vendored example clouds not found in {vendored}")
    return vendored


def example_cloud_path(name: str) -> str:
    """Path to a vendored example cloud, e.g. example_cloud_path('oxford_270.bin')."""
    return os.path.join(example_data_dir(), name)


def load_point_cloud(path: str, num_cols: int = 6) -> np.ndarray:
    """Read a point cloud as (N, num_cols) float32."""
    if path.endswith("bin"):
        flat = np.fromfile(path, dtype=np.float32)
        if flat.size % num_cols != 0:
            raise ValueError(
                f"{path}: {flat.size} floats not divisible by num_cols={num_cols}")
        return flat.reshape(-1, num_cols)
    return np.loadtxt(path, dtype=np.float32, delimiter=",")


def save_point_cloud(path: str, cloud: np.ndarray) -> None:
    """Write a cloud as float32 rows (the .bin format load_point_cloud reads)."""
    np.ascontiguousarray(cloud, dtype=np.float32).tofile(path)


def save_descriptors(path: str, xyz: np.ndarray, features: np.ndarray) -> None:
    """Write [xyz | descriptor] float32 rows."""
    out = np.concatenate(
        [np.asarray(xyz, np.float32), np.asarray(features, np.float32)], axis=1)
    out.tofile(path)


def load_descriptors(path: str, feature_dim: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Read a descriptor .bin back into (xyz (N, 3), features (N, D))."""
    rows = np.fromfile(path, dtype=np.float32).reshape(-1, 3 + feature_dim)
    return rows[:, :3], rows[:, 3:]
