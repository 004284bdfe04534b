"""Voxel-grid average downsampling.

Equivalent of MATLAB `pcdownsample(pc, 'gridAverage', gridStep)` used by
both the Oxford and KITTI processors (processPointCloud.m:28,
process_kitti_data.m:97): points are bucketed into a cubic grid and each
occupied voxel emits the mean of its members (positions and any attached
attributes, e.g. normals — which are NOT re-normalized by MATLAB; we
re-normalize by default because unit normals are what consumers assume,
with a flag for bug-compatible behavior).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def voxel_downsample(
    points: np.ndarray,
    grid: float = 0.2,
    attributes: Optional[np.ndarray] = None,
    renormalize_attributes: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points (and attributes) per occupied voxel.

    Args:
      points: (N, 3).
      grid: voxel edge length in metres.
      attributes: optional (N, C) per-point attributes averaged alongside.
      renormalize_attributes: L2-renormalize averaged attributes (for
        normals). Default False = MATLAB-compatible raw averages.

    Returns:
      (voxel_points (M, 3), voxel_attributes (M, C) or None), ordered by
      voxel id (deterministic).
    """
    points = np.asarray(points, np.float64)
    coords = np.floor(points / grid).astype(np.int64)
    # unique voxel ids via lexicographic row uniqueness
    _, inverse, counts = np.unique(coords, axis=0, return_inverse=True,
                                   return_counts=True)
    m = counts.shape[0]

    def segment_mean(values):
        acc = np.zeros((m, values.shape[1]), np.float64)
        np.add.at(acc, inverse, values)
        return acc / counts[:, None]

    out_pts = segment_mean(points).astype(np.float32)
    out_attr = None
    if attributes is not None:
        out_attr = segment_mean(np.asarray(attributes, np.float64))
        if renormalize_attributes:
            norm = np.linalg.norm(out_attr, axis=1, keepdims=True)
            out_attr = out_attr / np.maximum(norm, 1e-12)
        out_attr = out_attr.astype(np.float32)
    return out_pts, out_attr
