"""k-NN plane-fit normal estimation.

Port of the reference's findPointNormals.m (scripts_data_processing/common/,
duplicated at scripts/external/): for each point, take its k nearest
neighbors (self excluded), form the covariance of (point − neighbor)
differences, normal = eigenvector of the smallest eigenvalue, curvature =
λ_min/Σλ, flip normals toward a viewpoint (optionally by the largest normal
component only, which is more stable near the viewpoint).

Fully vectorized: one batched eigh over (N, 3, 3) instead of the MATLAB
per-point eig loop. kNN is an exact blocked brute-force (the clouds here
are ≤ a few hundred k points; a KD-tree's O(N log N) constant loses to a
vectorized O(N²/block) scan at this scale on modern hardware).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _knn_indices(points: np.ndarray, k: int, block: int = 2048) -> np.ndarray:
    """Exact kNN (self excluded): (N, 3) -> (N, k) indices."""
    n = points.shape[0]
    out = np.empty((n, k), np.int64)
    for start in range(0, n, block):
        q = points[start:start + block]
        d2 = np.sum((q[:, None, :] - points[None, :, :]) ** 2, axis=-1)
        idx = np.argpartition(d2, kth=min(k, n - 1), axis=1)[:, :k + 1]
        # order the candidate set, drop self (distance 0 comes first)
        part = np.take_along_axis(d2, idx, axis=1)
        order = np.argsort(part, axis=1, kind="stable")
        idx = np.take_along_axis(idx, order, axis=1)
        self_col = idx == (np.arange(start, start + q.shape[0])[:, None])
        # after sorting, self is column 0 (or an exact duplicate is); remove
        # one self occurrence per row
        keep = np.ones_like(idx, bool)
        first_self = np.argmax(self_col, axis=1)
        keep[np.arange(idx.shape[0]), first_self] = False
        out[start:start + q.shape[0]] = idx[keep].reshape(q.shape[0], k)
    return out


def estimate_normals(
    points: np.ndarray,
    k: int = 9,
    viewpoint: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    dir_largest: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (normals (N,3), curvature (N,), normalized_curvature (N,))."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    if n <= k:
        raise ValueError(f"need more than k={k} points, got {n}")
    nbr = _knn_indices(points, k)

    diff = points[:, None, :] - points[nbr]              # (N, k, 3)
    cov = np.einsum("nki,nkj->nij", diff, diff) / k      # (N, 3, 3)
    w, v = np.linalg.eigh(cov)                           # ascending eigenvalues
    normals = v[:, :, 0]                                 # smallest eigval's vector
    curvature = w[:, 0] / np.maximum(np.sum(w, axis=1), 1e-300)

    # flip toward viewpoint
    rel = points - np.asarray(viewpoint, np.float64)
    if dir_largest:
        comp = np.argmax(np.abs(normals), axis=1)
        rows = np.arange(n)
        flip = normals[rows, comp] * rel[rows, comp] > 0
    else:
        flip = np.sum(normals * rel, axis=1) > 0
    normals[flip] = -normals[flip]

    denom = curvature.max() - curvature.min()
    norm_curv = (curvature - curvature.min()) / (denom if denom > 0 else 1.0)
    norm_curv = 1.0 / (1.0 + np.exp(-10.0 * (norm_curv - norm_curv.mean())))
    return normals.astype(np.float32), curvature.astype(np.float32), norm_curv.astype(np.float32)
