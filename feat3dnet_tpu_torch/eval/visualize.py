"""Match / alignment visualization.

Ports of the reference MATLAB plotting utilities (scripts/Utils.m:136-288
visualizeMatches/plotPointClouds, scripts/show_alignment.m): matplotlib
figures saved to file (headless-safe), no MATLAB required. A copy of
feat3dnet_tpu/eval/visualize.py; matplotlib is imported only when a figure
is drawn, and its absence raises with a clear message.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("plotting needs matplotlib, which is not installed here; "
                           "run without --plot_dir") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ax3d(figsize=(10, 8)):
    plt = _pyplot()
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    return fig, ax


def plot_point_clouds(cloud1: np.ndarray, cloud2: Optional[np.ndarray] = None,
                      out_path: str = "clouds.png",
                      offset: Tuple[float, float, float] = (0, 0, 0)) -> str:
    """Overlay up to two clouds (cloud2 drawn offset, Utils.m plot style)."""
    fig, ax = _ax3d()
    ax.scatter(cloud1[:, 0], cloud1[:, 1], cloud1[:, 2], s=0.3, c="tab:blue")
    if cloud2 is not None:
        c2 = cloud2[:, :3] + np.asarray(offset)
        ax.scatter(c2[:, 0], c2[:, 1], c2[:, 2], s=0.3, c="tab:red")
    ax.set_box_aspect((1, 1, 0.3))
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    _pyplot().close(fig)
    return out_path


def plot_matches(cloud1: np.ndarray, kp1: np.ndarray,
                 cloud2: np.ndarray, kp2: np.ndarray,
                 matches: np.ndarray,
                 inlier_mask: Optional[np.ndarray] = None,
                 out_path: str = "matches.png",
                 separation: float = 40.0) -> str:
    """Side-by-side clouds with match lines (green = inlier, red = outlier),
    the visualizeMatches.m figure."""
    fig, ax = _ax3d(figsize=(14, 8))
    off = np.array([separation, 0.0, 0.0])
    ax.scatter(cloud1[:, 0], cloud1[:, 1], cloud1[:, 2], s=0.2, c="lightgray")
    c2 = cloud2[:, :3] + off
    ax.scatter(c2[:, 0], c2[:, 1], c2[:, 2], s=0.2, c="lightgray")
    for j, i in enumerate(matches):
        a = kp1[int(i), :3]
        b = kp2[j, :3] + off
        good = inlier_mask is None or bool(inlier_mask[j])
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                c="green" if good else "red", linewidth=0.5, alpha=0.7)
    ax.set_box_aspect((2, 1, 0.3))
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    _pyplot().close(fig)
    return out_path


def plot_alignment(cloud1: np.ndarray, cloud2: np.ndarray,
                   rotation: np.ndarray, translation: np.ndarray,
                   out_path: str = "alignment.png") -> str:
    """cloud2 transformed into cloud1's frame and overlaid
    (show_alignment.m)."""
    moved = cloud2[:, :3] @ np.asarray(rotation).T + np.asarray(translation)
    return plot_point_clouds(cloud1[:, :3], moved, out_path=out_path)
