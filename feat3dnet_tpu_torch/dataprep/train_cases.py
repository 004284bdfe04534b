"""train.txt generation.

Port of oxford_generate_train_cases.m: given cloud filenames and their
world positions, exclude a held-out test region, then for each cloud write
`fname | positives | nonnegatives` where positives are clouds strictly
closer than POSITIVE_THRESH (11 m — note: includes the cloud itself, as in
the reference) and nonnegatives are clouds in [POSITIVE_THRESH,
NEGATIVE_THRESH] (50 m). Indices are 0-based into the filtered list.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def generate_train_cases(
    fnames: Sequence[str],
    positions: np.ndarray,
    output_path: str,
    positive_thresh: float = 11.0,
    negative_thresh: float = 50.0,
    test_bounds: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = ((-np.inf, np.inf), (-np.inf, 100.0)),
) -> int:
    """Write train.txt; returns the number of retained clouds.

    Args:
      fnames: cloud file names (relative paths as stored in train.txt).
      positions: (N, >=2) world XY(Z) of each cloud's origin.
      test_bounds: ((xmin, xmax), (ymin, ymax)) — clouds strictly inside
        are EXCLUDED (reserved for testing); None disables the split.
    """
    positions = np.asarray(positions, np.float64)
    fnames = list(fnames)
    if test_bounds is not None:
        (x0, x1), (y0, y1) = test_bounds
        in_test = ((positions[:, 0] > x0) & (positions[:, 0] < x1)
                   & (positions[:, 1] > y0) & (positions[:, 1] < y1))
        keep = ~in_test
        fnames = [f for f, k in zip(fnames, keep) if k]
        positions = positions[keep]

    n = len(fnames)
    d = np.sqrt(np.sum(
        (positions[:, None, :] - positions[None, :, :]) ** 2, axis=-1))
    with open(output_path, "w") as f:
        for i in range(n):
            below_low = d[i] < positive_thresh
            below_high = d[i] <= negative_thresh
            positives = np.nonzero(below_low)[0]
            nonneg = np.nonzero(below_high & ~below_low)[0]
            f.write(f"{fnames[i]}\t|\t" + "\t".join(map(str, positives))
                    + "\t|\t" + "\t".join(map(str, nonneg)) + "\n")
    return n
