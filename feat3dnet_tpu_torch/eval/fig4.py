"""Detector + descriptor matching evaluation, the paper's Fig. 4 (port of
feat3dnet_tpu/eval/fig4.py; scripts/fig4_step1.m + fig4_step2.m).

Per pair (groundtruths.txt: idx1 idx2 t q_wxyz; the transform maps cloud-2
points into cloud-1's frame):
  * cloud-1 keypoints count only if some groundtruth-warped cloud-2 POINT
    lies within 0.75 m (the intersection mask);
  * for every cloud-1 descriptor, its nearest neighbour among cloud-2's
    descriptors (`match_descriptors`, on `device`);
  * a match is correct when ||kp1 − T_gt(kp2_match)|| < 1.0 m.
Aggregate: precision(d), the share of intersection matches with keypoint
error < d, for d in 0.1..10 m.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch.data.io import load_descriptors, load_point_cloud
from feat3dnet_tpu_torch.eval.matching import match_descriptors
from feat3dnet_tpu_torch.utils.device import resolve_device

INTERSECTION_DISTANCE_THRESH = 0.75   # fig4_step1.m:9
CORRECT_MATCH_THRESH = 1.0            # fig4_step1.m:10


@dataclasses.dataclass
class PairStatistic:
    num_putative: int         # intersection keypoints considered
    num_correct: int          # matches under CORRECT_MATCH_THRESH
    match_errors: np.ndarray  # keypoint errors of intersection matches (m)


def rotmat_from_quat(q: np.ndarray) -> np.ndarray:
    """(4,) wxyz quaternion -> (3, 3) rotation (copy of dataprep/oxford.py's)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_groundtruths(path: str) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
    """groundtruths.txt rows: idx1 idx2 t_1..t_3 q_1..q_4 (wxyz)."""
    out = []
    with open(path) as f:
        f.readline()
        for line in f:
            vals = line.split()
            if len(vals) < 9:
                continue
            out.append((int(float(vals[0])), int(float(vals[1])),
                        np.array([float(v) for v in vals[2:5]]),
                        np.array([float(v) for v in vals[5:9]])))
    return out


def evaluate_pair(
    cloud1: np.ndarray, kp1: np.ndarray, desc1: np.ndarray,
    cloud2: np.ndarray, kp2: np.ndarray, desc2: np.ndarray,
    rotation: np.ndarray, translation: np.ndarray,
    device: Optional[torch.device] = None,
) -> PairStatistic:
    """One pair's matching statistic (fig4_step1.m body); the descriptors
    are matched on `device` (`cuda` unless the caller names another)."""
    dev = resolve_device(device)
    warped2 = cloud2[:, :3] @ np.asarray(rotation).T + np.asarray(translation)

    # intersection mask over cloud-1 keypoints (chunked NN distance)
    d_min = np.full(kp1.shape[0], np.inf)
    for start in range(0, warped2.shape[0], 8192):
        blk = warped2[start:start + 8192]
        d = np.sqrt(((kp1[:, None, :3] - blk[None, :, :]) ** 2).sum(-1)).min(1)
        d_min = np.minimum(d_min, d)
    in_intersection = d_min < INTERSECTION_DISTANCE_THRESH

    # for every cloud-1 descriptor, its nearest neighbour among cloud-2's
    idx, _ = match_descriptors(torch.from_numpy(np.ascontiguousarray(desc2)).to(dev),
                               torch.from_numpy(np.ascontiguousarray(desc1)).to(dev))
    idx = idx.cpu().numpy()

    warped_kp2 = kp2[idx, :3] @ np.asarray(rotation).T + np.asarray(translation)
    delta = np.sqrt(((kp1[:, :3] - warped_kp2) ** 2).sum(-1))

    masked = delta[in_intersection]
    return PairStatistic(
        num_putative=int(in_intersection.sum()),
        num_correct=int((masked < CORRECT_MATCH_THRESH).sum()),
        match_errors=masked,
    )


def precision_curve(stats: Sequence[PairStatistic],
                    distances: np.ndarray = np.arange(0.1, 10.05, 0.1)
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(distances, precision %) — fig4_step2.m aggregation."""
    errors = np.concatenate([s.match_errors for s in stats]) if stats else np.array([])
    total = max(errors.size, 1)
    precision = np.array([(errors < d).sum() / total for d in distances]) * 100.0
    return distances, precision


def evaluate_dataset(data_folder: str, result_folder: str,
                     data_dim: int = 6, feature_dim: int = 32, log=print,
                     device: Optional[torch.device] = None
                     ) -> Tuple[List[PairStatistic], Dict[str, float]]:
    """Directory driver: data_folder has <idx>.bin clouds + groundtruths.txt;
    result_folder has the inference CLI's [xyz|desc] outputs."""
    dev = resolve_device(device)
    pairs = read_groundtruths(os.path.join(data_folder, "groundtruths.txt"))
    stats = []
    for i, (a, b, t, q) in enumerate(pairs):
        c1 = load_point_cloud(os.path.join(data_folder, f"{a}.bin"), data_dim)
        c2 = load_point_cloud(os.path.join(data_folder, f"{b}.bin"), data_dim)
        kp1, desc1 = load_descriptors(os.path.join(result_folder, f"{a}.bin"), feature_dim)
        kp2, desc2 = load_descriptors(os.path.join(result_folder, f"{b}.bin"), feature_dim)
        s = evaluate_pair(c1, kp1, desc1, c2, kp2, desc2, rotmat_from_quat(q), t, device=dev)
        stats.append(s)
        log(f"Pair {i + 1}/{len(pairs)}: correct @ {CORRECT_MATCH_THRESH:.1f} m: "
            f"{s.num_correct} / {s.num_putative}")

    dists, prec = precision_curve(stats)
    summary = {
        "pairs": len(stats),
        "precision_at_1m": float(prec[np.searchsorted(dists, 1.0)]) if stats else 0.0,
        "total_putative": int(sum(s.num_putative for s in stats)),
        "total_correct": int(sum(s.num_correct for s in stats)),
    }
    return stats, summary
