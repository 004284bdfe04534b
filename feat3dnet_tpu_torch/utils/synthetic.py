"""A synthetic dense submap and an extraction-agreement measure (numpy copy
of feat3dnet_tpu/utils/synthetic.py)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_submap(n: int = 120000, seed: int = 7) -> np.ndarray:
    """n uniform points in a 100 x 100 x 10 m box, 6 columns (xyz and zeroed
    normals): the dense-submap workload."""
    rng = np.random.RandomState(seed)
    return np.concatenate([
        rng.rand(n, 3).astype(np.float32) * np.array([100, 100, 10], np.float32),
        np.zeros((n, 3), np.float32)], axis=1)


def keypoint_agreement(res_a, res_b) -> Dict[str, float]:
    """Agreement of two extraction results whose keypoint sets may differ:
    keypoints matched by coordinate, attention compared on the matched
    pairs. Returns overlap (matched / the larger set), att_relmax_matched
    (inf when nothing matches), num_a and num_b."""
    def table(res):
        kp = np.asarray(res.keypoints[:res.num_keypoints])
        att = np.asarray(res.attention[:res.num_keypoints])
        return {tuple(k): float(v) for k, v in zip(kp, att)}

    ta, tb = table(res_a), table(res_b)
    matched = set(ta) & set(tb)
    overlap = len(matched) / max(len(ta), len(tb), 1)
    rel = (max(abs(ta[k] - tb[k]) / max(abs(ta[k]), 1e-6) for k in matched)
           if matched else float("inf"))
    return {"overlap": overlap, "att_relmax_matched": rel,
            "num_a": len(ta), "num_b": len(tb)}
