"""Quality metrics (numpy-only copy of feat3dnet_tpu/eval/metrics.py).

* FPR @ 95% recall — the reference's primary training-time metric
  (train.py:310-313; Readme.md:47): threshold at the 95th percentile of
  positive-pair descriptor distances, report the fraction of negative pairs
  below it.
* precision-vs-distance curves — the paper's Fig. 4 evaluation
  (scripts/fig4_step1.m:64, fig4_step2.m): a match is correct when the
  matched keypoint lands within 1.0 m of its groundtruth-transformed
  position.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def fpr_at_95_recall(positive_dist: np.ndarray, negative_dist: np.ndarray) -> float:
    """False-positive rate at the distance threshold giving 95% recall."""
    positive_dist = np.asarray(positive_dist)
    negative_dist = np.asarray(negative_dist)
    d_at_95 = np.percentile(positive_dist, 95)
    num_fp = np.count_nonzero(negative_dist < d_at_95)
    num_tn = negative_dist.size - num_fp
    return num_fp / max(num_fp + num_tn, 1)


def precision_at_thresholds(
    match_errors: np.ndarray,
    valid: np.ndarray,
    thresholds: Sequence[float] = (0.25, 0.5, 1.0, 2.0),
) -> dict:
    """Fraction of matches whose metric error is below each threshold.

    Args:
      match_errors: (N,) distance between matched keypoint (after applying
        the groundtruth transform) and its true correspondence.
      valid: (N,) bool — matches eligible for scoring (e.g. inside the
        0.75 m-intersection region, fig4_step1.m:9).
    """
    match_errors = np.asarray(match_errors)[np.asarray(valid, bool)]
    total = max(match_errors.size, 1)
    return {float(t): float(np.count_nonzero(match_errors < t)) / total
            for t in thresholds}


def precision_recall(
    score: np.ndarray,
    target: np.ndarray,
    instance_count: Optional[np.ndarray] = None,
    num_thresh: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Precision / ROC curve points over score thresholds.

    Numeric port of the reference's bundled curve utility
    (scripts/external/prec_rec.m — defined there but never called by any
    reference script; ported for completeness, plotting omitted):

    * thresholds are ``[min(score)] + quantile(score, k/num_thresh)`` for
      k = 1..num_thresh-1 (prec_rec.m:171-174), deduplicated, DESCENDING;
      MATLAB's default quantile interpolation assigns sample i the
      probability (i-0.5)/n — numpy's ``method="hazen"``;
    * ``num_thresh`` defaults to min(#unique scores, 100) (prec_rec.m:166-169);
    * per threshold t, over the selection ``score >= t`` (prec_rec.m:180-185):
      precision = positives selected / instances selected,
      tpr = positives selected / total positives,
      fpr = negatives selected / total negatives;
    * ``instance_count[i]`` optionally makes row i stand for that many
      instances of which ``target[i]`` are positive (prec_rec.m:146-163);
      without it, target is clipped to binary.

    Returns (precision, tpr, fpr, thresholds), each of the same length,
    ordered by descending threshold (so tpr/fpr ascend along the curve).
    """
    score = np.asarray(score, np.float64).ravel()
    target = np.asarray(target, np.float64).ravel()
    if score.size != target.size:
        raise ValueError("score and target must have the same length")
    if instance_count is None:
        instance_count = np.ones_like(score)
        target = np.clip(target, 0.0, 1.0)
    else:
        instance_count = np.broadcast_to(
            np.asarray(instance_count, np.float64).ravel(), score.shape
        ).astype(np.float64)
        target = np.minimum(instance_count, target)

    if num_thresh is None:
        num_thresh = min(np.unique(score).size, 100)
    qvals = np.arange(1, num_thresh) / num_thresh
    thresh = np.concatenate(
        [[score.min()], np.quantile(score, qvals, method="hazen")])
    thresh = np.unique(thresh)[::-1]

    total_pos = target.sum()
    total_neg = (instance_count - target).sum()
    # one pass per curve: cumulative sums over descending-score order
    sel = score[:, None] >= thresh[None, :]                 # (n, T)
    pos_sel = target @ sel
    inst_sel = instance_count @ sel
    prec = pos_sel / np.maximum(inst_sel, 1e-300)
    tpr = pos_sel / max(total_pos, 1e-300)
    fpr = (inst_sel - pos_sel) / max(total_neg, 1e-300)
    return prec, tpr, fpr, thresh
