"""Evaluation and registration of the port: descriptor matching, RANSAC
rigid fit, FPR@95 %-recall (ports of feat3dnet_tpu/eval; the reference's
computeAndVisualizeMatches.m, fig4_step1/2.m, external/ransac*.m and the
train.py validation loop).
"""
from feat3dnet_tpu_torch.eval.matching import match_descriptors
from feat3dnet_tpu_torch.eval.metrics import (fpr_at_95_recall, precision_at_thresholds,
                                              precision_recall)
from feat3dnet_tpu_torch.eval.ransac import estimate_rigid_transform, ransac_rigid
from feat3dnet_tpu_torch.eval.validate import ClusterPairValidator

__all__ = [
    "match_descriptors", "fpr_at_95_recall", "precision_at_thresholds",
    "precision_recall",
    "estimate_rigid_transform", "ransac_rigid", "ClusterPairValidator",
]
