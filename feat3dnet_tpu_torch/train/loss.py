"""Attention-weighted alignment triplet loss (port of feat3dnet_tpu/train/loss.py).

Reference Feat3dNet.get_loss: pairwise squared L2 between the anchor's and
the positive's / negative's descriptor sets (no sqrt); per anchor
descriptor the minimum over the other set (`torch.amin`, whose gradient
splits evenly among ties as jnp.min's does); a sum weighted by the
sum-normalised anchor attention, or a plain mean without attention; the
hinge max(0, pos - neg + margin); the batch mean.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from feat3dnet_tpu_torch.models.layers import pairwise_sqdist_features


def alignment_triplet_loss(anchor_features: torch.Tensor, positive_features: torch.Tensor,
                           negative_features: torch.Tensor,
                           anchor_attention: Optional[torch.Tensor], margin: float = 0.2
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, M, D) x3 and (B, M) attention or None -> (scalar loss, aux with
    sum_positive / sum_negative (B,) and normalized_attention)."""
    best_positive = torch.amin(pairwise_sqdist_features(anchor_features, positive_features), dim=2)
    best_negative = torch.amin(pairwise_sqdist_features(anchor_features, negative_features), dim=2)
    aux: Dict[str, torch.Tensor] = {}
    if anchor_attention is None:
        sum_positive = best_positive.mean(dim=1)
        sum_negative = best_negative.mean(dim=1)
    else:
        attention_sm = anchor_attention / anchor_attention.sum(dim=1, keepdim=True)
        sum_positive = (attention_sm * best_positive).sum(dim=1)
        sum_negative = (attention_sm * best_negative).sum(dim=1)
        aux["normalized_attention"] = attention_sm
    aux["sum_positive"] = sum_positive
    aux["sum_negative"] = sum_negative
    cost = sum_positive - sum_negative + margin
    return torch.maximum(cost, torch.zeros_like(cost)).mean(), aux
