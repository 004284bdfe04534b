"""The work the algorithm needs, counted from the configuration's widths.

MACs count the products of the model at its published widths over the
clusters of real points only (a bucket's padding points are work the
inputs do not need); a FLOP is 2 MACs. Bytes count each input read once
and each output written once. A bound is the larger of FLOPs over the
peak and bytes over the memory rate (peaks.json).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> Dict[str, float]:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def _chain(cin: int, widths) -> Tuple[int, int]:
    """(sum of cin*cout over the layers, last width)."""
    macs = 0
    for c in widths:
        macs += cin * c
        cin = c
    return macs, cin


def detector_slot_macs(cfg: Dict) -> int:
    """Per sample slot: the detector's per-point convs (3 -> 64 -> 128 -> 256)."""
    return _chain(3, cfg["detector_mlp"])[0]


def detector_cluster_macs(cfg: Dict) -> int:
    """Per cluster: the per-slot convs over ns slots, the post convs and the
    attention and orientation heads."""
    _, top = _chain(3, cfg["detector_mlp"])
    post, last = _chain(top, cfg["detector_mlp2"])
    return cfg["num_samples"] * detector_slot_macs(cfg) + post + last * 3


def descriptor_slot_macs(cfg: Dict) -> int:
    """Per sample slot: the descriptor's convs before its second pool
    (3 -> 32 -> 64, then [h | pool] 128 -> 128)."""
    pre, top = _chain(3, cfg["descriptor_mlp"])
    return pre + _chain(2 * top, cfg["descriptor_mlp2"])[0]


def descriptor_cluster_macs(cfg: Dict) -> int:
    mid_top = cfg["descriptor_mlp2"][-1]
    return cfg["num_samples"] * descriptor_slot_macs(cfg) + _chain(mid_top, cfg["descriptor_mlp3"])[0]


def extract_flops(cfg: Dict, real_points: int, keypoints: int) -> float:
    """One cloud's extraction: the detector at every real point, the
    descriptor at every keypoint."""
    return 2.0 * (real_points * detector_cluster_macs(cfg)
                  + keypoints * descriptor_cluster_macs(cfg))


def cluster_bytes(cfg: Dict, clusters: int, outputs: int) -> float:
    """(clusters, ns, 3) f32 offsets in, `outputs` f32 values per cluster out."""
    return 4.0 * clusters * (cfg["num_samples"] * 3 + outputs)


def k6_work(cfg: Dict, real_points: int) -> Tuple[float, float]:
    """K6 (the detector alone) on the clusters of `real_points`: (FLOPs, bytes);
    out: attention and orientation."""
    return 2.0 * real_points * detector_cluster_macs(cfg), cluster_bytes(cfg, real_points, 2)


def k3_work(cfg: Dict, clusters: int) -> Tuple[float, float]:
    """K3 (detector + descriptor) on `clusters`: (FLOPs, bytes); out: the
    descriptor and the attention."""
    return 2.0 * clusters * model_macs_per_cluster(cfg), cluster_bytes(cfg, clusters, cfg["descriptor_mlp3"][-1] + 1)


def _segment_layers(cfg: Dict):
    """(cin, cout) of the layers before each tower's last pool: the
    detector's per-point convs, the descriptor's convs and its mid conv."""
    layers, cin = [], 3
    for c in cfg["detector_mlp"]:
        layers.append((cin, c))
        cin = c
    firsts = (0, len(layers))
    cin = 3
    for c in cfg["descriptor_mlp"]:
        layers.append((cin, c))
        cin = c
    cin *= 2
    for c in cfg["descriptor_mlp2"]:
        layers.append((cin, c))
        cin = c
    return layers, firsts


def towers_work(cfg: Dict, clouds: int) -> Tuple[float, float]:
    """K7-K10 taken together on one step: the pre-pool segments' forward
    (every layer), their weight gradients (every layer) and their input
    gradients (every layer but each tower's first, whose input is data),
    over clouds x num_clusters x ns rows; bytes: the two towers' grouped
    inputs read and their pooled outputs written, the pooled cotangents read."""
    rows = clouds * cfg["num_clusters"] * cfg["num_samples"]
    layers, firsts = _segment_layers(cfg)
    fwd = sum(a * b for a, b in layers)
    dx = sum(a * b for i, (a, b) in enumerate(layers) if i not in firsts)
    flops = 2.0 * rows * (2 * fwd + dx)
    tops = cfg["detector_mlp"][-1] + cfg["descriptor_mlp2"][-1]
    nbytes = 4.0 * (2 * rows * 3 + 2 * clouds * cfg["num_clusters"] * tops)
    return flops, nbytes


def model_macs_per_cluster(cfg: Dict) -> int:
    return detector_cluster_macs(cfg) + descriptor_cluster_macs(cfg)


def train_step_flops(cfg: Dict, clouds: int) -> float:
    """One training step: the whole model's forward at every cluster and its
    backward (input and weight gradients, twice the forward)."""
    return 2.0 * 3 * clouds * cfg["num_clusters"] * model_macs_per_cluster(cfg)


def bound_s(flops: float, nbytes: float) -> float:
    p = peaks()
    return max(flops / p["flops_per_s"], nbytes / p["bytes_per_s"])
