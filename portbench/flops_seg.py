"""PointNet++ MSG segmentation (configs/pointnet2-msg-kitti-seg.json): the
work its forward needs at the published widths, counted as flops.py counts
it (a FLOP is 2 MACs; bytes each input read once, each output written
once), and the device kernels of the parts its per-layer metrics read.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# K11's and K1's kernels (csrc/three_interp.cu, csrc/fps.cu)
K11_KERNELS = ("three_interp_kernel",)
FPS_KERNELS = ("fps_cluster_kernel",)


def _chain(cin: int, widths) -> Tuple[int, int]:
    """(sum of cin*cout over the layers, last width)."""
    macs = 0
    for c in widths:
        macs += cin * c
        cin = c
    return macs, cin


def _levels(cfg: Dict) -> Tuple[List[int], List[int]]:
    """Points and feature widths of the levels 0 (the cloud) to 4."""
    points = [int(cfg["num_points"])] + [int(n) for n in cfg["npoints"]]
    widths = [0] + [sum(m[-1] for m in level) for level in cfg["sa_mlps"]]
    return points, widths


def fp_levels(cfg: Dict) -> List[Tuple[int, int, int, int]]:
    """(unknown points, known points, known width, cin of its MLP) of each
    FP level, FP1 first."""
    points, widths = _levels(cfg)
    fp = cfg["fp_mlps"]
    out = []
    for k in range(len(fp)):
        known_w = fp[k + 1][-1] if k + 1 < len(fp) else widths[-1]
        out.append((points[k], points[k + 1], known_w, known_w + widths[k]))
    return out


def cloud_macs(cfg: Dict) -> int:
    """One cloud's forward: every SA scale's shared MLP over its npoint x
    nsample members, every FP MLP over its level's points, the head."""
    points, widths = _levels(cfg)
    macs = 0
    for k, level in enumerate(cfg["sa_mlps"]):
        for ns, mlp in zip(cfg["nsamples"][k], level):
            macs += points[k + 1] * int(ns) * _chain(3 + widths[k], mlp)[0]
    for (n, _, _, cin), mlp in zip(fp_levels(cfg), cfg["fp_mlps"]):
        macs += n * _chain(cin, mlp)[0]
    head, last = _chain(cfg["fp_mlps"][0][-1], cfg["cls_fc"])
    return macs + points[0] * (head + last)


def model_flops(cfg: Dict, clouds: int) -> float:
    return 2.0 * clouds * cloud_macs(cfg)


def k11_work(cfg: Dict, clouds: int) -> Tuple[float, float]:
    """K11 on every FP level of `clouds` clouds: (FLOPs, bytes). FLOPs: 8 a
    pair of its search (3 differences, 3 squares, 2 sums), 6 C a point of
    its weighted sum; bytes: both levels' xyz and the known features in,
    the C-wide output and the 3 indices and weights a point out."""
    flop = nbytes = 0.0
    for n, m, c, _ in fp_levels(cfg):
        flop += 8.0 * n * m + 6.0 * n * c
        nbytes += 4.0 * (3 * n + 3 * m + m * c + n * c + 6 * n)
    return clouds * flop, clouds * nbytes
