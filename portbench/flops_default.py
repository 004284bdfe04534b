"""The default extraction route's towers (InferencePipeline with
use_fused_detector off): which device kernels are their products, and the
work they need, counted as flops.py counts it.

On that route every ConvBN's Dense is one `F.linear` (cuBLAS or its
CUTLASS kernels), followed by eval BatchNorm, ReLU and `torch.amax` as
torch's elementwise and reduction kernels. Kept beside flops.py, whose
functions the accepted cells read.
"""
from __future__ import annotations

from typing import Dict, Tuple

from portbench import flops

# substrings of the names of the GEMM and GEMV kernels that cuBLAS runs for
# the towers' F.linear in f32 (TF32 off)
GEMM_KERNELS = ("gemm", "gemv")


def default_towers_work(cfg: Dict, real_points: int, keypoints: int) -> Tuple[float, float]:
    """Both towers on the default route: (FLOPs, bytes). FLOPs: the detector
    at every real point and the descriptor at every keypoint (extract_flops);
    bytes: each tower's clusters in, and out the detector's attention and
    orientation and the descriptor's vector."""
    nbytes = (flops.cluster_bytes(cfg, real_points, 2)
              + flops.cluster_bytes(cfg, keypoints, cfg["descriptor_mlp3"][-1]))
    return flops.extract_flops(cfg, real_points, keypoints), nbytes
