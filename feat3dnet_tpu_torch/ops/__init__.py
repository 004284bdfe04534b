"""Point-set primitives of the port.

  farthest_point_sample -> fps.py (kernel K1 on CUDA, plain scan on CPU)
  ball_query            -> neighborhoods.py, dispatching to kernel K2
                           (batch_group.py) on CUDA
  group_points, gather_points, pairwise_sqdist -> neighborhoods.py (torch)
  hashed_ball_query, ball_max_sorted -> hash_grid.py (kernels K4 and K5 on
                           CUDA, plain chunked scans on CPU)
  nms_keypoints, select_keypoints -> nms.py (torch)

The tower kernels K3 (whole forward) and K6 (detector only) are in
fused_describe.py.
"""
from feat3dnet_tpu_torch.ops.fps import farthest_point_sample
from feat3dnet_tpu_torch.ops.hash_grid import ball_max_sorted, hashed_ball_query
from feat3dnet_tpu_torch.ops.neighborhoods import (ball_query, gather_points,
                                                   group_points, pairwise_sqdist)
from feat3dnet_tpu_torch.ops.nms import nms_keypoints, select_keypoints

__all__ = [
    "ball_max_sorted",
    "ball_query",
    "hashed_ball_query",
    "nms_keypoints",
    "select_keypoints",
    "gather_points",
    "group_points",
    "pairwise_sqdist",
    "farthest_point_sample",
]
