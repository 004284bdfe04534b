"""Point-set primitives of the port.

  farthest_point_sample -> fps.py (kernel K1 on CUDA, plain scan on CPU)
  ball_query            -> neighborhoods.py, dispatching to kernel K2
                           (batch_group.py) on CUDA
  group_points, gather_points, pairwise_sqdist -> neighborhoods.py (torch)

The serving kernel K3 is in fused_describe.py.
"""
from feat3dnet_tpu_torch.ops.fps import farthest_point_sample
from feat3dnet_tpu_torch.ops.neighborhoods import (ball_query, gather_points,
                                                   group_points, pairwise_sqdist)

__all__ = [
    "ball_query",
    "gather_points",
    "group_points",
    "pairwise_sqdist",
    "farthest_point_sample",
]
