"""Point-set primitives of the port.

  farthest_point_sample -> fps.py (kernel K1 on CUDA, plain scan on CPU)
  ball_query            -> neighborhoods.py, dispatching to kernel K2
                           (batch_group.py) on CUDA; a scalar or a (B, M)
                           per-centre radius (QueryBallPoint2)
  group_points, gather_points, pairwise_sqdist -> neighborhoods.py (torch)
  knn_points            -> neighborhoods.py (a stable sort, torch)
  prob_sample           -> sampling.py (cumsum + searchsorted, torch)
  sample_points, sample_and_group, sample_and_group_all -> pointnet.py
                           (K1 and K2 on CUDA)
  hashed_ball_query, ball_max_sorted, ball_query_grouped_sorted,
  build_sorted_cloud    -> hash_grid.py (kernels K4 and K5 on CUDA, plain
                           chunked scans on CPU; the Morton layout in torch)
  nms_keypoints, select_keypoints -> nms.py (torch)

The tower kernels K3 (whole forward) and K6 (detector only) are in
fused_describe.py. JAX's CSR and planes entry points (build_hit_csr_host,
ball_query_grouped_csr, ball_max_csr) are TPU layouts of the sorted ball
query and ball max, which K4 and K5 compute; they are not ported.
"""
from feat3dnet_tpu_torch.ops.fps import farthest_point_sample
from feat3dnet_tpu_torch.ops.hash_grid import (ball_max_sorted, ball_query_grouped_sorted,
                                               build_sorted_cloud, hashed_ball_query)
from feat3dnet_tpu_torch.ops.neighborhoods import (ball_query, gather_points,
                                                   group_points, knn_points,
                                                   pairwise_sqdist)
from feat3dnet_tpu_torch.ops.nms import nms_keypoints, select_keypoints
from feat3dnet_tpu_torch.ops.pointnet import (sample_and_group, sample_and_group_all,
                                              sample_points)
from feat3dnet_tpu_torch.ops.sampling import prob_sample

__all__ = [
    "ball_query",
    "gather_points",
    "group_points",
    "knn_points",
    "pairwise_sqdist",
    "farthest_point_sample",
    "prob_sample",
    "nms_keypoints",
    "sample_points",
    "sample_and_group",
    "sample_and_group_all",
    "select_keypoints",
    "hashed_ball_query",
    "ball_query_grouped_sorted",
    "ball_max_sorted",
    "build_sorted_cloud",
]
