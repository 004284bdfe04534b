"""Multi-device parallelism (port of feat3dnet_tpu/parallel/).

* data parallelism (data_parallel.py): one process a rank over a
  torch.distributed group, each with its role-aligned share of the
  triplet batch; global BN moments and one gradient all-reduce a step, so
  the step equals the single process's on the combined batch;
* point parallelism (point_parallel.py): the keypoint / centre axis of one
  cloud split over a mesh of devices, the cloud copied to each;
* meshes (mesh.py) and the multi-process glue (multihost.py).
"""
from feat3dnet_tpu_torch.parallel.data_parallel import (make_chained_dp_train_step,
                                                        make_dp_train_step,
                                                        make_fused_dp_train_step, run_ranks,
                                                        shard_batch)
from feat3dnet_tpu_torch.parallel.mesh import as_mesh, make_mesh
from feat3dnet_tpu_torch.parallel.point_parallel import (keypoint_sharded_attention,
                                                         make_sharded_extract)

__all__ = [
    "make_mesh", "as_mesh", "make_dp_train_step", "make_fused_dp_train_step",
    "make_chained_dp_train_step",
    "shard_batch", "run_ranks", "keypoint_sharded_attention", "make_sharded_extract",
]
