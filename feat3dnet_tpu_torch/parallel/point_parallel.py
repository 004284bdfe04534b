"""Keypoint-axis parallelism for whole-cloud extraction (port of
feat3dnet_tpu/parallel/point_parallel.py): thin wrappers over an
`InferencePipeline(mesh=...)`, whose own stages copy the cloud (1.5 MB at
131 072 points) to every device and split its keypoint / centre axis over
them, with no halo and no neighbour exchange (inference/pipeline.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet


def keypoint_sharded_attention(model: Feat3DNet, mesh: Sequence[torch.device],
                               chunk: Optional[int] = None) -> Callable:
    """fn(cloud (1, N, 3), valid (1, N)) -> (attention (N,), orientation (N,))
    on the mesh's first device, the keypoint axis (every point) split over
    the mesh: each device runs the ball query and the detector for its
    points in passes of `chunk` (default: its whole shard), as the dense
    route's attention pass runs them (`InferencePipeline.attention`). N
    must split evenly over the mesh (the JAX rule; buckets are powers of
    two)."""
    from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline

    pipe = InferencePipeline(model, None, model.cfg, mesh=mesh)
    return lambda cloud, valid: pipe.attention(cloud, valid,
                                               chunk or cloud.shape[1] // len(pipe.mesh))


def make_sharded_extract(model: Feat3DNet, mesh: Sequence[torch.device], mcfg, icfg,
                         n_bucket: int) -> Callable:
    """Sharded end-to-end extraction of one cloud on the hashed route:
    impl(xyz (1, n_bucket, 3), valid (1, n_bucket), layout (block, tile))
    -> (kp (1, K, 3), features (1, K, D), kp_att (1, K), num (1,)) on the
    mesh's first device, equal to the single-device hashed route's
    (`InferencePipeline.extract_on_device` on a mesh pipeline). impl
    raises unless n_bucket and K split over the mesh as JAX's rules ask."""
    from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline

    pipe = InferencePipeline(model, None, mcfg, icfg, mesh=mesh)

    def impl(xyz: torch.Tensor, valid: torch.Tensor, layout: Tuple[int, int]):
        if xyz.shape[1] != n_bucket:
            raise ValueError(f"make_sharded_extract: built for bucket {n_bucket}, "
                             f"got {xyz.shape[1]} points")
        return pipe.extract_on_device(xyz, valid, layout)

    return impl
