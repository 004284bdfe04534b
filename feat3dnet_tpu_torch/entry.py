"""Entry point of the port: the counterpart of `__graft_entry__.entry()`."""
from __future__ import annotations

import torch

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.utils.convert import load_variables
from feat3dnet_tpu_torch.utils.device import resolve_device
from feat3dnet_tpu_torch.utils.init import init_variables


def entry(device=None):
    """(fn, example_args): the eval forward of the paper config (FPS 512
    clusters, radius-2 m 64-sample neighbourhoods, detector attention and
    orientation, 32-D descriptors) on a zero (2, 4 096, 3) batch, with
    seeded weights, on `device` (`cuda` unless named; raises without one).
    `fn(model, cloud)` returns (keypoints, features, attention)."""
    dev = resolve_device(device)
    cfg = ModelConfig()
    model = load_variables(Feat3DNet(cfg), init_variables(cfg, seed=0)).eval().to(dev)
    cloud = torch.zeros((2, 4096, 3), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fn(model, cloud):
        out = model(cloud)
        return out.keypoints, out.features, out.attention

    return fn, (model, cloud)
