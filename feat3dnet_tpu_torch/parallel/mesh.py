"""Device meshes of the inference paths (port of feat3dnet_tpu/parallel/mesh.py).

A mesh is a tuple of torch devices, one per shard, that the sharded
extraction (point_parallel.py) and the cloud-per-device pipeline
(inference/pipeline.py `cloud_mesh=`) spread their work over. A mesh may
name a device more than once: its shards then run one after the other on
that device, with the real splits (how one card checks the sharded code).
Data-parallel training takes a torch.distributed process group instead
(data_parallel.py).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None, device: Union[str, torch.device] = "cuda"
              ) -> Mesh:
    """`cuda:0 .. cuda:n-1` (all visible cards when n is None), or n copies
    of the CPU for device="cpu" (n defaults to 1 there). Raises when n
    exceeds the cards there are, naming how many were found."""
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device}")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = found if n_devices is None else n_devices
    if n < 1 or n > found:
        raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, {found} found")
    return tuple(torch.device("cuda", i) for i in range(n))


def as_mesh(devices: Sequence[Union[str, torch.device]]) -> Mesh:
    """A mesh from any sequence of devices (e.g. ("cuda:0", "cuda:0"))."""
    mesh = tuple(torch.device(d) for d in devices)
    mesh = tuple(torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
                 for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh
