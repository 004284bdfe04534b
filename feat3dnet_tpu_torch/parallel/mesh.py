"""Device meshes of the inference paths (port of feat3dnet_tpu/parallel/mesh.py).

A mesh is a tuple of torch devices, one per shard, that the pipeline's
sharded extraction (inference/pipeline.py `mesh=`, `cloud_mesh=`) spreads
its work over, each shard under its device (`on_device`). A mesh may name
a device more than once: its shards then run one after the other there,
with the real splits (how one card checks the sharded code).
Data-parallel training takes a torch.distributed process group instead
(data_parallel.py).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

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


def on_device(dev: Optional[torch.device]):
    """The context a shard's launches run in (None: the caller's own)."""
    cuda = dev is not None and dev.type == "cuda"
    return torch.cuda.device(dev) if cuda else contextlib.nullcontext()


def chunk_shards(n: int, unit: int, n_dev: int) -> List[Tuple[int, int]]:
    """(start, end) rows of each device's shard of n rows, cut on multiples
    of `unit`: the n / unit units dealt in contiguous runs, the first
    devices taking one more where they do not split evenly (and the last
    taking none when there are fewer units than devices)."""
    nu = n // unit
    cut = [-(-i * nu // n_dev) * unit for i in range(n_dev + 1)]
    return list(zip(cut[:-1], cut[1:]))


def replicas(model: torch.nn.Module, mesh: Sequence[torch.device]
             ) -> Dict[torch.device, torch.nn.Module]:
    """One model per distinct device of the mesh: the model itself on its
    own device, a copy on each other one."""
    home = next(model.parameters()).device
    out: Dict[torch.device, torch.nn.Module] = {}
    for dev in mesh:
        if dev not in out:
            out[dev] = model if dev == home else copy.deepcopy(model).to(dev)
    return out
