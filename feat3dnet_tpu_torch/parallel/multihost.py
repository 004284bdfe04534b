"""Multi-process and multi-host training glue (port of
feat3dnet_tpu/parallel/multihost.py).

Usage in each process:

    from feat3dnet_tpu_torch.parallel import multihost
    multihost.initialize()                        # torchrun's environment, or
    multihost.initialize("tcp://host:port", n, r) # explicit
    group = multihost.world()
    dataset = multihost.shard_dataset("data/oxford/train/train.txt")

`cli.train --num_devices N` spawns its ranks itself (data_parallel.run_ranks)
and joins torchrun's group when it runs under torchrun.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def under_torchrun() -> bool:
    """Whether torchrun's (or another env:// launcher's) variables are set."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group: `env://` when no init_method
    is given and torchrun's variables are set, else the explicit method,
    size and rank. backend: `nccl` when CUDA is there, else `gloo`."""
    if init_method is None:
        if not under_torchrun():
            raise ValueError("initialize: no init_method and no torchrun environment "
                             f"({', '.join(TORCHRUN_VARS)})")
        init_method = "env://"
    elif world_size is None or rank is None:
        raise ValueError("initialize: an explicit init_method needs world_size and rank")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {} if init_method == "env://" else {"world_size": world_size, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, **kw)


def world():
    """The group of every process (the counterpart of global_mesh)."""
    return dist.group.WORLD


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK, else the rank)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def shard_dataset(metadata_file: str, num_cols: int = 6, seed: int = 0, group=None,
                  use_native="auto"):
    """This rank's TripletDataset slice of `group` (the default group; no
    group and no default group: the whole set): every rank computes the
    same epoch permutation and takes its rank's stride, with no traffic
    (data/datagenerator.py epoch_order). use_native: TripletDataset's."""
    from feat3dnet_tpu_torch.data.datagenerator import TripletDataset

    alone = group is None and not dist.is_initialized()
    return TripletDataset(metadata_file, num_cols=num_cols, seed=seed,
                          shard_index=0 if alone else dist.get_rank(group),
                          num_shards=1 if alone else dist.get_world_size(group),
                          use_native=use_native)
