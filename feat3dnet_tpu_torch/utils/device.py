"""Where an entry point of the port runs.

Every entry point (InferencePipeline, ClusterDescriptorServer, Trainer, the
CLIs) runs on the card unless its caller names another device: the default
is `cuda`, and asking for `cuda` on a machine without a CUDA device raises
instead of quietly taking the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device`, or `cuda` when None; raises when CUDA is named but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return dev
