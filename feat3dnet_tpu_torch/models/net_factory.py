"""Model registry (port of feat3dnet_tpu/models/net_factory.py)."""
from __future__ import annotations

from typing import Callable, Dict, Type

from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet

_REGISTRY: Dict[str, Type] = {"3DFeatNet": Feat3DNet}


def register_network(name: str) -> Callable[[Type], Type]:
    """Decorator registering a model class under `name`."""

    def deco(cls: Type) -> Type:
        _REGISTRY[name] = cls
        return cls

    return deco


def get_network(name: str) -> Type:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown network {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
