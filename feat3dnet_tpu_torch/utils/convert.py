"""Weight bridge between the flax variable tree and the port's state_dict.

The flax tree (as `jax.tree.map(np.asarray, variables)` gives it, or as
utils/init.py makes it) is a nested dict:
  params/detection/conv{i}/conv2d/{kernel,bias}, .../bn/{scale,bias},
  params/detection/conv_post_{i}/..., attention/{kernel,bias},
  orientation/{kernel,bias}; params/description/conv{i}, conv_mid_0,
  conv_post_0; batch_stats/<same scopes>/bn/{mean,var}.
The port's module attribute names are those scopes, so each state_dict key
maps mechanically: `a.b.weight` <-> params/a/b/kernel (transposed from
flax's (Cin, Cout)), `bias`/`scale` <-> params, `mean`/`var` <->
batch_stats. Any missing or unused key raises.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, Any]:
    out: Dict[Path, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _flax_path(key: str) -> Tuple[Path, bool]:
    """state_dict key -> (flax path, transpose?)."""
    *scope, leaf = key.split(".")
    if leaf == "weight":
        return ("params", *scope, "kernel"), True
    if leaf in ("bias", "scale"):
        return ("params", *scope, leaf), False
    if leaf in ("mean", "var"):
        return ("batch_stats", *scope, leaf), False
    raise ValueError(f"no flax counterpart for state_dict key {key!r}")


def state_dict_from_variables(variables: Mapping, model: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """Flax variable tree -> `model`'s state_dict (float32 CPU tensors)."""
    flat = _flatten(variables)
    own = model.state_dict()
    expected = {}
    for key in own:
        path, transpose = _flax_path(key)
        expected[path] = (key, transpose)
    missing = sorted("/".join(p) for p in expected.keys() - flat.keys())
    unused = sorted("/".join(p) for p in flat.keys() - expected.keys())
    if missing or unused:
        raise KeyError(f"weight bridge: missing {missing}, unused {unused}")
    sd: Dict[str, torch.Tensor] = {}
    for path, (key, transpose) in expected.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"weight bridge: {'/'.join(path)} has shape "
                             f"{arr.shape}, {key} wants {tuple(own[key].shape)}")
        sd[key] = torch.from_numpy(np.array(arr, order="C"))      # a writable copy
    return sd


def load_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax variable tree into `model` (strict) and return it."""
    model.load_state_dict(state_dict_from_variables(variables, model), strict=True)
    return model


def variables_from_module(model: nn.Module) -> Dict[str, Any]:
    """The inverse bridge: `model`'s weights as a flax-layout nested dict of
    tensors (kernels (Cin, Cout)), e.g. for ops.fused_describe.folded_weights."""
    tree: Dict[str, Any] = {}
    for key, t in model.state_dict().items():
        path, transpose = _flax_path(key)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.detach().t() if transpose else t.detach()
    return tree
