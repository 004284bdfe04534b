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

`save_variables_npz` / `load_variables_npz` keep such a tree in a flat npz
keyed by `/`-joined paths (`params/detection/conv0/conv2d/kernel`, ...),
which is how a trained checkpoint reaches a machine without JAX or Orbax.

The Adam bridge: optax's Adam state as a tree {"mu": <params tree>, "nu":
<params tree>, "count": int} (the count is global: optax keeps one for
all parameters, and the cosine schedule's count equals it), each moment
laid out as its parameter (kernels (Cin, Cout)). `adam_state_from_optax`
loads it into a torch Adam, whose per-parameter `step` is the count;
`adam_state_to_optax` is the inverse. A train-state npz
(`save_train_state_npz`) adds `opt_state/mu/<param path>`,
`opt_state/nu/<param path>`, `opt_state/count` and `step` to the variables'
keys (scripts/export_jax_train_state.py writes one from an Orbax run);
`load_variables_npz` reads only its variables, `load_train_state_npz` its
Adam state.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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


def _flat_npz_arrays(tree: Mapping, prefix: Path = ()) -> Dict[str, np.ndarray]:
    return {"/".join(prefix + p): np.asarray(v, dtype=np.float32)
            for p, v in _flatten(tree).items()}


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        node = tree
        for p in scope:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v, dtype=np.float32)
    return tree


def save_variables_npz(path: str, variables: Mapping) -> None:
    """Write a variable tree as a flat float32 npz keyed by `a/b/c` paths."""
    np.savez(path, **_flat_npz_arrays(variables))


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"variables file not found: {path}")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_variables_npz(path: str) -> Dict[str, Any]:
    """Read a `save_variables_npz` file (or the variables of a
    `save_train_state_npz` file) back into a nested dict of float32 numpy
    arrays."""
    return _unflatten({k: v for k, v in _read_npz(path).items()
                       if k.split("/")[0] in ("params", "batch_stats")})


def save_train_state_npz(path: str, variables: Mapping, adam: Mapping, step: int) -> None:
    """`save_variables_npz` plus an optax-layout Adam state (`adam`: mu, nu,
    count) and the train step."""
    np.savez(path, **_flat_npz_arrays(variables),
             **_flat_npz_arrays(adam["mu"], ("opt_state", "mu")),
             **_flat_npz_arrays(adam["nu"], ("opt_state", "nu")),
             **{"opt_state/count": np.int64(adam["count"]), "step": np.int64(step)})


def load_train_state_npz(path: str) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """(optax-layout Adam state {"mu", "nu", "count"}, train step) of a
    `save_train_state_npz` file; (None, None) for a variables-only npz."""
    data = _read_npz(path)
    if "opt_state/count" not in data:
        return None, None
    opt = _unflatten({k[len("opt_state/"):]: v for k, v in data.items()
                      if k.startswith(("opt_state/mu/", "opt_state/nu/"))})
    return ({"mu": opt["mu"], "nu": opt["nu"], "count": int(data["opt_state/count"])},
            int(data["step"]))


def _adam_params(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(parameter, its path in the params tree, transpose?) in the optimiser's
    order."""
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            path, transpose = _flax_path(names[id(p)])
            yield p, path[1:], transpose


def _step_tensor(count: int) -> torch.Tensor:
    # torch's Adam keeps `step` as a float32 CPU scalar tensor
    return torch.tensor(float(count), dtype=torch.float32)


def adam_state_from_optax(tree: Mapping, model: nn.Module,
                          optimizer: torch.optim.Optimizer) -> int:
    """Load an optax-layout Adam state into `optimizer` (a torch Adam over
    parameters of `model`; under freeze_scopes only the trained ones, as
    optax's masked state holds): moments transposed as their parameters,
    every `step` the count. The tree must hold exactly the optimiser's
    parameters. Returns the count."""
    mu, nu = _flatten(tree["mu"]), _flatten(tree["nu"])
    count = int(tree["count"])
    state, expected = {}, set()
    for i, (p, path, transpose) in enumerate(_adam_params(model, optimizer)):
        expected.add(path)
        if path not in mu or path not in nu:
            raise KeyError(f"Adam bridge: no moments for {'/'.join(path)}")
        m, v = (np.asarray(t[path], dtype=np.float32) for t in (mu, nu))
        m, v = (m.T, v.T) if transpose else (m, v)
        if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
            raise ValueError(f"Adam bridge: {'/'.join(path)} has shape {m.shape}, "
                             f"the parameter {tuple(p.shape)}")
        state[i] = {"step": _step_tensor(count),
                    "exp_avg": torch.from_numpy(np.array(m, order="C")),
                    "exp_avg_sq": torch.from_numpy(np.array(v, order="C"))}
    unused = sorted("/".join(p) for p in (mu.keys() | nu.keys()) - expected)
    if unused:
        raise KeyError(f"Adam bridge: moments of parameters the optimiser lacks: {unused}")
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)
    return count


def adam_state_to_optax(model: nn.Module, optimizer: torch.optim.Optimizer,
                        count: int) -> Dict[str, Any]:
    """The inverse of adam_state_from_optax: {"mu", "nu", "count"} as float32
    numpy trees (zeros for a parameter the optimiser holds no state for)."""
    adam: Dict[str, Any] = {"mu": {}, "nu": {}, "count": int(count)}
    for p, path, transpose in _adam_params(model, optimizer):
        st = optimizer.state.get(p) or {}
        for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            t = st[slot].detach().cpu() if slot in st else torch.zeros(p.shape)
            node = adam[key]
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = (t.t() if transpose else t).numpy().astype(np.float32)
    return adam


def zero_adam_moments(model: nn.Module, optimizer: torch.optim.Optimizer, count: int,
                      scopes: Sequence[str] = ()) -> None:
    """Optax's state after a restore, for each of `optimizer`'s parameters
    under a top-level scope in `scopes` or without state: zero moments at the
    global count (torch's Adam would otherwise start their `step` at 0, and
    their first update would be lr * sign(g) where optax's is m^/sqrt(v^))."""
    for p, path, _ in _adam_params(model, optimizer):
        if path[0] in scopes or not optimizer.state.get(p):
            optimizer.state[p] = {"step": _step_tensor(count),
                                  "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": torch.zeros_like(p)}
