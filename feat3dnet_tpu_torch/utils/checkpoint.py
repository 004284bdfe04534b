"""Training checkpoints of the port (counterpart of feat3dnet_tpu/utils/checkpoint.py).

A checkpoint is one `ckpt_<step>.pt` file (torch.save of tensors, ints and
strings only, read back with weights_only=True) holding the step, the
schedule count, the flax-layout variable tree (utils/convert.py), the Adam
state and the names of the parameters it is keyed by. Retention keeps the
newest `max_to_keep`. `restore_exclude`: the named top-level scopes keep
their init params and BN buffers (the two-stage recipe restores stage 1
without 'detection'); their Adam moments, and those of any parameter the
checkpoint holds no state for, restart from zero at the checkpoint's
count, as optax's do (its count is global). Orbax checkpoints of the JAX
package reach the port through the npz bridge (`--variables`).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Sequence

import torch

from feat3dnet_tpu_torch.utils.convert import (load_variables, variables_from_module,
                                               zero_adam_moments)

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _cpu_variables(model) -> Dict[str, Any]:
    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    return walk(variables_from_module(model))


def _param_names(state) -> List[str]:
    """The optimiser's parameters by name, in its own order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step: Optional[int] = None) -> None:
        step = state.step if step is None else step
        payload: Dict[str, Any] = {
            "step": int(state.step), "count": int(state.count),
            "variables": _cpu_variables(state.model),
            "optimizer": state.optimizer.state_dict(),
            "param_names": _param_names(state)}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            os.remove(self._path(old))

    def restore(self, init_state, step: Optional[int] = None,
                restore_exclude: Optional[Sequence[str]] = None):
        """Restore into `init_state` (its model and optimiser, in place) and
        return it; excluded scopes keep init_state's weights and BN buffers,
        and their Adam moments start from zero at the restored count."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ckpt = torch.load(self._path(step), map_location="cpu", weights_only=True)
        excluded = set(restore_exclude or ())
        variables = ckpt["variables"]
        if excluded:
            init = _cpu_variables(init_state.model)
            variables = {col: {scope: (init[col][scope] if scope in excluded else tree)
                               for scope, tree in trees.items()}
                         for col, trees in variables.items()}
        load_variables(init_state.model, variables)
        names = _param_names(init_state)
        if names != ckpt["param_names"]:
            raise ValueError("checkpoint: the optimiser's parameters differ "
                             f"({len(ckpt['param_names'])} saved, {len(names)} now)")
        init_state.optimizer.load_state_dict(ckpt["optimizer"])
        zero_adam_moments(init_state.model, init_state.optimizer, ckpt["count"], excluded)
        init_state.step = ckpt["step"]
        init_state.count = ckpt["count"]
        return init_state
