"""What the entries share: the run's context and the port's model built from
a configuration file and the benchmark's own weights."""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from portbench.reference import model as M

DATA_DIR = os.path.join("examples", "data")


@dataclasses.dataclass
class Context:
    """root: the checkout; cfg / wl: the configuration and workload files;
    seed: the run's; device: where the program and the reference run;
    overrides: configuration keys replaced (the control, the tests)."""

    root: str
    cfg: Dict[str, Any]
    wl: Dict[str, Any]
    seed: int
    device: torch.device
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def data_root(self) -> str:
        return os.path.join(self.root, DATA_DIR)

    def section(self, name: str) -> Dict[str, Any]:
        """The workload file's section `name` under the overrides."""
        return {**self.wl[name], **self.overrides.get(name, {})}

    def model_cfg(self) -> Dict[str, Any]:
        """The configuration's model section under the overrides."""
        return {**self.cfg["model"], **self.overrides.get("model", {})}


def port_model_config(mcfg: Dict[str, Any], **extra):
    """The port's ModelConfig for a configuration's model section; raises if
    a width it derives differs from the file's."""
    from feat3dnet_tpu_torch.config import ModelConfig

    mc = ModelConfig(num_clusters=mcfg["num_clusters"], base_scale=mcfg["base_scale"],
                     num_samples=mcfg["num_samples"], feature_dim=mcfg["feature_dim"],
                     attention=mcfg["attention"],
                     regress_orientation=mcfg["regress_orientation"],
                     margin=mcfg["margin"], bn_epsilon=mcfg["bn_epsilon"],
                     detector_mlp=tuple(mcfg["detector_mlp"]),
                     detector_mlp2=tuple(mcfg["detector_mlp2"]),
                     descriptor_mlp=tuple(mcfg["descriptor_mlp"]), **extra)
    if (list(mc.descriptor_mlp2) != list(mcfg["descriptor_mlp2"])
            or list(mc.descriptor_mlp3) != list(mcfg["descriptor_mlp3"])):
        raise ValueError("the port derives other descriptor widths than the configuration")
    return mc


def port_model(mc, weights: M.Weights, device: torch.device):
    """The port's Feat3DNet on `device` holding `weights` (the benchmark's)."""
    from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet

    model = Feat3DNet(mc).to(device)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True)
    return model


def weights(ctx: Context) -> M.Weights:
    """The configuration's weights: its `weights` file, or made from the seed."""
    mcfg = ctx.model_cfg()
    if ctx.cfg.get("weights"):
        return M.weights_from_npz(os.path.join(ctx.root, ctx.cfg["weights"]), mcfg, ctx.device)
    return M.make_weights(mcfg, ctx.seed, ctx.device)
