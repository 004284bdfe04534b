"""The weights kernels K6 and K3 take, derived from a Feat3DNet's tensors:
one owner, and one rule for when they are made anew (`weights_key` over
the model's parameters and buffers, read by `refresh` once per unit of
work: an extraction unit, a server request)."""
from __future__ import annotations

import torch

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.models.layers import weights_key
from feat3dnet_tpu_torch.ops import fused_describe as fd
from feat3dnet_tpu_torch.utils.convert import variables_from_module


class KernelWeights:
    """K6's and K3's weights of `model` on `device`, each `(weights_t,
    packed)`: the kernels' transposed layout and, on CUDA, the kernel's
    packed buffers (packing reads host tables: a sync, paid when they are
    made); packed is None off CUDA, where the plain versions run."""

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig, device: torch.device):
        self.model, self.cfg, self.device = model, cfg, device
        # the tensors the weights come from (a load copies into them), listed
        # once: walking the modules for them costs ~10x reading their key
        self._tensors = list(model.parameters()) + list(model.buffers())
        self._key, self._made = None, {}    # the key of what _made holds; kind -> tuple

    def refresh(self) -> "KernelWeights":
        """Drop what was made from tensors that have changed since."""
        key = weights_key(self._tensors)
        if key != self._key:
            self._key, self._made = key, {}
        return self

    def detect(self) -> tuple:
        """K6's: the detector with eval BN unfolded (the model's rounding)."""
        return self._get("detect")

    def describe(self, mode: str = "f32") -> tuple:
        """K3's for `mode` ('f32' or 'bf16'): the tower with eval BN folded."""
        return self._get(mode)

    def _get(self, kind: str) -> tuple:
        if self._key is None:
            self.refresh()
        if kind not in self._made:
            v, cfg, dev = variables_from_module(self.model), self.cfg, self.device
            if kind == "detect":
                w = fd.transpose_unfolded_detector(fd.detector_weights_unfolded(v, cfg))
            else:
                w = fd.transpose_folded_weights(fd.folded_weights(v, cfg))
            w, packed = [t.to(dev) for t in w], None
            if dev.type == "cuda":
                packed = (fd._detect_kernel_weights(w, cfg, dev, unfolded=True)
                          if kind == "detect" else fd._describe_kernel_weights(w, cfg, dev, kind))
            self._made[kind] = (w, packed)
        return self._made[kind]
