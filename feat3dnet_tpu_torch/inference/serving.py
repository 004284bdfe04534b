"""Cluster-descriptor serving (port of feat3dnet_tpu/inference/serving.py).

`ClusterDescriptorServer` turns origin-centred clusters into descriptors
and attention. On CUDA, clusters of `num_samples` points from a BN model
go through kernel K3 (ops/fused_describe.py); everything else (CPU
tensors, other cluster sizes, models without BN) takes the model path.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet
from feat3dnet_tpu_torch.ops.fused_describe import (folded_weights,
                                                    fused_describe_clusters_t,
                                                    pack_clusters_lanes,
                                                    pack_clusters_lanes_torch,
                                                    transpose_folded_weights)
from feat3dnet_tpu_torch.utils.convert import variables_from_module


class ClusterDescriptorServer:
    """Holds the model and its folded kernel weights for repeated calls."""

    def __init__(self, model: Feat3DNet):
        self.model = model.eval()
        self.cfg = model.cfg
        self._weights_t: Optional[List[torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _kernel_weights_t(self) -> List[torch.Tensor]:
        if self._weights_t is None:
            variables = variables_from_module(self.model)
            self._weights_t = [w.to(self.device) for w in transpose_folded_weights(
                folded_weights(variables, self.cfg))]
        return self._weights_t

    def _fused_ok(self, ns: int) -> bool:
        # the kernel folds eval BN into the weights: no-BN models take the
        # model path
        return ns == self.cfg.num_samples and self.cfg.use_bn

    @torch.no_grad()
    def _model_path(self, clusters: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        keypoints = torch.zeros((clusters.shape[0], 1, 3), dtype=torch.float32,
                                device=clusters.device)
        out = self.model(clusters, training=False, keypoints=keypoints)
        return out.features[:, 0, :], out.end_points["attention"][:, 0]

    @torch.no_grad()
    def __call__(self, clusters: Union[np.ndarray, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, P, 3) origin-centred clusters -> (descriptors (B, D), attention (B,))."""
        clusters = torch.as_tensor(clusters, dtype=torch.float32, device=self.device)
        if clusters.device.type == "cuda" and self._fused_ok(clusters.shape[1]):
            return fused_describe_clusters_t(
                self._kernel_weights_t(), pack_clusters_lanes_torch(clusters), self.cfg)
        return self._model_path(clusters)

    @staticmethod
    def pack_clusters(clusters) -> np.ndarray:
        """Host packer: (B, P, 3) float32 numpy -> (P·8, B)."""
        return pack_clusters_lanes(np.asarray(clusters, np.float32))

    @torch.no_grad()
    def describe_packed(self, packed: Union[np.ndarray, torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(P·8, B) packed clusters (see pack_clusters) -> (descriptors (B, D),
        attention (B,)) through fused_describe_clusters_t: K3 when the model
        lives on CUDA, its plain version on CPU. Raises when the contract
        (P == num_samples, BN model) does not hold instead of degrading."""
        packed = torch.as_tensor(packed, dtype=torch.float32, device=self.device)
        if packed.dim() != 2 or packed.shape[0] % 8 or not self._fused_ok(packed.shape[0] // 8):
            raise ValueError(
                f"describe_packed: want (num_samples*8, B) = ({8 * self.cfg.num_samples}, B) "
                f"and a BN model, got {tuple(packed.shape)}, use_bn={self.cfg.use_bn}")
        return fused_describe_clusters_t(self._kernel_weights_t(), packed.contiguous(),
                                         self.cfg)
