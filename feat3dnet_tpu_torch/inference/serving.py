"""Cluster-descriptor serving (port of feat3dnet_tpu/inference/serving.py).

`ClusterDescriptorServer` turns origin-centred clusters into descriptors
and attention. On CUDA, clusters of `num_samples` points from a BN model
go through kernel K3 (ops/fused_describe.py), in f32 or, with
`bf16_act=True`, with bf16 activations; everything else (CPU tensors,
other cluster sizes, models without BN) takes the model path, in f32.
Under a profiler each request shows the host's copy of its clusters to
the device as the span `f3d.serve.h2d#<request>` and, on K3's route, their
packing as `f3d.serve.pack#<request>` (utils/profiling.py).
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from feat3dnet_tpu_torch.inference.kernel_weights import KernelWeights
from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet
from feat3dnet_tpu_torch.ops.fused_describe import (fused_describe_clusters_t,
                                                    pack_clusters_lanes,
                                                    pack_clusters_lanes_torch)
from feat3dnet_tpu_torch.utils.device import resolve_device
from feat3dnet_tpu_torch.utils.profiling import span


class ClusterDescriptorServer:
    """Holds the model and its folded kernel weights (`kernel_weights`,
    checked against the model's tensors once a request) for repeated calls.

    device: where it serves, `cuda` unless the caller names another
    (raises without a CUDA device); the model is moved there.
    bf16_act: K3's products take bf16 operands and its activations are
    bf16 values (f32 sums, heads and normalisation), in `__call__` and
    `describe_packed`; the model path stays f32, as the JAX server's XLA
    path does. Descriptors stay within cosine 0.995 of f32 (chip_smoke
    phase 13 prints the card's figure)."""

    def __init__(self, model: Feat3DNet,
                 device: Optional[Union[str, torch.device]] = None,
                 bf16_act: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.bf16_act = bf16_act
        self.kernel_weights = KernelWeights(self.model, self.cfg, self.device)
        self._requests = itertools.count()        # the id of each call's spans

    def _k3(self, clusters_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K3 (its plain version off CUDA) on (P·8, B) packed clusters, on
        weights in this server's mode, remade if the model's tensors changed
        since the last request."""
        weights_t, packed = self.kernel_weights.refresh().describe(
            "bf16" if self.bf16_act else "f32")
        return fused_describe_clusters_t(weights_t, clusters_p, self.cfg,
                                         bf16_act=self.bf16_act, packed=packed)

    def _fused_ok(self, ns: int) -> bool:
        # the kernel folds eval BN into the weights: no-BN models take the
        # model path
        return ns == self.cfg.num_samples and self.cfg.use_bn

    def _kernel_route(self, clusters: torch.Tensor) -> bool:
        return clusters.device.type == "cuda" and self._fused_ok(clusters.shape[1])

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
        rid = next(self._requests)
        with span("f3d.serve.h2d", rid):
            clusters = torch.as_tensor(clusters, dtype=torch.float32, device=self.device)
        if self._kernel_route(clusters):
            with span("f3d.serve.pack", rid):
                clusters_p = pack_clusters_lanes_torch(clusters)
            return self._k3(clusters_p)
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
        return self._k3(packed.contiguous())
