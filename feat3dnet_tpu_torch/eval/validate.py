"""FPR@95%-recall validation over cluster pairs (port of feat3dnet_tpu/eval/validate.py).

Reference: train.py:260-315 loads {i}_0.bin / {i}_1.bin cluster pairs
(labels in clusters/filenames.txt, last column 0/1), packs 512 clusters
into one cloud with 100 m x-offsets, feeds the offsets as keypoints and
measures descriptor distances. Here, as in the JAX package, the clusters
are a batch (B, P, 3) with validity masks, each with one keypoint at its
origin: one eval forward of the model (kernel K2 at B 512, M 1 on CUDA)
gives every descriptor.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.data.io import load_point_cloud
from feat3dnet_tpu_torch.eval.metrics import fpr_at_95_recall
from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet
from feat3dnet_tpu_torch.utils.device import resolve_device


def load_validation_groundtruths(fname: str, proportion: float = 1.0) -> List[Tuple[int, int]]:
    """Parse clusters/filenames.txt: one header line, then rows whose last
    whitespace token is the 0/1 same-place label (train.py:244-257)."""
    gts = []
    with open(fname) as f:
        f.readline()
        for i, line in enumerate(f):
            if line.strip():
                gts.append((i, int(line.split()[-1])))
    if 0 < proportion < 1:
        gts = gts[::int(1.0 / proportion)]
    return gts


class ClusterPairValidator:
    """Batched descriptor-distance FPR@95 of the model's current weights.

    device: where the forward runs, `cuda` unless the caller names another
    (raises without a CUDA device); the model must already be there.
    """

    def __init__(self, model: Feat3DNet, model_cfg: ModelConfig,
                 cluster_folder: str, data_dim: int = 6,
                 batch: int = 512, max_cluster_points: int = 1024,
                 proportion: float = 1.0, device: Optional[torch.device] = None):
        self.model = model
        self.cfg = model_cfg
        self.folder = cluster_folder
        self.data_dim = data_dim
        self.batch = batch
        self.max_points = max_cluster_points
        self.device = resolve_device(device)
        self.groundtruths = load_validation_groundtruths(
            os.path.join(cluster_folder, "filenames.txt"), proportion)

    def _load_batch(self, indices: Sequence[int], suffix: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        clouds = np.zeros((self.batch, self.max_points, 3), np.float32)
        valid = np.zeros((self.batch, self.max_points), bool)
        for j, idx in enumerate(indices):
            c = load_point_cloud(
                os.path.join(self.folder, f"{idx}_{suffix}.bin"), self.data_dim)
            n = min(c.shape[0], self.max_points)
            clouds[j, :n] = c[:n, :3]
            valid[j, :n] = True
        return clouds, valid

    @torch.no_grad()
    def _describe(self, clouds: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """(B, D) descriptors at each cluster's origin."""
        x = torch.from_numpy(clouds).to(self.device)
        keypoints = torch.zeros((x.shape[0], 1, 3), dtype=torch.float32, device=self.device)
        out = self.model(x, training=False, keypoints=keypoints,
                         valid_mask=torch.from_numpy(valid).to(self.device))
        return out.features[:, 0, :].cpu().numpy()

    def __call__(self) -> float:
        """FPR at 95 % recall over all cluster pairs (1.0 without both labels)."""
        positive, negative = [], []
        gts = self.groundtruths
        for start in range(0, len(gts), self.batch):
            chunk = gts[start:start + self.batch]
            ids = [g[0] for g in chunk]
            f0 = self._describe(*self._load_batch(ids, 0))
            f1 = self._describe(*self._load_batch(ids, 1))
            d = np.linalg.norm(f0 - f1, axis=1)[:len(chunk)]
            for (_, label), dist in zip(chunk, d):
                (positive if label == 1 else negative).append(dist)
        if not positive or not negative:
            return 1.0
        return fpr_at_95_recall(np.array(positive), np.array(negative))
