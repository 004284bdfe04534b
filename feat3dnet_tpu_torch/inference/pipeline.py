"""Two-pass keypoint extraction (port of feat3dnet_tpu/inference/pipeline.py).

Reference flow (inference.py:66-180): attention for every point of the
cloud, radius NMS, descriptors at the NMS keypoints, [xyz | descriptor]
rows out. The cloud is padded (with a validity mask) to a size bucket,
as in the JAX pipeline. Two routes compute the same keypoints:

* dense (`use_hashed_grouping=False`): the attention pass is the model's
  ball query (K2 on CUDA) + detector in chunks of `keypoint_chunk` points;
  NMS is the dense streamed max (ops/nms.nms_keypoints); descriptors come
  from the model forward at the keypoints;
* hashed (the default on CUDA): the cloud is Morton-sorted on its device
  (`build_sorted_cloud`); kernel K4 groups every point's ball, the
  detector runs on those clusters (chunked torch matmuls, or kernel K6
  under `use_fused_detector`), kernel
  K5 gives each point's ball max, a point survives iff its attention ties
  it, and `select_keypoints` picks the keypoints. Their descriptors reuse
  the attention pass's own neighbourhoods and orientations, with no second
  ball query: the model's descriptor tower, or kernel K3 under
  `use_fused_detector`.

The JAX pipeline's batched, pipelined and mesh-sharded entry points
(`extract_batch`, `extract_many`, `warmup`, the mesh paths) and its TPU
workarounds (packed uploads, F3D_* switches, executable caches) are not
part of this port yet.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, bucket_for
from feat3dnet_tpu_torch.data.io import load_point_cloud, save_descriptors
from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet, _group_normalized, _rotate_z
from feat3dnet_tpu_torch.ops import fused_describe as fd
from feat3dnet_tpu_torch.ops.hash_grid import (SortedCloud, ball_max_sorted,
                                               ball_query_grouped_sorted,
                                               build_sorted_cloud, estimate_ball_points)
from feat3dnet_tpu_torch.ops.nms import nms_keypoints, select_keypoints
from feat3dnet_tpu_torch.utils.convert import load_variables, variables_from_module
from feat3dnet_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class InferenceResult:
    keypoints: np.ndarray      # (K, 3)
    features: np.ndarray       # (K, D)
    attention: np.ndarray      # (K,)
    num_keypoints: int


class InferencePipeline:
    """Keypoints + descriptors for whole clouds with one model on one device.

    model: the port's Feat3DNet. variables: a flax-layout variable tree to
    load into it (e.g. utils.load_variables_npz), or None to keep the
    model's own weights. device: where the passes run, `cuda` unless the
    caller names another (raises without a CUDA device). `timings` holds
    the last extract's total seconds (`extract_s`) and, on the hashed
    route, the host seconds of the upload and Morton layout (`layout_s`;
    no synchronise, so on CUDA it is the time to queue them).
    """

    def __init__(self, model: Feat3DNet, variables: Optional[Dict[str, Any]],
                 model_cfg: ModelConfig, infer_cfg: InferenceConfig = InferenceConfig(),
                 device: Optional[torch.device] = None):
        if variables is not None:
            load_variables(model, variables)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mcfg = model_cfg
        self.icfg = infer_cfg
        self._weights: Dict[str, list] = {}
        self._detect_packed: Optional[tuple] = None     # K6's weight buffers
        self._describe_packed: Optional[tuple] = None   # K3's
        self.timings: Dict[str, float] = {}

    # -- configuration ------------------------------------------------------

    def _use_hashed(self) -> bool:
        flag = self.icfg.use_hashed_grouping
        if flag is None:
            return self.device.type == "cuda"
        return flag

    def _chunk_size(self, n_bucket: int) -> int:
        """Largest power of two <= keypoint_chunk that divides n_bucket."""
        c = 1
        while c * 2 <= min(self.icfg.keypoint_chunk, n_bucket) and n_bucket % (c * 2) == 0:
            c *= 2
        return c

    def _layout_for(self, xyz: np.ndarray) -> Tuple[int, int]:
        """Morton layout (block, tile): pinned by the config, or under
        hash_block=0 chosen by density (128-point blocks for clouds whose
        balls saturate, 256 otherwise). Outputs do not depend on it."""
        if self.icfg.hash_block:
            return self.icfg.hash_block, self.icfg.hash_tile
        est = estimate_ball_points(xyz, float(self.mcfg.base_scale))
        return (128 if est >= self.mcfg.num_samples else 256), self.icfg.hash_tile

    def _kernel_weights(self, kind: str) -> list:
        """Detector (unfolded BN, for K6) or whole-tower (folded BN, for K3)
        weights in the kernels' transposed layout, made once."""
        if kind not in self._weights:
            v = variables_from_module(self.model)
            w = (fd.transpose_unfolded_detector(fd.detector_weights_unfolded(v, self.mcfg))
                 if kind == "detect" else
                 fd.transpose_folded_weights(fd.folded_weights(v, self.mcfg)))
            self._weights[kind] = [t.to(self.device) for t in w]
        return self._weights[kind]

    # -- passes ---------------------------------------------------------------

    def _pad_to_bucket(self, cloud: np.ndarray, rng: Optional[np.random.RandomState]):
        """Optional permutation and truncation, then pad to the bucket with a
        validity mask. Returns (n, n_bucket, padded (1, nb, 3), valid)."""
        if rng is not None:
            cloud = cloud[rng.permutation(cloud.shape[0])]
        if self.icfg.num_points > 0:
            cloud = cloud[:self.icfg.num_points]
        n = cloud.shape[0]
        n_bucket = bucket_for(n)
        padded = np.zeros((1, n_bucket, 3), np.float32)
        padded[0, :n] = cloud[:, :3]
        valid = np.zeros((1, n_bucket), bool)
        valid[0, :n] = True
        return n, n_bucket, padded, valid

    def _chunked_attention(self, cloud: torch.Tensor, valid: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Attention and orientation at every point of a (1, nb, 3) cloud,
        `_chunk_size(nb)` points per pass (ball query + detector)."""
        nb = cloud.shape[1]
        chunk = self._chunk_size(nb)
        atts, oris = [], []
        for s in range(0, nb, chunk):
            grouped, _, _ = _group_normalized(cloud, cloud[:, s:s + chunk].contiguous(),
                                              self.mcfg.base_scale, self.mcfg.num_samples,
                                              valid)
            att, ori = self.model.detect_clusters(grouped)
            atts.append(att[0])
            oris.append(ori[0])
        return torch.cat(atts), torch.cat(oris)

    def _detect_sorted(self, grouped: torch.Tensor, centers: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Detector on the attention pass's (M, ns, 3) clusters: K6 under
        use_fused_detector, else the model's detector in chunks the same
        shape as the dense route's."""
        offs = grouped - centers[:, None, :]
        if self.icfg.use_fused_detector:
            w = self._kernel_weights("detect")
            if offs.is_cuda and self._detect_packed is None:
                self._detect_packed = fd._detect_kernel_weights(w, self.mcfg, offs.device,
                                                                unfolded=True)
            return fd.fused_detect_clusters(w, offs, self.mcfg, unfolded=True,
                                            packed=self._detect_packed)
        normalized = offs / self.mcfg.base_scale
        chunk = self._chunk_size(normalized.shape[0])
        atts, oris = [], []
        for s in range(0, normalized.shape[0], chunk):
            att, ori = self.model.detect_clusters(normalized[None, s:s + chunk])
            atts.append(att[0])
            oris.append(ori[0])
        return torch.cat(atts), torch.cat(oris)

    def _describe_at_keypoints(self, offs: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
        """(K, ns, 3) raw keypoint-cluster offsets + (K,) orientations ->
        (K, D) descriptors: K3 under use_fused_detector (it re-derives
        membership and orientation itself), else the model's descriptor
        tower on the rotated, normalised clusters."""
        if self.icfg.use_fused_detector:
            w = self._kernel_weights("describe")
            if offs.is_cuda and self._describe_packed is None:
                self._describe_packed = fd._describe_kernel_weights(w, self.mcfg, offs.device)
            feats, _ = fd.fused_describe_clusters_t(
                w, fd.pack_clusters_lanes_torch(offs), self.mcfg, packed=self._describe_packed)
            return feats
        normalized = offs[None] / self.mcfg.base_scale
        if self.mcfg.regress_orientation:
            normalized = _rotate_z(normalized, ori[None])
        return self.model.describe_clusters(normalized)[0]

    def _extract_dense(self, padded: np.ndarray, valid: np.ndarray):
        cloud = torch.from_numpy(padded).to(self.device)
        vmask = torch.from_numpy(valid).to(self.device)
        att, _ = self._chunked_attention(cloud, vmask)
        icfg = self.icfg
        kp, kp_att, num = nms_keypoints(cloud, att[None], icfg.nms_radius,
                                        icfg.max_keypoints, icfg.min_response_ratio,
                                        valid_mask=vmask)
        out = self.model(cloud, keypoints=kp, valid_mask=vmask)
        return kp[0], out.features[0], kp_att[0], num[0]

    def _extract_hashed(self, padded: np.ndarray, valid: np.ndarray, n: int):
        icfg, r, ns = self.icfg, float(self.mcfg.base_scale), self.mcfg.num_samples
        L, tc = self._layout_for(padded[0, :n])
        t0 = time.perf_counter()
        sc = build_sorted_cloud(torch.from_numpy(padded[0]).to(self.device),
                                torch.from_numpy(valid[0]).to(self.device),
                                cell_size=r, block_size=L)
        self.timings["layout_s"] = time.perf_counter() - t0
        pts4, blk_bbox, inv_perm = sc.pts4, sc.blk_bbox, sc.inv_perm.long()
        cloud = pts4[inv_perm, :3][None]           # original order, invalid at +1e9
        vmask = cloud[..., 0] < 5.0e8
        centers = pts4[:, :3]
        grouped, _, _ = ball_query_grouped_sorted(
            SortedCloud(pts4, blk_bbox, None, None, L), centers, r, ns, tile=tc)
        att_s, ori_s = self._detect_sorted(grouped, centers)
        # a point survives iff its attention ties its ball max; invalid points
        # sit at +1e9 and never enter a real ball
        ballmax = ball_max_sorted(pts4, blk_bbox, att_s, float(icfg.nms_radius))
        is_max = (att_s >= ballmax)[inv_perm]
        kp, kp_att, num, kp_idx = select_keypoints(
            cloud, att_s[inv_perm][None], is_max[None], icfg.max_keypoints,
            icfg.min_response_ratio, valid_mask=vmask, return_indices=True)
        # descriptors from the attention pass's neighbourhoods: inv_perm maps
        # an original index to its sorted row
        kp_s = inv_perm[kp_idx[0].long()]
        offs = grouped[kp_s] - centers[kp_s][:, None, :]
        feats = self._describe_at_keypoints(offs, ori_s[kp_s])
        return kp[0], feats, kp_att[0], num[0]

    # -- public API -------------------------------------------------------------

    @torch.no_grad()
    def extract(self, cloud: np.ndarray, keypoints: Optional[np.ndarray] = None,
                rng: Optional[np.random.RandomState] = None) -> InferenceResult:
        """Keypoints + descriptors of one (N, >=3) host cloud.

        keypoints: optional (K, 3) external keypoints (the reference's
        --use_keypoints_from); detection and NMS are skipped and the model
        runs at those points. rng: permute the points first (the
        reference's --randomize_points).
        """
        t0 = time.perf_counter()
        self.timings = {}
        n, _, padded, valid = self._pad_to_bucket(cloud, rng)
        if keypoints is None:
            if self._use_hashed():
                kp, feats, kp_att, num = self._extract_hashed(padded, valid, n)
            else:
                kp, feats, kp_att, num = self._extract_dense(padded, valid)
            num_kp = int(num)
        else:
            kp = torch.from_numpy(np.ascontiguousarray(keypoints[None, :, :3],
                                                       np.float32)).to(self.device)
            out = self.model(torch.from_numpy(padded).to(self.device), keypoints=kp,
                             valid_mask=torch.from_numpy(valid).to(self.device))
            kp, feats, kp_att = kp[0], out.features[0], out.end_points["attention"][0]
            num_kp = kp.shape[0]
        result = InferenceResult(keypoints=kp[:num_kp].cpu().numpy(),
                                 features=feats[:num_kp].cpu().numpy(),
                                 attention=kp_att[:num_kp].cpu().numpy(),
                                 num_keypoints=num_kp)
        self.timings["extract_s"] = time.perf_counter() - t0
        return result

    def process_directory(self, data_dir: str, output_dir: str, data_dim: int = 6,
                          keypoints_dir: Optional[str] = None, log=print,
                          batch_size: int = 1) -> int:
        """Extract for every .bin in data_dir and write [xyz | descriptor]
        .bin files of the same name (reference compute_descriptors,
        inference.py:66-180). batch_size > 1 (extract_batch) is not ported
        yet and raises."""
        if batch_size != 1:
            raise NotImplementedError("process_directory: batch_size > 1 needs "
                                      "extract_batch, which this port does not have yet")
        os.makedirs(output_dir, exist_ok=True)
        bins = sorted(f for f in os.listdir(data_dir) if f.endswith(".bin"))
        rng = np.random.RandomState(0) if self.icfg.randomize_points else None
        for i, fname in enumerate(bins):
            cloud = load_point_cloud(os.path.join(data_dir, fname), num_cols=data_dim)
            ext_kp = None
            if keypoints_dir is not None:
                ext_kp = load_point_cloud(
                    os.path.join(keypoints_dir, fname[:-4] + "_kp.bin"), num_cols=3)
            res = self.extract(cloud, keypoints=ext_kp, rng=rng)
            save_descriptors(os.path.join(output_dir, fname), res.keypoints, res.features)
            log(f"Processed {i + 1}/{len(bins)}: {fname} ({res.num_keypoints} keypoints)")
        return len(bins)
