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
  (`build_sorted_cloud_batch`); kernel K4 groups every point's ball, the
  detector runs on those clusters (chunked torch matmuls, or kernel K6
  under `use_fused_detector`), kernel
  K5 gives each point's ball max, a point survives iff its attention ties
  it, and `select_keypoints` picks the keypoints. Their descriptors reuse
  the attention pass's own neighbourhoods and orientations, with no second
  ball query: the model's descriptor tower, or kernel K3 under
  `use_fused_detector`, on weights from `kernel_weights`
  (kernel_weights.py), checked against the model's tensors once a unit.

Throughput entry points (the JAX pipeline's): `extract_batch` runs B
clouds of one bucket through the hashed route at once, as a union built
in one Morton layout (`build_sorted_cloud_batch`) that K4 and K5 take
with `segment=` the bucket, so each cloud's results equal `extract` bit
for bit; `extract_many` streams clouds (or batches of them) with the
host's padding and upload in threads and up to `depth` units queued on
the card before the first is read back; `warmup` builds the kernels and
pays the first calls at start-up. A unit is queued without a host sync
(`_enqueue`: pinned uploads, every device op, the outputs copied into
pinned host buffers behind a CUDA event) and read back by `_finish`.
Under a profiler each unit's stages show as spans (utils/profiling.py):
`f3d.extract.prep#<unit>` (in the prep thread), `f3d.extract.wait_prep`,
`f3d.extract.enqueue#<unit>` around `f3d.extract.layout`, `.group`,
`.detect`, `.ballmax`, `.select`, `.describe` and `.to_host`, then
`f3d.extract.finish#<unit>` (the wait for the read-back and the cut);
`f3d.extract.many` spans a whole `extract_many` call.
Meshes (the JAX pipeline's two modes; a mesh is a tuple of devices,
parallel/mesh.py, and each distinct device gets its own copy of the model
and its own kernel weights at first use):
* `mesh=`: one cloud sharded over the devices (latency), by the stages
  of one device. On the hashed route the layout is built on the first
  device and copied to each; K4, the detector (or K6) and K5 run per
  shard of the sorted centres, the selection on the first device; each
  keypoint's cluster and orientation come from the shard that holds it;
  K3 runs per device on K / d keypoints (the descriptor tower on the
  first device). The dense route runs each device's rows of the
  attention pass (NMS and descriptors on the first device). JAX's rules
  hold: 128-aligned centre shards, max_keypoints split evenly.
  `extract_batch` and `extract_many` are loops of `extract`.
* `cloud_mesh=`: a sub-batch of clouds per device (throughput).
  `extract_batch` pads the clouds to a multiple of the mesh with replicas
  of the last one, queues one `_enqueue` unit per device and drops the
  replicas' results; `extract_many` deals its units round-robin over the
  devices, `depth` queued on each.
Each cloud's results on either mesh equal `extract` bit for bit: a shard
keeps the single-device shapes (whole detector chunks on the default
route; K4, K5, K6 and K3 compute each centre or cluster alone).
The JAX pipeline's TPU workarounds (packed uploads, F3D_* switches,
executable caches) are not part of this port.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, bucket_for
from feat3dnet_tpu_torch.data.io import load_point_cloud, save_descriptors
from feat3dnet_tpu_torch.inference.kernel_weights import KernelWeights
from feat3dnet_tpu_torch.inference.stream import run_units
from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet, _group_normalized, _rotate_z
from feat3dnet_tpu_torch.ops import fused_describe as fd
from feat3dnet_tpu_torch.ops.hash_grid import (SortedCloud, ball_max_sorted,
                                               ball_query_grouped_sorted,
                                               build_sorted_cloud_batch, estimate_ball_points)
from feat3dnet_tpu_torch.ops.nms import nms_keypoints, select_keypoints
from feat3dnet_tpu_torch.parallel.mesh import as_mesh, chunk_shards, on_device, replicas
from feat3dnet_tpu_torch.utils.convert import load_variables
from feat3dnet_tpu_torch.utils.device import resolve_device
from feat3dnet_tpu_torch.utils.profiling import span, spanned

# the id of each unit of extraction, shared by its spans on every thread;
# process-wide, so that the units of a cloud mesh's per-device pipelines never share one
_UNIT_IDS = itertools.count()


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
    caller names another (raises without a CUDA device). mesh /
    cloud_mesh: a sequence of devices (see the module's docstring), at
    most one of them; the pipeline's device is then the mesh's first.
    `kernel_weights`: K6's and K3's weights of the model on that device.
    """

    def __init__(self, model: Feat3DNet, variables: Optional[Dict[str, Any]],
                 model_cfg: ModelConfig, infer_cfg: InferenceConfig = InferenceConfig(),
                 device: Optional[torch.device] = None, mesh=None, cloud_mesh=None):
        if mesh is not None and cloud_mesh is not None:
            raise ValueError("pass either mesh (one cloud sharded over devices) or "
                             "cloud_mesh (a sub-batch of clouds per device), not both")
        if variables is not None:
            load_variables(model, variables)
        self.mesh = None if mesh is None else as_mesh(mesh)
        self.cloud_mesh = None if cloud_mesh is None else as_mesh(cloud_mesh)
        devices = self.mesh or self.cloud_mesh
        for d in devices or ():
            resolve_device(d)
        self.device = resolve_device(device if devices is None else devices[0])
        if device is not None and devices is not None \
                and as_mesh([device])[0] != devices[0]:
            raise ValueError(f"device {device} is not the mesh's first device {devices[0]}")
        self.model = model.to(self.device).eval()
        self.mcfg = model_cfg
        self.icfg = infer_cfg
        self.kernel_weights = KernelWeights(self.model, model_cfg, self.device)
        self._pipes: Optional[Dict[torch.device, "InferencePipeline"]] = None

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

    def _shards(self, n: int, unit: Optional[int] = None
                ) -> Optional[List[Tuple[torch.device, int, int]]]:
        """On `mesh` (None off one), each device's rows (device, start, end)
        of n, cut on multiples of `unit` (`chunk_shards`; devices without
        rows dropped). unit None: the hashed route's n sorted centres, n / d
        a device on the fused route, whole detector chunks on the default
        one. Raises unless they split as JAX's rules ask."""
        if self.mesh is None:
            return None
        n_dev, k_max = len(self.mesh), self.icfg.max_keypoints
        if unit is None:
            if n % n_dev or n // n_dev % 128 or k_max % n_dev:
                raise ValueError(f"bucket {n} must shard into 128-aligned centre tiles and "
                                 f"max_keypoints {k_max} divide across {n_dev} devices")
            unit = n // n_dev if self.icfg.use_fused_detector else self._chunk_size(n)
        elif n % n_dev:
            raise ValueError(f"{n} points do not split over {n_dev} devices")
        return [(d, s0, s1) for d, (s0, s1) in zip(self.mesh, chunk_shards(n, unit, n_dev))
                if s1 > s0]

    def _ready(self) -> None:
        """Once a unit: check the kernel weights against the model's tensors
        and, on the fused route, make K6's and K3's (after a load: a sync)."""
        self.kernel_weights.refresh()
        if self.icfg.use_fused_detector:
            self.kernel_weights.detect()
            self.kernel_weights.describe()

    def _device_pipes(self) -> Dict[torch.device, "InferencePipeline"]:
        """One pipeline per distinct device of the mesh: this one on its
        own device, one over a copy of the model on each other device."""
        mesh = self.mesh or self.cloud_mesh
        if self._pipes is None:
            self._pipes = {self.device: self} if mesh is None else {
                dev: self if m is self.model else InferencePipeline(
                    m, None, self.mcfg, self.icfg, device=dev)
                for dev, m in replicas(self.model, mesh).items()}
        return self._pipes

    # -- passes ---------------------------------------------------------------

    def _prep(self, clouds) -> "_Prepped":
        """Host prep of one unit of clouds (already permuted): truncation to
        num_points, one shared bucket (the largest; each cloud's own is
        kept for its detector chunks) and, on the hashed
        route, layout (the smallest `_layout_for`), padding with a validity
        mask into host buffers (pinned on the card, so the upload is
        asynchronous) and their upload, queued without waiting. Safe in a
        worker thread; the unit takes its id here."""
        uid = next(_UNIT_IDS)
        with span("f3d.extract.prep", uid):
            if self.icfg.num_points > 0:
                clouds = [c[:self.icfg.num_points] for c in clouds]
            buckets = tuple(bucket_for(c.shape[0]) for c in clouds)
            nb = max(buckets)
            layout = None
            if self._use_hashed():
                if nb >= (1 << 24):
                    raise ValueError(f"extract: keys ride f32, exact only below 2^24 points per "
                                     f"cloud; bucket {nb}")
                layout = min(self._layout_for(c[:, :3]) for c in clouds)
            pin = self.device.type == "cuda"
            xyz = torch.zeros((len(clouds), nb, 3), pin_memory=pin)
            valid = torch.zeros((len(clouds), nb), dtype=torch.bool, pin_memory=pin)
            for i, c in enumerate(clouds):
                xyz.numpy()[i, :c.shape[0]] = c[:, :3]
                valid[i, :c.shape[0]] = True
            return _Prepped(xyz.to(self.device, non_blocking=True),
                            valid.to(self.device, non_blocking=True), layout, buckets,
                            uid)

    def _chunked_attention(self, cloud: torch.Tensor, valid: torch.Tensor, shards=None,
                           chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Attention and orientation at every point of a (1, nb, 3) cloud,
        `chunk` points per pass (ball query + detector; default
        `_chunk_size(nb)`); shards (`_shards`): each device's rows against
        its copy of the cloud, gathered here (None: every row here)."""
        nb = cloud.shape[1]
        chunk = chunk or self._chunk_size(nb)
        atts, oris = [], []
        for dev, s0, s1 in shards or [(None, 0, nb)]:
            model, cl, vm = ((self.model, cloud, valid) if dev is None else
                             (self._device_pipes()[dev].model, cloud.to(dev), valid.to(dev)))
            with on_device(dev):
                for s in range(s0, s1, chunk):
                    grouped, _, _ = _group_normalized(cl, cl[:, s:s + chunk].contiguous(),
                                                      self.mcfg.base_scale,
                                                      self.mcfg.num_samples, vm)
                    att, ori = model.detect_clusters(grouped)
                    atts.append(att[0] if dev is None else att[0].to(self.device))
                    oris.append(ori[0] if dev is None else ori[0].to(self.device))
        return torch.cat(atts), torch.cat(oris)

    def _detect_sorted(self, grouped: torch.Tensor, centers: torch.Tensor,
                       buckets: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Detector on the attention pass's (M, ns, 3) clusters, M / B of
        them per cloud, whose own buckets are `buckets`: K6 under
        use_fused_detector (one launch over every cloud's clusters), else
        the model's detector over each cloud's rows in chunks of
        `_chunk_size` of its own bucket, the same shapes as the cloud's
        own run and as the dense route's."""
        offs = grouped - centers[:, None, :]
        if self.icfg.use_fused_detector:
            weights_t, packed = self.kernel_weights.detect()
            return fd.fused_detect_clusters(weights_t, offs, self.mcfg, unfolded=True,
                                            packed=packed)
        normalized = offs / self.mcfg.base_scale
        rows = normalized.shape[0] // len(buckets)
        atts, oris = [], []
        for i, nb in enumerate(buckets):
            chunk = self._chunk_size(nb)
            for s in range(i * rows, (i + 1) * rows, chunk):
                att, ori = self.model.detect_clusters(normalized[None, s:s + chunk])
                atts.append(att[0])
                oris.append(ori[0])
        return torch.cat(atts), torch.cat(oris)

    def _describe_at_keypoints(self, offs: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
        """(B, K, ns, 3) raw keypoint-cluster offsets + (B, K) orientations
        -> (B, K, D) descriptors: K3 under use_fused_detector, one launch
        over every cloud's keypoints (it re-derives membership and
        orientation itself), else the model's descriptor tower on each
        cloud's rotated, normalised clusters, one call per cloud."""
        b, k = offs.shape[:2]
        if self.icfg.use_fused_detector:
            weights_t, packed = self.kernel_weights.describe()
            feats, _ = fd.fused_describe_clusters_t(
                weights_t, fd.pack_clusters_lanes_torch(offs.reshape(b * k, *offs.shape[2:])),
                self.mcfg, packed=packed)
            return feats.reshape(b, k, -1)
        feats = []
        for i in range(b):
            normalized = offs[i:i + 1] / self.mcfg.base_scale
            if self.mcfg.regress_orientation:
                normalized = _rotate_z(normalized, ori[i:i + 1])
            feats.append(self.model.describe_clusters(normalized))
        return torch.cat(feats)

    def _extract_dense(self, cloud: torch.Tensor, vmask: torch.Tensor):
        att, _ = self.attention(cloud, vmask)
        icfg = self.icfg
        kp, kp_att, num = nms_keypoints(cloud, att[None], icfg.nms_radius,
                                        icfg.max_keypoints, icfg.min_response_ratio,
                                        valid_mask=vmask)
        out = self.model(cloud, keypoints=kp, valid_mask=vmask)
        return kp, out.features, kp_att, num

    def _extract_hashed(self, prep: "_Prepped", shards=None):
        """The hashed route on a prepped unit of B clouds padded to one
        bucket -> (kp (B, K, 3), features (B, K, D), kp_att (B, K), num
        (B,)) here, every op queued without a host sync; shards: a mesh's
        (B = 1, `_shards`; the module's docstring), None for one device."""
        for p in [self] if shards is None else self._device_pipes().values():
            p._ready()
        icfg, r, ns = self.icfg, float(self.mcfg.base_scale), self.mcfg.num_samples
        L, tc = prep.layout
        b = prep.xyz.shape[0]
        with span("f3d.extract.layout"):
            sc = build_sorted_cloud_batch(prep.xyz, prep.valid, cell_size=r, block_size=L)
        pts4, blk_bbox = sc.pts4, sc.blk_bbox
        np_ = pts4.shape[0] // b
        centers = pts4[:, :3]
        # one device: every centre, K4 and K5 taking each cloud's rows of the
        # union (`segment`), so each cloud's results equal its own run's
        seg = np_ if shards is None else None
        grid = SortedCloud(pts4, blk_bbox, None, None, L)      # what K4 and K5 read
        if shards is None:
            parts = [_Shard(self, None, grid, centers)]
        else:
            copies = {d: grid.to(d) for d, _, _ in shards}
            parts = [_Shard(self._device_pipes()[d], d, copies[d], copies[d].pts4[s0:s1, :3], s0)
                     for d, s0, s1 in shards]
        for p in parts:
            with on_device(p.dev):
                with span("f3d.extract.group"):
                    p.grouped, _, _ = ball_query_grouped_sorted(p.sc, p.centers, r, ns, tile=tc,
                                                                segment=seg)
                with span("f3d.extract.detect"):
                    p.att, p.ori = p.pipe._detect_sorted(p.grouped, p.centers, prep.buckets)
        # a point survives iff its attention ties its ball max; invalid points
        # sit at +1e9 and never enter a real ball
        with span("f3d.extract.ballmax"):
            att_s = _gathered([p.att for p in parts], self.device)
            maxes = []
            for p in parts:
                with on_device(p.dev):
                    one = p.dev is None
                    maxes.append(ball_max_sorted(
                        p.sc.pts4, p.sc.blk_bbox, att_s if one else att_s.to(p.dev),
                        float(icfg.nms_radius), centers=None if one else p.centers,
                        segment=seg))
            ballmax = _gathered(maxes, self.device)
        with span("f3d.extract.select"):
            # each cloud's sorted rows in its original order: inv_perm is local
            rows = sc.inv_perm.long() + torch.arange(b, device=pts4.device)[:, None] * np_
            cloud = pts4[rows, :3]                     # invalid at +1e9
            kp, kp_att, num, kp_idx = select_keypoints(
                cloud, att_s[rows], (att_s >= ballmax)[rows], icfg.max_keypoints,
                icfg.min_response_ratio, valid_mask=cloud[..., 0] < 5.0e8, return_indices=True)
        with span("f3d.extract.describe"):
            # descriptors from the attention pass's neighbourhoods
            kp_s = torch.gather(rows, 1, kp_idx.long())
            clusters, ori = _owned(parts, kp_s)
            offs = clusters - centers[kp_s][:, :, None, :]
            if shards is None or not icfg.use_fused_detector:
                return kp, self._describe_at_keypoints(offs, ori), kp_att, num
            feats, n_dev = [], len(self.mesh)       # K3 per device on its K / d keypoints
            for dev, o, a in zip(self.mesh, offs.chunk(n_dev, 1), ori.chunk(n_dev, 1)):
                with on_device(dev):
                    feats.append(self._device_pipes()[dev]._describe_at_keypoints(
                        o.to(dev), a.to(dev)).to(self.device))
            return kp, torch.cat(feats, dim=1), kp_att, num

    @torch.no_grad()
    def _enqueue(self, prep: "_Prepped") -> "_Pending":
        """Queue the hashed route on one prepped unit (over `mesh` when
        there is one) and the copy of its outputs into (pinned) host buffers
        behind a CUDA event; no host sync."""
        with span("f3d.extract.enqueue", prep.uid):
            outs = self._extract_hashed(prep, self._shards(prep.xyz.shape[1]))
            return self._to_host(outs, prep.uid)

    def _to_host(self, outs, uid: int) -> "_Pending":
        with span("f3d.extract.to_host"):
            if self.device.type != "cuda":
                return _Pending(*(o.detach() for o in outs), None, uid)
            host = []
            for o in outs:
                h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                h.copy_(o, non_blocking=True)
                host.append(h)
            event = torch.cuda.Event()
            event.record()
            return _Pending(*host, event, uid)

    @staticmethod
    def _finish(unit: "_Pending") -> List["InferenceResult"]:
        """Wait for a queued unit's read-back and cut each cloud's rows by
        its keypoint count."""
        with span("f3d.extract.finish", unit.uid):
            if unit.event is not None:
                unit.event.synchronize()
            kp, feats, att = unit.kp.numpy(), unit.feats.numpy(), unit.att.numpy()
            out = []
            for i, k in enumerate(unit.num.numpy().tolist()):
                out.append(InferenceResult(keypoints=np.array(kp[i, :k]),
                                           features=np.array(feats[i, :k]),
                                           attention=np.array(att[i, :k]), num_keypoints=int(k)))
            return out

    # -- public API -------------------------------------------------------------

    def attention(self, cloud: torch.Tensor, valid: torch.Tensor,
                  chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense route's first pass: attention and orientation (nb,) at
        every point of a (1, nb, 3) device cloud with (1, nb) validity, in
        `_chunked_attention`'s passes, over `mesh` (nb must split over it)."""
        chunk = chunk or self._chunk_size(cloud.shape[1])
        return self._chunked_attention(cloud, valid, self._shards(cloud.shape[1], chunk), chunk)

    def extract_on_device(self, xyz: torch.Tensor, valid: torch.Tensor,
                          layout: Tuple[int, int]):
        """`extract`'s outputs (B, K, ...) and num (B,) for (B, nb, 3) device
        clouds of one bucket with (B, nb) validity and the Morton layout
        (block, tile), queued with no host sync (on `mesh`: one cloud)."""
        nb = xyz.shape[1]
        prep = _Prepped(xyz, valid, tuple(layout), (nb,) * xyz.shape[0], next(_UNIT_IDS))
        return self._extract_hashed(prep, self._shards(nb))

    @torch.no_grad()
    def extract(self, cloud: np.ndarray, keypoints: Optional[np.ndarray] = None,
                rng: Optional[np.random.RandomState] = None) -> InferenceResult:
        """Keypoints + descriptors of one (N, >=3) host cloud.

        keypoints: optional (K, 3) external keypoints (the reference's
        --use_keypoints_from); detection and NMS are skipped and the model
        runs at those points. rng: permute the points first (the
        reference's --randomize_points).
        """
        if rng is not None:
            cloud = cloud[rng.permutation(cloud.shape[0])]
        prep = self._prep([cloud])
        if keypoints is None and self._use_hashed():
            return self._finish(self._enqueue(prep))[0]
        if keypoints is None:
            outs = self._extract_dense(prep.xyz, prep.valid)
        else:
            kp = torch.from_numpy(np.ascontiguousarray(keypoints[None, :, :3],
                                                       np.float32)).to(self.device)
            out = self.model(prep.xyz, keypoints=kp, valid_mask=prep.valid)
            outs = (kp, out.features, out.end_points["attention"],
                    torch.full((1,), kp.shape[1], dtype=torch.int32))
        return self._finish(self._to_host(outs, prep.uid))[0]

    @torch.no_grad()
    def extract_batch(self, clouds, rng: Optional[np.random.RandomState] = None
                      ) -> List[InferenceResult]:
        """Keypoints + descriptors of several host clouds in one pass of the
        hashed route (the JAX pipeline's extract_batch): the clouds share
        the largest bucket and the smallest layout, and each cloud's result
        equals `extract` on it bit for bit. rng: each cloud's permutation
        drawn in input order, as a loop of `extract` calls draws them. Off
        the hashed route, on `mesh`, or for at most one cloud, it is that
        loop. On `cloud_mesh` each device takes one sub-batch (the clouds
        padded to a multiple of the mesh with replicas of the last one,
        whose results are dropped). Returns the results in input order."""
        clouds = list(clouds)
        if not self._use_hashed() or self.mesh is not None or len(clouds) <= 1:
            return [self.extract(c, rng=rng) for c in clouds]
        if rng is not None:
            clouds = [c[rng.permutation(c.shape[0])] for c in clouds]
        if self.cloud_mesh is None:
            return self._finish(self._enqueue(self._prep(clouds)))
        n, d = len(clouds), len(self.cloud_mesh)
        padded = clouds + [clouds[-1]] * (-n % d)
        per = len(padded) // d
        pipes = self._device_pipes()
        units = []
        for i, dev in enumerate(self.cloud_mesh):
            p = pipes[dev]
            with on_device(dev):
                units.append(p._enqueue(p._prep(padded[i * per:(i + 1) * per])))
        out: List[InferenceResult] = []
        for unit in units:
            out.extend(self._finish(unit))
        return out[:n]

    @spanned("f3d.extract.many")
    @torch.no_grad()
    def extract_many(self, clouds, rng: Optional[np.random.RandomState] = None,
                     depth: int = 2, prep_workers: int = 1, batch_size: int = 1
                     ) -> List[InferenceResult]:
        """Pipelined extraction over many clouds (the JAX pipeline's
        throughput mode). Clouds go in units: one cloud each, or with
        batch_size > 1 up to that many consecutive clouds of one bucket
        (an `extract_batch` unit; a bucket change starts a new unit, and a
        unit of one cloud is an `extract`). `prep_workers` threads pad and
        upload the next units while up to `depth` units are queued on the
        card; the main thread queues each unit without a host sync and
        reads back the oldest once `depth` are queued (inference/stream.py's
        `run_units`). rng: the permutations are drawn in input order before
        any prep, so the results equal a loop of `extract` calls. Off the
        hashed route, or on `mesh`, it is that loop. On `cloud_mesh` the
        units are dealt round-robin over the devices, up to `depth` queued
        on each.
        Returns the results in input order."""
        clouds = list(clouds)
        if not self._use_hashed() or self.mesh is not None:
            return [self.extract(c, rng=rng) for c in clouds]
        if rng is not None:
            clouds = [c[rng.permutation(c.shape[0])] for c in clouds]
        devs = self.cloud_mesh or (self.device,)
        pipes = self._device_pipes()
        depth *= len(devs)
        units: List[list] = []
        for c in clouds:
            if (units and len(units[-1]) < batch_size
                    and self._bucket_of(units[-1][0].shape[0]) == self._bucket_of(c.shape[0])):
                units[-1].append(c)
            else:
                units.append([c])

        def enqueue(i, prep):
            p = pipes[devs[i % len(devs)]]
            with on_device(p.device):
                return p._enqueue(prep)

        return run_units(units, lambda i, unit: pipes[devs[i % len(devs)]]._prep(unit),
                         enqueue, self._finish, depth, prep_workers, "f3d.extract.wait_prep")

    def _bucket_of(self, n: int) -> int:
        """The bucket of an n-point cloud after truncation to num_points."""
        return bucket_for(min(n, self.icfg.num_points) if self.icfg.num_points > 0 else n)

    def warmup(self, point_counts=(), clouds=None, batch_sizes=(1,),
               seed: int = 0) -> Dict[tuple, float]:
        """Pay the start-up costs before the first request: on the card the
        kernels' build (`kernels.build()`), K3's and K6's weight packing,
        cuBLAS and the allocator's first blocks, through one throwaway
        `extract` (batch size 1) or `extract_batch` per (cloud size, batch
        size). point_counts: cloud sizes, each driven by a synthetic cloud
        of its bucket; clouds: representative clouds instead (the layout
        under hash_block=0 depends on density). Returns {(n_points,
        batch_size): seconds}, as the JAX pipeline's warmup."""
        t_build = time.perf_counter()
        if self.device.type == "cuda":
            kernels.build()
            kernels.library()
        self._ready()
        t_build = time.perf_counter() - t_build
        rng = np.random.RandomState(seed)
        work = [(int(n), None) for n in point_counts]
        work += [(c.shape[0], c) for c in (clouds or [])]
        out: Dict[tuple, float] = {}
        for n, cloud in work:
            if cloud is None:
                cloud = (rng.rand(self._bucket_of(n), 3).astype(np.float32) - 0.5) * 40.0
            for b in batch_sizes:
                t0 = time.perf_counter()
                if b <= 1:
                    self.extract(cloud)
                else:
                    self.extract_batch([cloud + np.float32(0.1) * i for i in range(b)])
                out[(n, b)] = time.perf_counter() - t0 + t_build
                t_build = 0.0
        return out

    def process_directory(self, data_dir: str, output_dir: str, data_dim: int = 6,
                          keypoints_dir: Optional[str] = None, log=print,
                          batch_size: int = 1) -> int:
        """Extract for every .bin in data_dir and write [xyz | descriptor]
        .bin files of the same name (reference compute_descriptors,
        inference.py:66-180). batch_size > 1 takes the files that many at a
        time through `extract_batch` (each file's rows equal `extract`'s);
        external keypoints or randomize_points keep the per-file loop."""
        os.makedirs(output_dir, exist_ok=True)
        bins = sorted(f for f in os.listdir(data_dir) if f.endswith(".bin"))
        rng = np.random.RandomState(0) if self.icfg.randomize_points else None
        if batch_size > 1 and keypoints_dir is None and rng is None:
            done = 0
            for i0 in range(0, len(bins), batch_size):
                chunk = bins[i0:i0 + batch_size]
                clouds = [load_point_cloud(os.path.join(data_dir, f), num_cols=data_dim)
                          for f in chunk]
                for fname, res in zip(chunk, self.extract_batch(clouds)):
                    save_descriptors(os.path.join(output_dir, fname), res.keypoints,
                                     res.features)
                    done += 1
                    log(f"Processed {done}/{len(bins)}: {fname} "
                        f"({res.num_keypoints} keypoints)")
            return len(bins)
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


@dataclasses.dataclass
class _Prepped:
    """One unit's clouds on the device: (B, nb, 3) padded points, (B, nb)
    validity (uploads queued), on the hashed route the Morton layout
    (block, tile), each cloud's own bucket (nb is the largest) and the
    unit's id."""
    xyz: torch.Tensor
    valid: torch.Tensor
    layout: Optional[Tuple[int, int]]
    buckets: Tuple[int, ...]
    uid: int


@dataclasses.dataclass
class _Shard:
    """One shard of the hashed route's sorted centres: the pipeline that runs
    it, its device (None: the pipeline's own, no switch, no copies), the
    layout there, its centres and their first row, and their results."""
    pipe: InferencePipeline
    dev: Optional[torch.device]
    sc: SortedCloud
    centers: torch.Tensor
    s0: int = 0
    grouped: Optional[torch.Tensor] = None
    att: Optional[torch.Tensor] = None
    ori: Optional[torch.Tensor] = None


def _gathered(parts: List[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The shards' rows in order on `home` (one shard: its own tensor)."""
    return parts[0] if len(parts) == 1 else torch.cat([t.to(home) for t in parts])


def _owned(parts: List[_Shard], kp_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each keypoint's (B, K, ns, 3) cluster and (B, K) orientation, from
    the one shard whose centres hold its sorted row kp_s (B, K)."""
    if len(parts) == 1:
        return parts[0].grouped[kp_s], parts[0].ori[kp_s]
    home, clusters, ori = kp_s.device, None, None
    for p in parts:
        n, ks = p.centers.shape[0], kp_s.to(p.dev)
        rel = torch.clamp(ks - p.s0, 0, n - 1)
        own = ((ks >= p.s0) & (ks < p.s0 + n)).to(home)
        g, o = p.grouped[rel].to(home), p.ori[rel].to(home)
        clusters = g if clusters is None else torch.where(own[..., None, None], g, clusters)
        ori = o if ori is None else torch.where(own, o, ori)
    return clusters, ori


@dataclasses.dataclass
class _Pending:
    """One queued unit's outputs in host buffers, (B, K, ...) and num (B,),
    valid once `event` has passed (None: already on the host), and the
    unit's id."""
    kp: torch.Tensor
    feats: torch.Tensor
    att: torch.Tensor
    num: torch.Tensor
    event: Optional[Any]
    uid: int
