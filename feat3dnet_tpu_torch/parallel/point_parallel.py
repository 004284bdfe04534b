"""Keypoint-axis parallelism for whole-cloud extraction (port of
feat3dnet_tpu/parallel/point_parallel.py).

A cloud is small (131 072 points x 3 f32 = 1.5 MB), so it is copied to
every device of the mesh (parallel/mesh.py) and the keypoint / centre axis
is split: each device computes its slice against the whole cloud, with no
halo and no neighbour exchange, and the slices are gathered on the mesh's
first device.

Shards follow the single-device run's shapes, so every cloud's results
equal `InferencePipeline.extract` bit for bit: on the default route a shard
is a run of whole detector chunks (`_chunk_size` of the bucket), so no GEMM
changes shape; a mesh with more devices than the cloud has chunks leaves
the last devices out of that pass. K4, K5, K6 and K3 compute each centre
or cluster alone, so their shards are the bucket split evenly. Each
shard's launches run under its device (`torch.cuda.device`), on that
device's current stream; a mesh that names one card twice runs the shards
one after the other there.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet, _group_normalized
from feat3dnet_tpu_torch.ops.hash_grid import (SortedCloud, ball_max_sorted,
                                               ball_query_grouped_sorted,
                                               build_sorted_cloud_batch)
from feat3dnet_tpu_torch.ops.nms import select_keypoints


def on_device(dev: torch.device):
    """The context a shard's launches run in."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def chunk_shards(n: int, unit: int, n_dev: int) -> List[Tuple[int, int]]:
    """(start, end) rows of each device's shard of n rows, cut on multiples
    of `unit`: the n / unit units dealt in contiguous runs, the first
    devices taking one more where they do not split evenly (and the last
    taking none when there are fewer units than devices)."""
    nu = n // unit
    cut = [-(-i * nu // n_dev) * unit for i in range(n_dev + 1)]
    return list(zip(cut[:-1], cut[1:]))


def replicas(model: torch.nn.Module, mesh: Sequence[torch.device]
             ) -> Dict[torch.device, torch.nn.Module]:
    """One model per distinct device of the mesh: the model itself on its
    own device, a copy on each other one."""
    home = next(model.parameters()).device
    out: Dict[torch.device, torch.nn.Module] = {}
    for dev in mesh:
        if dev not in out:
            out[dev] = model if dev == home else copy.deepcopy(model).to(dev)
    return out


def keypoint_sharded_attention(model: Feat3DNet, mesh: Sequence[torch.device],
                               chunk: Optional[int] = None,
                               models: Optional[Dict[torch.device, torch.nn.Module]] = None
                               ) -> Callable:
    """fn(cloud (1, N, 3), valid (1, N)) -> (attention (N,), orientation (N,))
    on the mesh's first device, the keypoint axis (every point) split over
    the mesh: each device runs the ball query and the detector for its
    points in passes of `chunk` (default: its whole shard), as
    `InferencePipeline._chunked_attention` runs them. N must split evenly
    over the mesh (the JAX rule; buckets are powers of two). models: the
    per-device replicas (default: `replicas(model, mesh)`)."""
    mesh = tuple(mesh)
    models = models or replicas(model, mesh)
    r, ns = model.cfg.base_scale, model.cfg.num_samples

    def fn(cloud: torch.Tensor, valid: torch.Tensor):
        n = cloud.shape[1]
        if n % len(mesh):
            raise ValueError(f"keypoint_sharded_attention: {n} points do not split over "
                             f"{len(mesh)} devices")
        c = chunk or n // len(mesh)
        atts, oris = [], []
        for dev, (s0, s1) in zip(mesh, chunk_shards(n, c, len(mesh))):
            cl, vm = cloud.to(dev), valid.to(dev)
            with on_device(dev):
                for s in range(s0, s1, c):
                    grouped, _, _ = _group_normalized(cl, cl[:, s:s + c].contiguous(), r, ns, vm)
                    att, ori = models[dev].detect_clusters(grouped)
                    atts.append(att[0].to(mesh[0]))
                    oris.append(ori[0].to(mesh[0]))
        return torch.cat(atts), torch.cat(oris)

    return fn


def make_sharded_extract(model: Feat3DNet, mesh: Sequence[torch.device], mcfg, icfg,
                         n_bucket: int, pipelines: Optional[Dict] = None) -> Callable:
    """Sharded end-to-end extraction of one cloud on the hashed route.

    Returns impl(xyz (1, nb, 3), valid (1, nb), layout (block, tile)) on
    the mesh's first device -> (kp (1, K, 3), features (1, K, D), kp_att
    (1, K), num (1,)), equal to the single-device hashed route's:

      * the Morton layout on the first device, copied to each device;
      * per centre shard: K4 against the whole sorted cloud, then the
        detector (the model's towers in whole chunks, or K6);
      * the attention gathered to every device, K5 per centre shard;
      * selection on the first device;
      * each keypoint's cluster and orientation taken from its owning
        shard (every sorted row has one owner);
      * descriptors: K3 per device on its K / d keypoints (fused route),
        or the model's descriptor tower over all K keypoints on the first
        device (default route: one GEMM shape, as `extract` runs it).

    Raises unless nb splits over the mesh into 128-aligned shards and K
    over its devices (JAX's rules). pipelines: per-device
    `InferencePipeline`s holding the model replicas and packed weights
    (default: built here).
    """
    mesh = tuple(mesh)
    n_dev = len(mesh)
    shard, k_max = n_bucket // n_dev, icfg.max_keypoints
    if n_bucket % n_dev or shard % 128:
        raise ValueError(f"bucket {n_bucket} must shard into 128-aligned centre tiles "
                         f"across {n_dev} devices")
    if k_max % n_dev:
        raise ValueError(f"max_keypoints {k_max} must divide across {n_dev} devices")
    if pipelines is None:
        from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline

        pipelines = {dev: InferencePipeline(m, None, mcfg, icfg, device=dev)
                     for dev, m in replicas(model, mesh).items()}
    home = mesh[0]
    fused = icfg.use_fused_detector
    unit = shard if fused else pipelines[home]._chunk_size(n_bucket)
    shards = [(d, s0, s1) for d, (s0, s1) in zip(mesh, chunk_shards(n_bucket, unit, n_dev))
              if s1 > s0]
    r, ns = float(mcfg.base_scale), mcfg.num_samples

    def impl(xyz: torch.Tensor, valid: torch.Tensor, layout: Tuple[int, int]):
        L, tc = layout
        for p in pipelines.values():
            p._pack_weights()
        sc = build_sorted_cloud_batch(xyz, valid, cell_size=r, block_size=L)
        copies = {dev: (sc.pts4.to(dev), sc.blk_bbox.to(dev)) for dev in pipelines}
        parts = []
        for dev, s0, s1 in shards:
            pts4, blk = copies[dev]
            with on_device(dev):
                ctr = pts4[s0:s1, :3]
                grouped, _, _ = ball_query_grouped_sorted(SortedCloud(pts4, blk, None, None, L),
                                                          ctr, r, ns, tile=tc)
                att, ori = pipelines[dev]._detect_sorted(grouped, ctr, (n_bucket,))
            parts.append((grouped, att, ori))
        att_s = torch.cat([att.to(home) for _, att, _ in parts])
        ballmax = []
        for dev, s0, s1 in shards:
            pts4, blk = copies[dev]
            with on_device(dev):
                ballmax.append(ball_max_sorted(pts4, blk, att_s.to(dev), float(icfg.nms_radius),
                                               centers=pts4[s0:s1, :3]).to(home))
        ballmax = torch.cat(ballmax)
        pts4 = sc.pts4
        rows = sc.inv_perm.long()
        cloud = pts4[rows, :3]
        kp, kp_att, num, kp_idx = select_keypoints(
            cloud, att_s[rows], (att_s >= ballmax)[rows], k_max, icfg.min_response_ratio,
            valid_mask=cloud[..., 0] < 5.0e8, return_indices=True)
        kp_s = torch.gather(rows, 1, kp_idx.long())[0]
        clusters = ori_kp = None
        for (dev, s0, s1), (grouped, _, ori) in zip(shards, parts):
            ks = kp_s.to(dev)
            rel = torch.clamp(ks - s0, 0, s1 - s0 - 1)
            own = ((ks >= s0) & (ks < s1)).to(home)
            g, o = grouped[rel].to(home), ori[rel].to(home)
            clusters = g if clusters is None else torch.where(own[:, None, None], g, clusters)
            ori_kp = o if ori_kp is None else torch.where(own, o, ori_kp)
        offs = (clusters - pts4[kp_s, :3][:, None, :])[None]
        ori_kp = ori_kp[None]
        if not fused:
            return kp, pipelines[home]._describe_at_keypoints(offs, ori_kp), kp_att, num
        per = k_max // n_dev
        feats = []
        for i, dev in enumerate(mesh):
            with on_device(dev):
                feats.append(pipelines[dev]._describe_at_keypoints(
                    offs[:, i * per:(i + 1) * per].to(dev),
                    ori_kp[:, i * per:(i + 1) * per].to(dev)).to(home))
        return kp, torch.cat(feats, dim=1), kp_att, num

    return impl
