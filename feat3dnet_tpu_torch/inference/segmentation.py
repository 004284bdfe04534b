"""Per-point segmentation of whole clouds with PointNet++ MSG
(models/pointnet2.py): PointRCNN's stage 1 over a stream of lidar frames.

Each cloud is sampled to the model's `num_points` (16 384) as PointRCNN's
loader does, but uniformly over the cloud: without replacement where it
has that many points, else all of them and the rest drawn with
replacement, the order shuffled. The caller's `rng` gives each cloud a
63-bit seed, in input order and before the cloud's prep; the prep draws
the cloud's rows on the pipeline's device from a torch generator of that
seed (`sample_rows`) and gathers them there. So `segment_many` equals a
loop of `segment` calls on the same generator, whatever thread preps
which unit, and a unit's host prep is a copy and a few launches: the
first unit of each call waits for it with the card idle, so the calling
thread preps that one itself.

`segment_many` streams units of up to `batch_size` clouds through the
loop that extraction uses (inference/stream.py's `run_units`): worker
threads gather the sampled points into pinned host buffers and queue
their upload, the main thread queues each unit's forward and the copy of
its logits into pinned buffers behind a CUDA event with no host sync, and
reads back the oldest unit once `depth` are queued.

On the card the forward's steps (the model's `steps`: sa1 ... sa4, fp4
... fp1, head) are captured once per batch shape as one CUDA graph each,
on static input and output buffers (`_StepGraphs`), and a unit replays
them: queuing the ~230 kernels of a unit one by one took the host 7-16 ms
against the card's 19.6 ms (H100), so the host's own slow spells set the
rate. The graphs read the weights in place and are made anew if any
parameter or buffer changes. The kernel wrappers' launch counters
(`.launches` of K1, K2 and K11) and `ConvBN.folded_calls` move when a
step is captured, not when it is replayed, so `_StepGraphs` takes back
what a capture counted and adds it on every replay: the counters read
what the card ran. The ConvBNs' eval folds are made in the eager pass
before the capture, and the graphs read them in place. On the CPU the
steps run eagerly.

Under a profiler each unit's stages show as spans (utils/profiling.py):
`f3d.seg.prep#<unit>` (in the prep thread; a call's first in the calling
thread, inside `f3d.seg.wait_prep`), `f3d.seg.wait_prep`,
`f3d.seg.enqueue#<unit>` around `f3d.seg.sa1` ... `.sa4`, `.fp4` ...
`.fp1`, `.head` (each step's replay on the card) and `f3d.seg.to_host`,
then `f3d.seg.finish#<unit>`; `f3d.seg.many` spans a whole
`segment_many` call. A replayed step shows its kernels on the device but
not the wrappers' host spans (`f3d.k1.fps`, ...), which a capture records.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from feat3dnet_tpu_torch.inference.stream import run_units
from feat3dnet_tpu_torch.models.layers import ConvBN, weights_key
from feat3dnet_tpu_torch.models.pointnet2 import PointNet2MSG
from feat3dnet_tpu_torch.ops.batch_group import ball_query_fused
from feat3dnet_tpu_torch.ops.fps import farthest_point_sample
from feat3dnet_tpu_torch.ops.interpolate import three_interpolate
from feat3dnet_tpu_torch.utils.device import resolve_device
from feat3dnet_tpu_torch.utils.profiling import span, spanned

# the id of each unit, shared by its spans on every thread
_UNIT_IDS = itertools.count()


@dataclasses.dataclass
class SegmentationResult:
    indices: np.ndarray     # (num_points,) int64: the sampled rows of the input cloud
    logits: np.ndarray      # (num_points,) float32: their foreground logits


def cloud_seed(rng) -> int:
    """One cloud's seed from `rng` (a numpy Generator or RandomState)."""
    return int.from_bytes(rng.bytes(8), "little") >> 1


def sample_rows(n: int, num_points: int, seed: int, device: torch.device) -> torch.Tensor:
    """`num_points` rows (int64, on `device`) of an n-point cloud in a
    random order, from a torch generator of `seed` on `device`: where n >=
    num_points, the first num_points of the rows ordered by uniform keys
    (a stable sort: a uniform sample without replacement), else every row
    and num_points - n drawn with replacement, in the order of such keys."""
    if n < 1:
        raise ValueError("segment: an empty cloud")
    g = torch.Generator(device=device).manual_seed(seed)
    if n >= num_points:
        keys = torch.rand(n, generator=g, device=device)
        return torch.argsort(keys, stable=True)[:num_points]
    rows = torch.cat([torch.arange(n, device=device),
                      torch.randint(n, (num_points - n,), generator=g, device=device)])
    return rows[torch.argsort(torch.rand(num_points, generator=g, device=device), stable=True)]


class SegmentationPipeline:
    """Foreground logits for whole clouds with one PointNet2MSG on one
    device (`cuda` unless the caller names another; raises without a
    CUDA device)."""

    def __init__(self, model: PointNet2MSG, device: Optional[torch.device] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_points = model.cfg.num_points
        self._graphs: Dict[torch.Size, _StepGraphs] = {}
        self._weights = list(self.model.parameters()) + list(self.model.buffers())
        self._weights_key = None

    def _forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The unit's logits and FP1's features: the model's steps,
        replayed from their CUDA graphs on the card (captured at a new
        shape, or after any weight changed), run eagerly on the CPU."""
        if self.device.type != "cuda":
            out = self.model(xyz)
            return out.logits, out.features
        key = weights_key(self._weights)
        if key != self._weights_key:
            self._graphs.clear()
            self._weights_key = key
        if xyz.shape not in self._graphs:
            self._graphs[xyz.shape] = _StepGraphs(self.model, xyz)
        return self._graphs[xyz.shape].run(xyz)

    def _prep(self, unit: Sequence[Tuple[np.ndarray, int]]) -> "_Prepped":
        """Prep of one unit of (cloud, seed): the clouds copied into a
        (B, max N, 3) host buffer (pinned on the card, so the upload is
        asynchronous) and uploaded, then each cloud's rows drawn from its
        seed and its points gathered into (B, num_points, 3), all queued
        without waiting. Safe in a worker thread; the unit takes its id
        here."""
        uid = next(_UNIT_IDS)
        with span("f3d.seg.prep", uid):
            dev = self.device
            host = torch.empty((len(unit), max(c.shape[0] for c, _ in unit), 3),
                               pin_memory=dev.type == "cuda")
            for i, (cloud, _) in enumerate(unit):
                host[i, :cloud.shape[0]].copy_(
                    torch.from_numpy(np.asarray(cloud[:, :3], np.float32)))
            raw = host.to(dev, non_blocking=True)
            xyz = torch.empty((len(unit), self.num_points, 3), device=dev)
            rows = torch.empty((len(unit), self.num_points), dtype=torch.int64, device=dev)
            for i, (cloud, seed) in enumerate(unit):
                rows[i] = sample_rows(cloud.shape[0], self.num_points, seed, dev)
                torch.index_select(raw[i], 0, rows[i], out=xyz[i])
            return _Prepped(xyz, rows, uid)

    @torch.no_grad()
    def _enqueue(self, prep: "_Prepped") -> "_Pending":
        """Queue the forward on one prepped unit and the copy of its logits
        into a (pinned) host buffer behind a CUDA event; no host sync."""
        with span("f3d.seg.enqueue", prep.uid):
            logits = self._forward(prep.xyz)[0]
            with span("f3d.seg.to_host"):
                if self.device.type != "cuda":
                    return _Pending(logits, prep.rows, None, prep.uid)
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in (logits, prep.rows)]
                for h, t in zip(host, (logits, prep.rows)):
                    h.copy_(t, non_blocking=True)
                # the read-back's wait sleeps rather than spins: the host's
                # cores stay free for the prep thread
                event = torch.cuda.Event(blocking=True)
                event.record()
                return _Pending(*host, event, prep.uid)

    @staticmethod
    def _finish(unit: "_Pending") -> List[SegmentationResult]:
        """Wait for a queued unit's read-back; one result per cloud."""
        with span("f3d.seg.finish", unit.uid):
            if unit.event is not None:
                unit.event.synchronize()
            logits, rows = unit.logits.numpy(), unit.rows.numpy()
            return [SegmentationResult(np.array(rows[i]), np.array(logits[i]))
                    for i in range(len(rows))]

    @torch.no_grad()
    def forward_sampled(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The logits (B, N) and FP1's features (B, N, C) of (B,
        num_points, 3) sampled points on the device, by the path a unit of
        B clouds takes (the step graphs of that shape on the card), as
        copies of the graphs' buffers."""
        logits, feats = self._forward(xyz.contiguous())
        return logits.clone(), feats.clone()

    def segment(self, cloud: np.ndarray, rng) -> SegmentationResult:
        """The logits of one (N, >=3) host cloud, sampled with a seed from
        `rng`."""
        return self._finish(self._enqueue(self._prep([(cloud, cloud_seed(rng))])))[0]

    @spanned("f3d.seg.many")
    def segment_many(self, clouds, rng, depth: int = 2, prep_workers: int = 1,
                     batch_size: int = 1) -> List[SegmentationResult]:
        """Pipelined segmentation of many host clouds, in units of up to
        `batch_size` consecutive clouds: this thread preps and queues the
        first unit, then `prep_workers` threads gather and upload the next
        units while up to `depth` units are queued on the card. Every
        cloud's seed comes from `rng` in input order, in this thread, a
        unit's just before its prep is submitted: the same draws as a loop
        of `segment` calls. Returns the results in input order."""
        clouds = list(clouds)
        step = max(1, batch_size)

        def units():
            for i in range(0, len(clouds), step):
                yield [(c, cloud_seed(rng)) for c in clouds[i:i + step]]

        return run_units(units(), lambda i, unit: self._prep(unit),
                         lambda i, prep: self._enqueue(prep), self._finish, depth,
                         prep_workers, "f3d.seg.wait_prep", first_here=True)


# the counters that the model's steps move: the kernel wrappers' launches
# and the GEMMs ConvBN runs folded
_COUNTED = ((farthest_point_sample, "launches"), (ball_query_fused, "launches"),
            (three_interpolate, "launches"), (ConvBN, "folded_calls"))


def _launch_counts() -> Dict[Tuple[Any, str, str], int]:
    """Each counter (mode '') and each wrapper's `mode_launches`."""
    out = {}
    for w, name in _COUNTED:
        out[w, name, ""] = getattr(w, name)
        for mode, n in getattr(w, "mode_launches", {}).items():
            out[w, name, mode] = n
    return out


def _add_counts(delta: Dict[Tuple[Any, str, str], int], sign: int = 1) -> None:
    for (w, name, mode), n in delta.items():
        if mode:
            w.mode_launches[mode] += sign * n
        else:
            setattr(w, name, getattr(w, name) + sign * n)


class _StepGraphs:
    """The model's steps captured as CUDA graphs, one a step, in one memory
    pool, on a static (B, N, 3) input: each step's outputs stay where its
    capture put them, and the next step's graph reads them there. What a
    step's capture adds to the kernel wrappers' launch counters is taken
    back and added on each replay."""

    def __init__(self, model: PointNet2MSG, xyz: torch.Tensor):
        self.xyz = torch.empty_like(xyz)
        self.xyz.copy_(xyz)
        side = torch.cuda.Stream(xyz.device)
        side.wait_stream(torch.cuda.current_stream(xyz.device))
        with torch.no_grad(), torch.cuda.stream(side):
            # lazy set-up (cuBLAS) and the ConvBNs' folds outside the capture
            model(self.xyz)
        torch.cuda.current_stream(xyz.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        state = model.start(self.xyz)
        self.graphs = []
        with torch.no_grad():
            for name, step in model.steps():
                g = torch.cuda.CUDAGraph()
                before = _launch_counts()
                with torch.cuda.graph(g, pool=pool, capture_error_mode="relaxed"):
                    step(state)
                delta = {k: n - before[k] for k, n in _launch_counts().items()
                         if n != before[k]}
                _add_counts(delta, -1)
                self.graphs.append((name, g, delta))
        self.logits, self.features = state["logits"], state["feats"][0]

    def run(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The logits and FP1's features of `xyz` (queued; the buffers are
        the graphs' own, valid until the next run)."""
        self.xyz.copy_(xyz)
        for name, g, delta in self.graphs:
            with span(f"f3d.seg.{name}"):
                g.replay()
            _add_counts(delta)
        return self.logits, self.features


@dataclasses.dataclass
class _Prepped:
    """One unit's (B, num_points, 3) sampled points and (B, num_points)
    sampled rows on the device (queued), and the unit's id."""
    xyz: torch.Tensor
    rows: torch.Tensor
    uid: int


@dataclasses.dataclass
class _Pending:
    """One queued unit's (B, num_points) logits and sampled rows in host
    buffers, valid once `event` has passed (None: already on the host),
    and the unit's id."""
    logits: torch.Tensor
    rows: torch.Tensor
    event: Optional[Any]
    uid: int
