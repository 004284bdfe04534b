"""Per-point segmentation of whole frames with PointNet++ MSG through
`SegmentationPipeline` (inference/segmentation.py).

Closed-loop calls of `segment_many(frames, rng, batch_size)` with the
entry's default depth and prep_workers, `call_frames` frames a call, back
to back; each call's sampling generator and frame order come from the seed
and the call's number. The window counts whole calls.

Correct: a sample of the window's results, drawn from the seed, held to the
plain reference (reference/pointnet2.py) on the same sampled points:
logit_gap, the largest |logit - reference logit| of a cloud over the
cloud's largest |reference logit|; feat_gap, FP1's output (the head's
128-wide input), the largest ||f - f_ref|| / ||f_ref|| over the points (the
norm floored at 1e-6 of the cloud's largest). The logits are the timed
path's; FP1's output is taken from the same path (`forward_sampled`: on
the card the step graphs of the timed batch shape) on the sampled clouds'
points, once the window has ended and before the program is freed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import flops_seg, harness, traffic
from portbench.entries.common import Context
from portbench.reference import model as M
from portbench.reference import pointnet2 as R


def port_config(mcfg: Dict):
    """The port's PointNet2Config for a configuration's model section."""
    from feat3dnet_tpu_torch.config import PointNet2Config

    if mcfg["input_channels"] != 0 or mcfg["dropout"] != 0.5:
        raise ValueError("the port's PointNet++ takes xyz alone, with the source's "
                         "dropout (the identity in eval)")
    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, (list, tuple)) else v  # noqa: E731
    return PointNet2Config(num_points=mcfg["num_points"], npoints=tup(mcfg["npoints"]),
                           radii=tup(mcfg["radii"]), nsamples=tup(mcfg["nsamples"]),
                           sa_mlps=tup(mcfg["sa_mlps"]), fp_mlps=tup(mcfg["fp_mlps"]),
                           cls_fc=tup(mcfg["cls_fc"]), bn_epsilon=mcfg["bn_epsilon"])


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = ctx.section("traffic")
        self.sample = harness.Reservoir(int(ctx.section("check")["sample"]), ctx.seed)
        self.pipe = None
        self.features: Optional[List[np.ndarray]] = None

    # -- set-up -----------------------------------------------------------------

    def setup(self) -> None:
        from feat3dnet_tpu_torch.inference.segmentation import SegmentationPipeline
        from feat3dnet_tpu_torch.models.pointnet2 import PointNet2MSG

        ctx = self.ctx
        mcfg = ctx.model_cfg()
        self.w = R.make_weights(mcfg, ctx.seed, ctx.device)
        model = PointNet2MSG(port_config(mcfg)).to(ctx.device)
        model.load_state_dict(self.w, strict=True)
        self.pipe = SegmentationPipeline(model, device=ctx.device)
        self.frames = traffic.frames(ctx.data_root(), self.spec, ctx.seed)
        self.pipe.segment_many(self.frames[:self.spec["warm_frames"]],
                               traffic.rng_for(ctx.seed, 99), batch_size=self.spec["batch_size"])
        _sync(ctx.device)

    # -- the window ------------------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        n_call, b = int(self.spec["call_frames"]), int(self.spec["batch_size"])
        done, failed, calls = 0, 0, 0
        t0 = time.perf_counter()
        while True:
            idx = traffic.order(len(self.frames), n_call, self.ctx.seed, 100 + calls)
            out = self.pipe.segment_many([self.frames[i] for i in idx],
                                         traffic.rng_for(self.ctx.seed, 5000 + calls),
                                         batch_size=b)
            for i, r in zip(idx, out):
                self.sample.offer(lambda: (int(i), r))
                # a NaN or inf logit makes the sum non-finite (one pass, not two)
                failed += int(not np.isfinite(r.logits.sum()))
            done += len(out)
            calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"attempted": calls * n_call, "failed": failed + calls * n_call - done,
                "metrics": {"clouds_per_s": done / elapsed},
                "work": {"clouds": done, "seconds": elapsed}}

    def release(self) -> None:
        """FP1's output on the sampled clouds, through the pipeline's path
        in units of the timed `batch_size` (the last filled with repeats of
        its first cloud), then the program freed."""
        if self.pipe is not None and self.sample.items:
            xyz = self._sampled([res for _, res in self.sample.items])
            b = int(self.spec["batch_size"])
            self.features = []
            for lo in range(0, xyz.shape[0], b):
                part = xyz[lo:lo + b]
                fill = part[:1].expand(b - part.shape[0], *part.shape[1:])
                feats = self.pipe.forward_sampled(torch.cat([part, fill]))[1]
                self.features += [f.cpu().numpy() for f in feats[:part.shape[0]]]
        self.pipe = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct ---------------------------------------------------------------------

    def _sampled(self, results) -> torch.Tensor:
        ids = [i for i, _ in self.sample.items]
        return torch.from_numpy(np.stack([self.frames[i][r.indices] for i, r in
                                          zip(ids, results)])).to(self.ctx.device)

    def numbers(self, control: bool = False) -> Dict[str, float]:
        mcfg = self.ctx.model_cfg()
        items = self.sample.items
        if not items and not control:
            raise RuntimeError("no result of the window to check")
        if control:
            ids = ([i for i, _ in items] if items else
                   traffic.order(len(self.frames), self.sample.k, self.ctx.seed, 98).tolist())
            rng = traffic.rng_for(self.ctx.seed, 97)
            rows = [rng.choice(self.frames[i].shape[0], mcfg["num_points"], replace=False)
                    for i in ids]
            xyz = torch.from_numpy(np.stack([self.frames[i][r] for i, r in zip(ids, rows)])
                                   ).to(self.ctx.device)
            with M.precision(True):
                got_logits, got_feats = R.forward(self.w, mcfg, xyz)
            got_logits, got_feats = got_logits.cpu().numpy(), got_feats.cpu().numpy()
        else:
            xyz = self._sampled([r for _, r in items])
            got_logits = np.stack([r.logits for _, r in items])
            got_feats = np.stack(self.features)
        with M.precision(False):
            want_logits, want_feats = R.forward(self.w, mcfg, xyz)
        return compare(got_logits, got_feats, want_logits.cpu().numpy(),
                       want_feats.cpu().numpy())

    def layer_work(self, work: Dict) -> Dict[str, float]:
        return {"model_flops": flops_seg.model_flops(self.ctx.model_cfg(), work["clouds"])}


def compare(logits: np.ndarray, feats: np.ndarray, ref_logits: np.ndarray,
            ref_feats: np.ndarray) -> Dict[str, float]:
    """(B, N) logits and (B, N, C) FP1 outputs against the reference's; a
    non-finite value gives a non-finite gap (np.max keeps NaN)."""
    logits, feats = logits.astype(np.float64), feats.astype(np.float64)
    d = np.abs(logits - ref_logits).max(axis=1) / np.abs(ref_logits).max(axis=1)
    norm = np.linalg.norm(ref_feats.astype(np.float64), axis=-1)
    diff = np.linalg.norm(feats - ref_feats, axis=-1)
    rel = diff / np.maximum(norm, 1e-6 * norm.max(axis=1, keepdims=True))
    return {"logit_gap": float(np.max(d)), "feat_gap": float(np.max(rel))}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
