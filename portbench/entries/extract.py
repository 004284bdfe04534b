"""Whole-cloud extraction through `InferencePipeline` (inference/pipeline.py).

Closed-loop calls of `extract_many(frames, batch_size)` with the entry's
default depth and prep_workers, `call_frames` frames a call, back to back;
the window counts whole calls.

Correct: a sample of the window's results, drawn from the seed, held to the
reference extraction of the same frames (reference/extract.py): the
attention at each keypoint, each descriptor, and the keypoint set.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, harness, traffic
from portbench.entries.common import Context, port_model, port_model_config, weights
from portbench.reference import extract as R
from portbench.reference import model as M


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = ctx.section("traffic")
        self.icfg = {**ctx.cfg["inference"], **ctx.overrides.get("inference", {})}
        self.sample = harness.Reservoir(int(ctx.section("check")["sample"]), ctx.seed)
        self.pipe = None

    # -- set-up -----------------------------------------------------------------

    def setup(self) -> None:
        from feat3dnet_tpu_torch.config import InferenceConfig
        from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline

        ctx = self.ctx
        self.w = weights(ctx)
        mc = port_model_config(ctx.model_cfg())
        ic = InferenceConfig(nms_radius=self.icfg["nms_radius"],
                             min_response_ratio=self.icfg["min_response_ratio"],
                             max_keypoints=self.icfg["max_keypoints"],
                             use_hashed_grouping=self.icfg["use_hashed_grouping"],
                             use_fused_detector=self.icfg["use_fused_detector"])
        self.pipe = InferencePipeline(port_model(mc, self.w, ctx.device), None, mc, ic,
                                      device=ctx.device)
        self.frames = traffic.frames(ctx.data_root(), self.spec, ctx.seed)
        self.pipe.extract_many(self.frames[:self.spec["warm_frames"]],
                               batch_size=self.spec["batch_size"])
        _sync(ctx.device)

    # -- the window ------------------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        n_call, b = int(self.spec["call_frames"]), int(self.spec["batch_size"])
        done, failed, points, kps, calls = 0, 0, 0, 0, 0
        t0 = time.perf_counter()
        while True:
            idx = traffic.order(len(self.frames), n_call, self.ctx.seed, 100 + calls)
            out = self.pipe.extract_many([self.frames[i] for i in idx], batch_size=b)
            for i, r in zip(idx, out):
                self.sample.offer(lambda: (int(i), r))
                failed += _bad(r)
                points += self.frames[i].shape[0]
                kps += r.num_keypoints
            done += len(out)
            calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"attempted": calls * n_call, "failed": failed + calls * n_call - done,
                "metrics": {"clouds_per_s": done / elapsed},
                "work": {"clouds": done, "real_points": points, "keypoints": kps,
                         "seconds": elapsed}}

    def release(self) -> None:
        self.pipe = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct ---------------------------------------------------------------------

    def control_results(self, frame_ids: List[int]) -> List:
        """The reference in TF32, put in the program's place."""
        out = []
        with M.precision(True):
            for i in frame_ids:
                xyz = torch.from_numpy(self.frames[i]).to(self.ctx.device)
                ref = R.extract(self.w, self.ctx.model_cfg(), self.icfg, xyz)
                kp = ref["keypoints"]
                out.append(_Result(self.frames[i][kp.cpu().numpy()],
                                   ref["features"].cpu().numpy(),
                                   ref["attention"][kp].cpu().numpy()))
        return out

    def numbers(self, control: bool = False) -> Dict[str, float]:
        items = self.sample.items
        if not items and not control:
            raise RuntimeError("no result of the window to check")
        if not items:
            ids = traffic.order(len(self.frames), self.sample.k, self.ctx.seed, 98).tolist()
            items = list(zip(ids, [None] * len(ids)))
        if control:
            items = list(zip([i for i, _ in items],
                             self.control_results([i for i, _ in items])))
        worst = {"kp_att_gap": 0.0, "desc_gap": 0.0, "kp_set_gap": 0.0}
        with M.precision(False):
            for i, res in items:
                xyz = torch.from_numpy(self.frames[i]).to(self.ctx.device)
                for k, v in compare(self.w, self.ctx.model_cfg(), self.icfg, xyz,
                                    self.frames[i], res).items():
                    worst[k] = max(worst[k], v)
        return worst

    def layer_work(self, work: Dict) -> Dict[str, float]:
        mcfg = self.ctx.model_cfg()
        return {"model_flops": flops.extract_flops(mcfg, work["real_points"], work["keypoints"])}


class _Result:
    """The fields of the program's InferenceResult that the check reads."""

    def __init__(self, keypoints, features, attention):
        self.keypoints, self.features, self.attention = keypoints, features, attention
        self.num_keypoints = len(keypoints)


def _bad(r) -> int:
    return int(r.num_keypoints < 1 or not np.isfinite(r.features).all()
               or r.features.shape != (r.num_keypoints, r.features.shape[1]))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def compare(w, mcfg: Dict, icfg: Dict, xyz: torch.Tensor, frame: np.ndarray, res
            ) -> Dict[str, float]:
    """One frame: the program's result against the reference's extraction.

    kp_att_gap: the largest |attention - reference attention| at the
    program's keypoints, over the frame's largest reference attention.
    desc_gap: the largest |descriptor - reference descriptor| (unit
    vectors) at those keypoints. kp_set_gap: |P xor R| / (|P| + |R|), P the
    program's keypoints as point indices (a keypoint that is no point of the
    frame counts as outside R), R the reference's.
    """
    ref = R.extract(w, mcfg, icfg, xyz)
    where = {row.tobytes(): j for j, row in enumerate(frame)}
    kp = np.asarray(res.keypoints, np.float32).reshape(-1, 3)
    idx = [where.get(row.tobytes(), -1) for row in kp]
    found = np.array([j >= 0 for j in idx], bool)
    p_set = {j for j in idx if j >= 0}
    r_set = set(ref["keypoints"].cpu().numpy().tolist())
    unmatched = int((~found).sum())
    set_gap = (len(p_set ^ r_set) + unmatched) / max(1, len(idx) + len(r_set))
    if not found.any():
        return {"kp_att_gap": 1.0, "desc_gap": 2.0, "kp_set_gap": 1.0}
    at = torch.tensor([j for j in idx if j >= 0], device=xyz.device)
    att_ref = ref["attention"]
    att_p = torch.from_numpy(np.asarray(res.attention, np.float32)[found]).to(xyz.device)
    att_gap = float((att_p - att_ref[at]).abs().max() / att_ref.max())
    f_ref = R.describe_at(w, mcfg, xyz, at, ref["orientation"])
    f_p = torch.from_numpy(np.asarray(res.features, np.float32)[found]).to(xyz.device)
    return {"kp_att_gap": att_gap, "desc_gap": float((f_p - f_ref).abs().max()),
            "kp_set_gap": float(set_gap)}
