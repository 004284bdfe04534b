"""Whole-cloud extraction exactly as entries/extract.py, on frames made from
the seed instead of the vendored scans: `pool` clouds of `points` points
uniform in a box of `box_m` metres (the accumulated submaps a loop-closure
front end extracts from; the JAX package's bench_extract_many.py stream),
made in one numpy draw."""
from __future__ import annotations

from typing import List

import numpy as np

from portbench import traffic
from portbench.entries import extract
from portbench.entries.common import port_model, port_model_config, weights


def submap_frames(spec, seed: int) -> List[np.ndarray]:
    rng = traffic.rng_for(seed, 6)
    box = np.asarray(spec["box_m"], np.float32)
    pts = rng.random((int(spec["pool"]), int(spec["points"]), 3), dtype=np.float32) * box
    return [np.ascontiguousarray(p) for p in pts]


class Cell(extract.Cell):
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
        self.frames = submap_frames(self.spec, ctx.seed)
        self.pipe.extract_many(self.frames[:self.spec["warm_frames"]],
                               batch_size=self.spec["batch_size"])
        extract._sync(ctx.device)
