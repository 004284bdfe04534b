"""Cluster descriptors through `ClusterDescriptorServer` (inference/serving.py).

One closed-loop client sends `__call__` a (batch, ns, 3) host array of
origin-centred clusters and copies the descriptors and attention to the
host before it sends the next.

Correct: a sample of the window's requests, drawn from the seed, held to
the reference's eval forward on the same clusters (reference/model.py).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import flops, harness, traffic
from portbench.entries.common import Context, port_model, port_model_config, weights
from portbench.reference import model as M


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = ctx.section("traffic")
        self.sample = harness.Reservoir(int(ctx.section("check")["sample"]), ctx.seed)
        self.server = None

    def setup(self) -> None:
        from feat3dnet_tpu_torch.inference.serving import ClusterDescriptorServer

        ctx = self.ctx
        self.w = weights(ctx)
        mc = port_model_config(ctx.model_cfg())
        self.server = ClusterDescriptorServer(port_model(mc, self.w, ctx.device),
                                              device=ctx.device)
        self.requests = traffic.cluster_requests(ctx.data_root(), self.spec, ctx.seed,
                                                 ctx.device)
        for req in self.requests[:self.spec["warm_requests"]]:
            self._call(req)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self, req: np.ndarray):
        desc, att = self.server(req)
        return desc.cpu().numpy(), att.cpu().numpy()

    def window(self, seconds: float) -> Dict:
        pick = traffic.cycle(len(self.requests), self.ctx.seed, 200 + self.sample.seen)
        failed, rows, calls = 0, 0, 0
        t0 = time.perf_counter()
        while True:
            i = next(pick)
            desc, att = self._call(self.requests[i])
            self.sample.offer(lambda: (i, desc, att))
            failed += int(desc.shape[0] != self.requests[i].shape[0]
                          or not np.isfinite(desc).all())
            rows += desc.shape[0]
            calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"attempted": calls, "failed": failed,
                "metrics": {"descriptors_per_s": rows / elapsed},
                "work": {"requests": calls, "clusters": rows, "seconds": elapsed}}

    def release(self) -> None:
        self.server = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, control: bool = False) -> Dict[str, float]:
        """desc_gap: the largest |descriptor - reference| over the sampled
        requests' rows; att_gap: the largest |attention - reference| over the
        largest reference attention."""
        items = self.sample.items
        if not items and not control:
            raise RuntimeError("no result of the window to check")
        ids = [i for i, *_ in items] or traffic.order(
            len(self.requests), self.sample.k, self.ctx.seed, 98).tolist()
        worst = {"desc_gap": 0.0, "att_gap": 0.0}
        for j, i in enumerate(ids):
            offs = torch.from_numpy(self.requests[i]).to(self.ctx.device)
            with M.precision(False):
                d_ref, a_ref = M.describe_clusters(self.w, self.ctx.model_cfg(), offs)
            if control:
                with M.precision(True):
                    d_p, a_p = M.describe_clusters(self.w, self.ctx.model_cfg(), offs)
            else:
                d_p = torch.from_numpy(items[j][1]).to(offs.device)
                a_p = torch.from_numpy(items[j][2]).to(offs.device)
            worst["desc_gap"] = max(worst["desc_gap"], float((d_p - d_ref).abs().max()))
            worst["att_gap"] = max(worst["att_gap"],
                                   float((a_p - a_ref).abs().max() / a_ref.abs().max()))
        return worst

    def layer_work(self, work: Dict) -> Dict[str, float]:
        return {"model_flops": flops.k3_work(self.ctx.model_cfg(), work["clusters"])[0]}
