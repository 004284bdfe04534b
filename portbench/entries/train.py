"""The fused training step as `cli.train` runs it (train/trainer.py).

One TrainState (the port's Feat3DNet on the benchmark's seeded weights and
its Adam) is built once; the host uploads each step's stacked (3B, N, 3)
batch through the port's prefetch thread and `upload`, the step augments
it on the device, and the loss is read back every `read_every` steps.
Set-up drives the same object through its first `first_steps` steps on
distinct batches, through the same call and feed; the window continues
from there.

Correct: the reference (reference/train.py) follows those first steps
from the same weights, batches and augmentation seed. Compared: each
step's loss; the first gradient per leaf, as Adam's first moment after one
step holds it; each leaf's change over the steps.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np
import torch

from portbench import flops, harness, traffic
from portbench.entries.common import Context, port_model, port_model_config, weights
from portbench.reference import model as M
from portbench.reference import train as RT

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = ctx.section("traffic")
        self.tcfg = {**ctx.cfg["train"], **ctx.overrides.get("train", {})}
        self.state = None

    def setup(self) -> None:
        from feat3dnet_tpu_torch.train.trainer import (TrainState, make_fused_train_step,
                                                       make_optimizer)

        ctx, t = self.ctx, self.tcfg
        if t.get("tf32"):
            # the program's own TF32 path, the control's
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        mcfg = ctx.model_cfg()
        mc = port_model_config(mcfg, fused_towers=True,
                               fused_cot_dtype=DTYPES[t["cotangent_dtype"]])
        self.w0 = weights(ctx)
        model = port_model(mc, self.w0, ctx.device)
        opt, schedule = make_optimizer(model, t["learning_rate"])
        self.state = TrainState(step=0, model=model, optimizer=opt, schedule=schedule)
        self.aug_seed = int(ctx.seed) % (1 << 31) + 1
        self.step_fn = make_fused_train_step(model, mcfg["margin"], mcfg["attention"],
                                             augmentations=tuple(t["augmentations"]),
                                             aug_seed=self.aug_seed)
        self.batches = traffic.triplet_batches(ctx.data_root(), self.spec, ctx.seed)
        self.next_batch = 0
        first = int(ctx.section("check")["first_steps"])
        self.first: Dict = {"losses": []}
        self._steps(count=first, on_step=self._record)
        self.first["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}

    def _record(self, step: int, metrics) -> None:
        self.first["losses"].append(metrics["loss"].detach().clone())
        if step == 1:
            opt = self.state.optimizer
            self.first["grad"] = {n: (opt.state[p]["exp_avg"] / (1.0 - RT.BETA1)).clone()
                                  for n, p in self.state.model.named_parameters()}

    def _steps(self, count: int = None, seconds: float = None, on_step=None) -> Dict:
        """Steps through the prefetch feed, `count` of them or until `seconds`
        have passed; ends synchronised."""
        from feat3dnet_tpu_torch.data.datagenerator import prefetch
        from feat3dnet_tpu_torch.train.trainer import upload

        stop = threading.Event()
        start = self.next_batch

        def source():
            k = start
            while not stop.is_set():
                yield self.batches[k % len(self.batches)]
                k += 1

        feed = prefetch(source(), transform=lambda b: upload(b, self.ctx.device))
        read_every = int(self.spec["read_every"])
        steps, bad = 0, 0
        t0 = time.perf_counter()
        for clouds in feed:
            self.state, metrics = self.step_fn(self.state, clouds)
            steps += 1
            if on_step is not None:
                on_step(self.state.step, metrics)
            if self.state.step % read_every == 0:
                bad += int(not np.isfinite(metrics["loss"].item()))
            if count is not None and steps >= count:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        stop.set()
        for _ in feed:      # let the feed's thread run out
            pass
        self.next_batch = start + steps
        return {"steps": steps, "bad": bad, "seconds": elapsed}

    def window(self, seconds: float) -> Dict:
        from feat3dnet_tpu_torch.ops import batch_group, fps, fused_train

        counters = [fps.farthest_point_sample, batch_group.ball_query_fused,
                    fused_train.stats_pass, fused_train.final_pass, fused_train.bwd_top_pass,
                    fused_train.bwd_pass]
        before = sum(c.launches for c in counters)
        r = self._steps(seconds=seconds)
        launches = sum(c.launches for c in counters) - before
        return {"attempted": r["steps"], "failed": r["bad"],
                "metrics": {"step_ms": 1e3 * r["seconds"] / r["steps"]},
                "work": {"steps": r["steps"], "seconds": r["seconds"]},
                "host": {"launches": launches}}

    def release(self) -> None:
        self.state = None
        self.step_fn = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, control: bool = False) -> Dict[str, float]:
        """The reference follows the first steps. loss_gap: |loss - reference|
        / |reference| at the first step. grad_gap and change_gap, per leaf
        | |program's| - |reference's| | over the larger of the reference
        leaf's norm and the median leaf's, for the first gradient and for the
        change of the parameters over the first steps, taken at the median
        leaf; the change leaves out the leaves whose reference gradient is
        under a thousandth of the median leaf's (a Dense bias under BatchNorm,
        whose gradient is nought to rounding). The first step's loss and the
        median leaf: at random weights a few clusters' orientation vectors
        lie near 0, where the normalisation's gradient (1/|o|) makes the
        worst leaf and the later steps swing with rounding (`self.leaves`
        keeps those readings too)."""
        if control:
            raise ValueError("the training cell's control is the program's own TF32 path "
                             "(overrides), not a flag")
        n_steps = len(self.first["losses"])
        batches = [torch.from_numpy(b).to(self.ctx.device) for b in self.batches[:n_steps]]
        ref = RT.train_steps(self.w0, self.ctx.model_cfg(), self.tcfg, batches, self.aug_seed)
        losses = [float(x) for x in self.first["losses"]]
        loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        names = M.param_names(self.ctx.model_cfg())
        g_ref = {n: float(ref["first_grad"][n].norm()) for n in names}
        g_med = float(np.median(list(g_ref.values())))
        grad = {n: abs(float(self.first["grad"][n].norm()) - g_ref[n]) / max(g_ref[n], g_med)
                for n in names}
        moved = [n for n in names if g_ref[n] >= 1e-3 * g_med]
        d_ref = {n: float((ref["params"][n] - self.w0[n]).norm()) for n in moved}
        d_med = float(np.median(list(d_ref.values())))
        change = {n: abs(float((self.first["params"][n] - self.w0[n]).norm()) - d_ref[n])
                  / max(d_ref[n], d_med) for n in moved}
        self.leaves = {"excluded": [n for n in names if n not in moved],
                       "loss_gap_all_steps": max(loss),
                       "grad_worst": [max(grad, key=grad.get), max(grad.values())],
                       "change_worst": [max(change, key=change.get), max(change.values())],
                       "min_orientation_norm": ref["min_orientation_norm"],
                       "near_ties": ref["near_ties"]}
        return {"loss_gap": loss[0], "grad_gap": float(np.median(list(grad.values()))),
                "change_gap": float(np.median(list(change.values())))}

    def layer_work(self, work: Dict) -> Dict[str, float]:
        clouds = 3 * int(self.spec["triplets"])
        return {"model_flops": work["steps"] * flops.train_step_flops(self.ctx.model_cfg(),
                                                                      clouds)}
