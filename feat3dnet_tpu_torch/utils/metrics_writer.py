"""Training-metrics stream (port of feat3dnet_tpu/utils/metrics_writer.py).

The reference emits TensorBoard summaries: scalar loss every 20 steps,
fp_rate from validation (train.py:160-178), plus histograms of pts_cnt
(pointnet_common.py:41) and normalized_attention (feat3dnet.py:346).
Metrics stream to an append-only JSONL file (scalars and 16-bin histogram
summaries); tensorboard=True mirrors them into TensorBoard event files
(torch.utils.tensorboard, which needs the `tensorboard` package) under
`<dir of path>/tb`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch


def device_histogram(x: torch.Tensor, bins: int = 16) -> Dict[str, torch.Tensor]:
    """Fixed-bin histogram of `x` on its own device, with JAX's arithmetic
    (bins of width max(hi - lo, 1e-12) / bins from the minimum, the last
    one closed): tensors only, no host sync. The TensorBoard histogram of
    the reference's pts_cnt / normalized_attention summaries."""
    x = x.reshape(-1).to(torch.float32)
    lo, hi = torch.amin(x), torch.amax(x)
    width = torch.clamp(hi - lo, min=1e-12)
    b = torch.clamp(((x - lo) / width * bins).to(torch.int32), 0, bins - 1)
    counts = torch.zeros(bins, dtype=torch.int32, device=x.device).scatter_add_(
        0, b.to(torch.int64), torch.ones_like(b))
    return {"lo": lo, "hi": hi, "counts": counts,
            "num": torch.full((), x.shape[0], dtype=torch.int32, device=x.device),
            "sum": torch.sum(x), "sum_sq": torch.sum(x * x)}


def _to_jsonable(v):
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.item() if a.ndim == 0 else a.tolist()


class MetricsWriter:
    """Rows of `write(**metrics)` (tensors, numbers or histogram dicts) as JSON
    lines in `path`, each with a `ts`; with tensorboard=True also as
    TensorBoard scalars and histograms."""

    def __init__(self, path: str, tensorboard: bool = False):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError("MetricsWriter(tensorboard=True) needs the `tensorboard` "
                                  "package") from e
            self._tb = SummaryWriter(os.path.join(os.path.dirname(os.path.abspath(path)), "tb"))

    def write(self, **metrics: Any) -> None:
        metrics = {k: _to_jsonable(v) for k, v in metrics.items()}
        metrics.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics) + "\n")
        if self._tb is not None:
            self._write_tb(metrics)

    def _write_tb(self, metrics: Dict[str, Any]) -> None:
        step = int(metrics.get("step", 0))
        for k, v in metrics.items():
            if k in ("step", "ts"):
                continue
            if isinstance(v, dict) and "counts" in v:      # histogram summary
                bins = len(v["counts"])
                width = max(v["hi"] - v["lo"], 1e-12) / bins
                limits = [v["lo"] + width * (i + 1) for i in range(bins)]
                self._tb.add_histogram_raw(
                    k, min=v["lo"], max=v["hi"], num=v["num"], sum=v["sum"],
                    sum_squares=v["sum_sq"], bucket_limits=limits,
                    bucket_counts=v["counts"], global_step=step)
            elif isinstance(v, (int, float)):
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
