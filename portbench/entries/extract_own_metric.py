"""Whole-cloud extraction exactly as entries/extract.py, its rate reported
under the end-to-end metric that the workload file names (`rate_metric`):
for a cell whose clouds/s is bounded apart from `clouds_per_s`."""
from __future__ import annotations

from typing import Dict

from portbench.entries import extract


class Cell(extract.Cell):
    def window(self, seconds: float) -> Dict:
        out = extract.Cell.window(self, seconds)
        out["metrics"] = {self.ctx.wl["rate_metric"]: out["metrics"]["clouds_per_s"]}
        return out
