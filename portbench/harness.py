"""What every cell shares: the run's clock, the device trace and its
reduction, the per-layer metric readers, and the guard against JAX."""
from __future__ import annotations

import importlib.util
import json
import os
import random
import sys
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "feat3dnet_tpu")
WINDOW_SPAN = "portbench.window"


def process_age_s() -> Optional[float]:
    """Seconds since this process started (from /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload_file(name: str) -> str:
    return os.path.join(HERE, "workloads", f"{name}.json")


def cell_spec(name: str, bench: Optional[Dict] = None) -> Tuple[Dict, Dict, Dict]:
    """(BENCHMARK.json's cell entry, its workload file, its configuration file)."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    return cell, load_json(workload_file(name)), cfg


def metric_reader(name: str):
    """The module metrics/<name>.py; its `read(run)` gives the value or None."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn from
    the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: List = []
        self.seen = 0
        self.rng = random.Random(seed)

    def offer(self, make):
        """Count one item; keep `make()` if it is drawn."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), linear between order statistics."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of nothing")
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# ---- the device trace ----------------------------------------------------------

class Trace:
    """A torch.profiler trace of one window, reduced: device intervals
    (kernels, copies, sets) clipped to the window span, their union, time by
    name, and the host's spans for naming idle gaps."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        dev, host = [], []
        win = None
        for e in prof.profiler.kineto_results.events():
            start, dur = _start_dur_us(e)
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name != WINDOW_SPAN and not _annotation(e):
                    dev.append((start, start + dur, name))
            else:
                host.append((start, start + dur, name))
                if name == WINDOW_SPAN:
                    win = (start, start + dur)
        if win is None:
            raise RuntimeError("trace: the window span is missing")
        self.window = win
        self.window_s = (win[1] - win[0]) * 1e-6
        self.device = sorted((max(a, win[0]), min(b, win[1]), n) for a, b, n in dev
                             if b > win[0] and a < win[1])
        self.host = [h for h in host if h[2] != WINDOW_SPAN]
        self.busy_s = _union_s(self.device)

    def time_s(self, substrings: Sequence[str]) -> float:
        """Seconds of device activity whose name contains any of `substrings`."""
        return sum(b - a for a, b, n in self.device if any(s in n for s in substrings)) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took the most time, and the longest idle
        gaps named by the innermost host span running when each began."""
        by_name: Dict[str, float] = {}
        for a, b, n in self.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.window[0]
        for a, b, _ in self.device:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[self._host_at(g0), (g1 - g0) * 1e-6] for g0, g1 in gaps]}

    def _host_at(self, t: float) -> str:
        best = None
        for a, b, n in self.host:
            if a <= t < b and (best is None or a > best[0]):
                best = (a, n)
        return _short(best[1]) if best else "no host span"


def _annotation(e) -> bool:
    """A record_function range mirrored on the device's timeline: no work."""
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def _start_dur_us(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-3, e.duration_ns() * 1e-3
    return float(e.start_us()), float(e.duration_us())


def _union_s(intervals) -> float:
    total, cur_a, cur_b = 0.0, None, None
    for a, b, _ in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total * 1e-6


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def traced(fn, *args):
    """Run fn(*args) under torch.profiler (CPU and CUDA) inside the window
    span; returns (fn's result, Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            out = fn(*args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, Trace(prof)


class Readings:
    """What a per-layer metric's reader reads: the cell (`run`, with its
    configuration and `layer_work`), the untraced window's result, the
    traced window's result and its Trace."""

    def __init__(self, run, result: Dict, traced: Dict, trace: Trace):
        self.run, self.result, self.traced, self.trace = run, result, traced, trace
        self.cfg = run.ctx.model_cfg()

    def mfu_pct(self) -> float:
        """The model's FLOPs over the untraced window, over the window and the peak."""
        from portbench import flops

        work = self.result["work"]
        model = self.run.layer_work(work)["model_flops"]
        return 100.0 * model / work["seconds"] / flops.peaks()["flops_per_s"]

    def roofline_pct(self, kernels: Sequence[str], flop: float, nbytes: float
                     ) -> Optional[float]:
        """The bound of the work the traced window gave `kernels` over their
        device time; None where they did not run."""
        from portbench import flops

        t = self.trace.time_s(kernels)
        return 100.0 * flops.bound_s(flop, nbytes) / t if t > 0 else None
