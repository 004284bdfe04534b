#!/usr/bin/env python3
"""Where the device's idle time falls among the program's spans, per cell of
the port's benchmark, on a CUDA card; and what the spans cost.

    python3 scripts/span_report.py [--cells a,b] [--seconds 20] [--seed N]
                                   [--out build/spans] [--cost]

Per cell (portbench/workloads/): the cell's set-up, then three windows of
`--seconds` on one object: untraced; under the benchmark's own trace
(portbench/harness.traced: the calling thread and the threads that inherit
its profiler state, as autograd's); and under a profile of every thread
(utils/profiling's setting, which sees the extraction's prep thread and
the training feed's). Prints each window's end-to-end metric (the traced
ones against the untraced: the spans' cost when on), the cell's per-layer
metrics read from the second window, the spans per unit (extraction unit,
request or step) and each span's mean milliseconds, and for both traced
windows the device's idle time split by the innermost `f3d.*` span open
on any thread (latest start first; "outside the program" where none is),
with every idle gap over 1 ms that begins outside the program and the
innermost host event the trace shows there. The whole reading of each
cell goes to `<out>/<cell>.json`.

`--cost`: the host's cost of one span with no profiler running (the gated
`span` and a `spanned` function against the bare loop and call) and with
a profiler of the calling thread on, on this machine's host, in µs.

Run from the root of a checkout; the card's name and power limit are
printed first.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

GAP_US = 1000.0
UNIT_SPAN = {"extract": "f3d.extract.enqueue", "serve": "f3d.serve.h2d",
             "train": "f3d.train.step"}
OUTSIDE = "outside the program"


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def traced_every_thread(fn, *args):
    """harness.traced with the profile of every thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import harness

    every = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=every) as prof:
        with record_function(harness.WINDOW_SPAN):
            out = fn(*args)
            torch.cuda.synchronize()
    return out, harness.Trace(prof)


def program_spans(trace):
    return [(a, b, n.split("#", 1)[0]) for a, b, n in trace.host if n.startswith("f3d.")]


def innermost_segments(spans):
    """Time cut where the innermost open span changes: (t0, t1, name or
    None), the innermost the latest-starting span open on any thread."""
    spans = [s for s in spans if s[1] > s[0]]
    # at one instant the starts come first, so no span is left open
    events = sorted([(a, 0, i) for i, (a, _, _) in enumerate(spans)]
                    + [(b, 1, i) for i, (_, b, _) in enumerate(spans)])
    open_, segs, t_prev = {}, [], None
    for t, kind, i in events:
        if t_prev is not None and t > t_prev:
            top = max(open_.values()) if open_ else None
            segs.append((t_prev, t, top[1] if top else None))
        if kind == 0:
            open_[i] = (spans[i][0], spans[i][2])
        else:
            del open_[i]
        t_prev = t
    return segs


def idle_gaps(trace):
    gaps, end = [], trace.window[0]
    for a, b, _ in trace.device:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if trace.window[1] > end:
        gaps.append((end, trace.window[1]))
    return gaps


def pieces(segs, ends, t0, t1):
    """[t0, t1) cut by the segments (sorted, disjoint; `ends` their ends):
    (a, b, name or None)."""
    k = bisect.bisect_right(ends, t0)
    t = t0
    while t < t1:
        if k < len(segs) and segs[k][0] <= t:
            b, name = min(t1, segs[k][1]), segs[k][2]
            k += 1
        else:
            b, name = (min(t1, segs[k][0]) if k < len(segs) else t1), None
        yield t, b, name
        t = b


def idle_split(trace):
    """{innermost span or OUTSIDE: idle seconds}; the idle time outside
    every span by the innermost host event (any op or runtime call, on any
    thread); and the idle gaps over 1 ms that begin outside every span,
    with the event there."""
    segs = innermost_segments(program_spans(trace))
    events = innermost_segments(trace.host)
    spans_at = (segs, [b for _, b, _ in segs])
    events_at = (events, [b for _, b, _ in events])
    split, outside, long_outside, n_long = {}, {}, [], 0
    for g0, g1 in idle_gaps(trace):
        for a, b, name in pieces(*spans_at, g0, g1):
            split[name or OUTSIDE] = split.get(name or OUTSIDE, 0.0) + (b - a) * 1e-6
            if name is None:
                for c, d, ev in pieces(*events_at, a, b):
                    ev = ev or "no host event"
                    outside[ev] = outside.get(ev, 0.0) + (d - c) * 1e-6
        if g1 - g0 > GAP_US:
            n_long += 1
            if next(pieces(*spans_at, g0, g1))[2] is None:
                ev = next(pieces(*events_at, g0, g1))[2] or "no host event"
                long_outside.append([ev, (g1 - g0) * 1e-3])
    long_outside.sort(key=lambda x: -x[1])
    return ({k: v for k, v in sorted(split.items(), key=lambda kv: -kv[1])},
            {"outside_by_event_s": dict(sorted(outside.items(), key=lambda kv: -kv[1])[:15]),
             "gaps_over_1ms": n_long, "outside_over_1ms": len(long_outside),
             "outside_over_1ms_ms": sum(x[1] for x in long_outside),
             "outside_longest": long_outside[:12]})


def span_table(trace, units):
    by = {}
    for a, b, n in program_spans(trace):
        c = by.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) * 1e-3
    return {n: {"per_unit": c[0] / units, "mean_ms": c[1] / c[0],
                "total_ms_per_unit": c[1] / units} for n, c in sorted(by.items())}


def cell_report(name, seconds, seed):
    import torch

    from portbench import harness
    from portbench.entries.common import Context

    bench = harness.benchmark()
    _, wl, cfg = harness.cell_spec(name, bench)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    run = harness.entry(wl["entry"]).Cell(Context(harness.ROOT, cfg, wl, seed,
                                                  torch.device("cuda"), {}))
    t0 = time.perf_counter()
    run.setup()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    plain = run.window(seconds)
    res1, trace1 = harness.traced(run.window, seconds)
    res2, trace2 = traced_every_thread(run.window, seconds)
    ctx = harness.Readings(run, plain, res1, trace1)
    per_layer = {}
    for m in bench["per_layer"]:
        if name in m.get("workloads", [name]):
            per_layer[m["name"]] = harness.metric_reader(m["name"]).read(ctx)
    kind = wl["entry"]
    out = {"cell": name, "seed": seed, "seconds": seconds, "setup_s": setup,
           "metrics": {"untraced": plain["metrics"], "traced": res1["metrics"],
                       "traced_every_thread": res2["metrics"]},
           "per_layer": per_layer}
    for label, trace in (("traced", trace1), ("traced_every_thread", trace2)):
        units = sum(1 for _, _, n in program_spans(trace) if n == UNIT_SPAN[kind])
        split, gaps = idle_split(trace)
        out[label] = {"window_s": trace.window_s, "busy_s": trace.busy_s,
                      "idle_pct": trace.idle_pct(), "units": units,
                      "spans_per_unit": sum(1 for _ in program_spans(trace)) / max(units, 1),
                      "idle_split_s": split, **gaps,
                      "spans": span_table(trace, max(units, 1))}
    run.release()
    return out


def summary(out):
    lines = [f"== {out['cell']} (seed {out['seed']}, {out['seconds']} s windows, "
             f"set-up {out['setup_s']:.2f} s)"]
    for k, v in out["metrics"].items():
        lines.append(f"  {k}: {json.dumps(v)}")
    lines.append("  per-layer: " + json.dumps(out["per_layer"]))
    for label in ("traced", "traced_every_thread"):
        t = out[label]
        lines.append(f"  [{label}] idle {t['idle_pct']:.3f} % of {t['window_s']:.3f} s; "
                     f"units {t['units']}; spans/unit {t['spans_per_unit']:.2f}; gaps > 1 ms "
                     f"{t['gaps_over_1ms']}, outside the program {t['outside_over_1ms']} "
                     f"({t['outside_over_1ms_ms']:.3f} ms)")
        idle = t["window_s"] - t["busy_s"]
        lines.append("    idle split: " + ", ".join(
            f"{k} {v:.4f} s ({100 * v / idle:.1f} %)" for k, v in
            list(t["idle_split_s"].items())[:12]))
        lines.append("    outside, by host event: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in list(t["outside_by_event_s"].items())[:8]))
        if t["outside_longest"]:
            lines.append("    outside, longest: " + json.dumps(t["outside_longest"][:6]))
    lines.append("  spans (every thread): " + ", ".join(
        f"{n} {s['per_unit']:.2f}x{s['mean_ms']:.4f} ms"
        for n, s in out["traced_every_thread"]["spans"].items()))
    return "\n".join(lines)


def cost(n: int = 200_000):
    """µs per span on this host: gated with no profiler (a `span`, a
    `spanned` call, an ungated `record_function` for scale), and a `span`
    under a profiler of the calling thread, each less the bare loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from feat3dnet_tpu_torch.utils.profiling import span, spanned

    def bare():
        return None

    wrapped = spanned("f3d.cost")(bare)

    def loop(body):
        def go():
            for _ in range(n):
                body()
        return go

    def in_span():
        with span("f3d.cost"):
            pass

    def in_range():
        with torch.profiler.record_function("f3d.cost"):
            pass

    def best(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times) / n * 1e6

    base = best(loop(bare))
    out = {"span_off_us": best(loop(in_span)) - base,
           "spanned_off_us": best(loop(wrapped)) - base,
           "record_function_off_us": best(loop(in_range), reps=2) - base}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["span_on_us"] = best(loop(in_span), reps=1) - base
    out["torch"] = torch.__version__
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default="extract-kitti-stream,serve-clusters-7680,"
                   "train-oxford-fused")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=2 ** 31 + 501)
    p.add_argument("--out", default=os.path.join("build", "spans"))
    p.add_argument("--cost", action="store_true")
    args = p.parse_args(argv)
    print("card:", card(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    if args.cost:
        print("cost:", json.dumps(cost()), flush=True)
    for i, name in enumerate(c for c in args.cells.split(",") if c):
        out = cell_report(name, args.seconds, args.seed + i)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(summary(out), flush=True)


if __name__ == "__main__":
    main()
