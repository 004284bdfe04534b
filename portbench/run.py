"""One run of one cell of the port's benchmark, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the first timed request) builds the cell's
inputs from the seed, the program under test and its warm-up; then one
window of `--seconds`. With `--trace 1` an untraced window gives the
host-clock and counter metrics and a second window under torch.profiler
the device ones. Then the program is freed and the plain reference judges
a sample of what the timed path produced. The last line of standard output
is the result as one JSON object; the compared numbers and their limits
are the last lines of standard error too.

Exits 4 when the program is not in the checkout, 3 without a CUDA device
(or with fewer than the cell asks for), 5 when JAX or the JAX package got
loaded, 2 on a bad argument.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
os.environ["USE_FLAX"] = "0"
THREADS = 2
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", overrides=None, stream=sys.stdout) -> dict:
    """One run; returns the result line's object. `device` and `overrides`
    are for the tests on the CPU; a run from the command line is on cuda."""
    args = parse(argv)
    from portbench import harness
    from portbench.entries.common import Context

    try:
        bench = harness.benchmark()
        cell, wl, cfg = harness.cell_spec(args.workload, bench)
    except (KeyError, OSError) as e:
        fail(2, str(e))
    try:
        import feat3dnet_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        fail(4, f"the program is not in this checkout: {e}")
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            fail(3, "no CUDA device")
        if torch.cuda.device_count() < int(cell["chips"]):
            fail(3, f"{torch.cuda.device_count()} CUDA devices, the cell needs {cell['chips']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(THREADS)      # one process, few threads: steadier host times

    dev = torch.device(device)
    run = harness.entry(wl["entry"]).Cell(
        Context(ROOT, cfg, wl, args.seed, dev, overrides or {}))
    run.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = harness.process_age_s()
    result = run.window(args.seconds)
    metrics = {}
    if args.trace:
        metrics.update(per_layer(run, result, cell, bench, args.seconds))
    else:
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        for name, value in result["metrics"].items():
            metrics[name] = {"value": value, "unit": e2e[name]["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": e2e["setup_s"]["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                   if dev.type == "cuda" else 0}
    if args.trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    run.release()
    numbers = run.numbers()
    found = harness.forbidden_modules()
    if found:
        fail(5, f"loaded in this process: {', '.join(found)}")
    limits = wl["check"]["limits"]
    correct = bool(result["attempted"] > 0 and result["failed"] == 0
                   and all(v <= limits[k] for k, v in numbers.items()))
    # a non-finite reading has failed its limit; JSON has no NaN
    checks = {k: {"value": v if math.isfinite(v) else None, "limit": limits[k]}
              for k, v in numbers.items()}
    out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": device_info}
    if args.trace:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), file=stream)
    stream.flush()
    return out


def per_layer(run, result, cell, bench, seconds) -> dict:
    """The cell's per-layer metrics: the readers of metrics/ over the
    untraced window (`result`) and a traced one."""
    from portbench import harness

    traced_result, run.trace = harness.traced(run.window, seconds)
    out = {}
    ctx = harness.Readings(run, result, traced_result, run.trace)
    for m in bench["per_layer"]:
        if cell["name"] not in m.get("workloads", [cell["name"]]):
            continue
        value = harness.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    main()
