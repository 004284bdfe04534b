"""The readings a cell's limits are set from, many seeds in one process:

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 --seconds 3 \
        [--control] [--fault half_batch]

Per seed, one JSON line: the compared numbers of a sound run of the program
(set-up, a window of `--seconds`, the check), or with `--control` of the
cell's control (its workload file's `check.control`: the reference in TF32
put in the program's place, or the program with its lower-precision path
switched on), or with `--fault` of the program with a fault planted
underneath (`half_batch`: a training step on half of the triplets, the
loss's mean taken over them). The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def plant(fault: str) -> None:
    """Break the program underneath the run."""
    from feat3dnet_tpu_torch.train import trainer

    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    make = trainer.make_fused_train_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def half(state, clouds):
            b = clouds.shape[0] // 3
            keep = [r * b + i for r in range(3) for i in range(b // 2)]
            return step(state, clouds[keep].contiguous())

        return half

    trainer.make_fused_train_step = broken


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.entries.common import Context

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, wl, cfg = harness.cell_spec(args.workload)
    control = wl["check"]["control"] if args.control else None
    overrides = control.get("overrides", {}) if control else {}
    if args.fault:
        plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.entry(wl["entry"]).Cell(
            Context(ROOT, cfg, wl, seed, torch.device(args.device), overrides))
        t0 = time.perf_counter()
        run.setup()
        setup = time.perf_counter() - t0
        reference_control = bool(control) and control["kind"] == "reference_tf32"
        if not reference_control:
            run.window(args.seconds)
        run.release()
        numbers = run.numbers(control=reference_control)
        line = {"workload": args.workload, "seed": seed, "control": bool(control),
                "fault": args.fault, "numbers": numbers, "setup_s": setup}
        if hasattr(run, "leaves"):
            line["leaves"] = run.leaves
        print(json.dumps(line), flush=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
