"""Small runs of the cells on the CPU for the tests: the same entries and
checks at sizes a test run can hold (widths as published)."""
from __future__ import annotations

import io

SMALL = {
    "extract-kitti-stream": {"traffic": {"points": 1500, "pool": 2, "warm_frames": 1,
                                         "call_frames": 2}, "check": {"sample": 2}},
    "serve-clusters-7680": {"traffic": {"centres": 32, "batch": 256, "requests": 2,
                                        "warm_requests": 1}, "check": {"sample": 1}},
    "train-oxford-fused": {"traffic": {"points": 512, "pool": 4, "triplets": 2},
                           "model": {"num_clusters": 32}},
}
SEED = 2 ** 31 + 12345


def small_run(workload: str, seconds: float = 0.05, trace: int = 0, extra=None,
              seed: int = SEED) -> dict:
    """One run of `workload` on the CPU at its small size; the result line."""
    from portbench import run

    over = {k: dict(v) for k, v in SMALL[workload].items()}
    for k, v in (extra or {}).items():
        over.setdefault(k, {}).update(v)
    return run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], device="cpu", overrides=over,
                    stream=io.StringIO())
