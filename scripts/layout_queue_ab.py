#!/usr/bin/env python3
"""Host time to queue the Morton layout of one cloud on a CUDA card: this
tree's `build_sorted_cloud` against another tree's, in turns.

    python3 scripts/layout_queue_ab.py DIR [--reps N]

DIR is another checkout (a commit unpacked with `git archive`, say). Its
`feat3dnet_tpu_torch/ops/hash_grid.py` is loaded under another module
name; the imports it makes resolve to this tree's package, which the
layout does not use. On each vendored cloud and a seeded 200 000-point
cloud, at its bucket with 256-point blocks and a 2 m cell (the
pipeline's call): both trees' layouts are held bit-equal in every field,
then each is timed on the host clock from the call to its return, the
card synchronised before each call and nothing waited on inside it
(the interval the extract's span `f3d.extract.layout` marks), and on CUDA events
recorded before and after the call (the card's wall time for it, which
waits on the host while the ops are queued), in turns: other, this,
this, other, `--reps` times. Prints ms per call (mean and spread) and the card's name
and power limit. Run from the root of a checkout.
"""
import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

FIELDS = ("pts4", "blk_bbox", "orig_idx", "inv_perm")


def other_hash_grid(directory):
    path = os.path.join(os.path.abspath(directory), "feat3dnet_tpu_torch", "ops",
                        "hash_grid.py")
    spec = importlib.util.spec_from_file_location("other_hash_grid", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod           # its dataclass looks itself up there
    spec.loader.exec_module(mod)
    return mod


def clouds():
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud

    out = {n: load_point_cloud(example_cloud_path(n))[:, :3]
           for n in ("oxford_270.bin", "oxford_456.bin", "kitti_00_001554.bin",
                     "kitti_00_004534.bin")}
    rs = np.random.RandomState(0)
    out["synthetic_200k"] = ((rs.rand(200_000, 3) - 0.5) * 200.0).astype(np.float32)
    return out


def main():
    import torch

    from feat3dnet_tpu_torch.config import bucket_for
    from feat3dnet_tpu_torch.ops import hash_grid as this

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("layout_queue_ab: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    other = other_hash_grid(opts.other)
    dev = torch.device("cuda")
    builds = {"other": other.build_sorted_cloud, "this": this.build_sorted_cloud}
    for name, c in clouds().items():
        nb = bucket_for(c.shape[0])
        xyz = torch.zeros((nb, 3), device=dev)
        xyz[:c.shape[0]] = torch.from_numpy(np.ascontiguousarray(c)).to(dev)
        valid = torch.arange(nb, device=dev) < c.shape[0]

        def call(tag):
            return builds[tag](xyz, valid, cell_size=2.0, block_size=256)
        a, b = call("other"), call("this")
        for f in FIELDS:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise SystemExit(f"{name}: the two trees' layouts differ in {f}")
        host = {t: [] for t in builds}
        card_ms = {t: [] for t in builds}
        for _ in range(opts.reps):
            for tag in ("other", "this", "this", "other"):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                t0 = time.perf_counter()
                call(tag)
                host[tag].append((time.perf_counter() - t0) * 1e3)
                end.record()
                torch.cuda.synchronize()
                card_ms[tag].append(start.elapsed_time(end))
        print(f"[{card}] layout {name} (bucket {nb}), ms per call, {2 * opts.reps} calls "
              "each in turns: " + "; ".join(
                  f"{t}: queued on the host {np.mean(host[t]):.4f} (min {np.min(host[t]):.4f}, "
                  f"max {np.max(host[t]):.4f}), events {np.mean(card_ms[t]):.4f}"
                  for t in builds) + "; bit-equal in " + ", ".join(FIELDS))


if __name__ == "__main__":
    main()
