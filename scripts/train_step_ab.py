"""Time the port's training step of this checkout against another one's, in
turns, on the card.

    python3 scripts/train_step_ab.py <other checkout> [--blocks 3]

Each measurement is a fresh process rooted at one tree (its
feat3dnet_tpu_torch and its kernels, built under that tree's build/):
make_fused_train_step at the paper config, TrainConfig() widths (18 x
4 096 points from the vendored clouds, cropped and resampled under seeds
100..117, augmented on the card), seeded weights, on the autograd and the
fused route in turns (autograd, fused, fused, autograd), each the median
of 12 synchronised steps after 2, as chip_smoke.py phase 12 times them.
Blocks run the trees in turns (other, this, this, other). It prints each
process's medians, each tree's mean and min / max per route, the per-block
difference, and this tree's device_histogram cost per call on a step's
det_cnt shape (host clock: queued, and synchronised). Needs a CUDA device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r"""
import json, statistics, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
from feat3dnet_tpu_torch.config import ModelConfig, TrainConfig
from feat3dnet_tpu_torch.data.augment import resolve_augmentations
from feat3dnet_tpu_torch.data.datagenerator import crop_and_resample
from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.train import init_state, make_fused_train_step
from feat3dnet_tpu_torch.utils import init_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
names = ("oxford_270.bin", "oxford_456.bin", "kitti_00_001554.bin", "kitti_00_004534.bin")
raw = [load_point_cloud(example_cloud_path(n)) for n in names]
batch = np.stack([crop_and_resample(raw[i % 4], 4096, np.random.RandomState(100 + i))[:, :3]
                  for i in range(18)])
clouds = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(dev)
cfg, tcfg = ModelConfig(), TrainConfig()
variables = init_variables(cfg, seed=0)
aug = tuple(resolve_augmentations(tcfg.augmentations, tcfg.upright_axis))


def step_ms(fused):
    m = Feat3DNet(ModelConfig(fused_towers=fused))
    s = init_state(m, tcfg, cfg, variables=variables, device=dev)
    step = make_fused_train_step(m, cfg.margin, cfg.attention, augmentations=aug, aug_seed=1)
    for _ in range(2):
        step(s, clouds)
    torch.cuda.synchronize()
    per = []
    for _ in range(12):
        t0 = time.perf_counter()
        step(s, clouds)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per)


out = {"autograd": [], "fused": []}
for route in ("autograd", "fused", "fused", "autograd"):
    out[route].append(step_ms(route == "fused"))
try:
    from feat3dnet_tpu_torch.utils.metrics_writer import device_histogram
except ImportError:
    device_histogram = None
if device_histogram is not None:
    x = torch.randint(0, 65, (18, 512), device=dev).float()
    for _ in range(10):
        device_histogram(x)
    torch.cuda.synchronize()
    q, s = [], []
    for _ in range(200):
        t0 = time.perf_counter()
        device_histogram(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        q.append((t1 - t0) * 1e3)
        s.append((time.perf_counter() - t0) * 1e3)
    out["histogram_queue_ms"] = statistics.median(q)
    out["histogram_sync_ms"] = statistics.median(s)
print(json.dumps(out))
"""


def run(root):
    proc = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="another checkout (e.g. a parent unpacked with git archive)")
    ap.add_argument("--blocks", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_step_ab: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    other = os.path.abspath(args.other)
    res = {"other": [], "this": []}
    for b in range(args.blocks):
        for tag, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
            r = run(root)
            res[tag].append(r)
            print(f"block {b} {tag}: autograd {[round(v, 3) for v in r['autograd']]} ms, "
                  f"fused {[round(v, 3) for v in r['fused']]} ms", flush=True)
    for route in ("autograd", "fused"):
        per = {t: [statistics.mean(r[route]) for r in rs] for t, rs in res.items()}
        diff = [float(np.mean(per["this"][2 * b:2 * b + 2])
                      - np.mean(per["other"][2 * b:2 * b + 2])) for b in range(args.blocks)]
        print(f"[{card}] train step {route} route, {args.blocks} blocks of turns (other, this, "
              f"this, other): this {np.mean(per['this']):.3f} ms (min {min(per['this']):.3f}, "
              f"max {max(per['this']):.3f}), other {np.mean(per['other']):.3f} ms (min "
              f"{min(per['other']):.3f}, max {max(per['other']):.3f}); this - other per block "
              f"{[round(d, 3) for d in diff]}")
    hist = [r["histogram_queue_ms"] for r in res["this"] if "histogram_queue_ms" in r]
    if hist:
        print(f"[{card}] device_histogram (18 x 512): queued in "
              f"{statistics.median(hist):.4f} ms on the host, "
              f"{statistics.median(r['histogram_sync_ms'] for r in res['this']):.4f} ms "
              "synchronised (medians of 200 calls, over this tree's processes)")


if __name__ == "__main__":
    main()
