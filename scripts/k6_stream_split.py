#!/usr/bin/env python3
"""K6's time split on one unit of the extraction stream, on a CUDA card.

    python3 scripts/k6_stream_split.py [--parent DIR]

The unit is what `extract-kitti-stream` hands K6 in one launch: the two
vendored KITTI scans twice, each at its bucket of 32 768 points, every
Morton-sorted point a centre, its K4 cluster origin-centred (M = 131 072
clusters of 64 slots), with the trained ckpt/4480 weights. Per K6 mode
(unfolded, which the stream runs; folded; bf16_operands) it prints
chip_smoke.k6_step's lines: the launch's shared memory and blocks per SM,
the split in ms a call (CUDA events; the kernel leaving each cluster after
input, each per-slot conv, the pool's candidates and the pool; the kernel
alone; the whole wrapper), and the pool's candidates per cluster and
channel. With `--parent` (another checkout, or its csrc/) both trees are
timed in turns and the parent's outputs must equal this tree's bit for bit.

Run from the root of a checkout; the card's name and power limit are
printed first.
"""
import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

KITTI = ("kitti_00_001554.bin", "kitti_00_004534.bin")


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, help="another tree (a checkout or its csrc/)")
    opts = ap.parse_args()

    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
    from feat3dnet_tpu_torch.ops import fused_describe as fd
    from feat3dnet_tpu_torch.utils import load_variables_npz

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.build()
    parent = cs.parent_csrc(opts.parent) if opts.parent else None

    cfg = ModelConfig()
    variables = load_variables_npz(
        os.path.join(HERE, "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz"))
    w_det = [w.to(dev) for w in fd.transpose_unfolded_detector(
        fd.detector_weights_unfolded(variables, cfg))]
    w_fold = [w.to(dev) for w in fd.transpose_folded_weights(fd.folded_weights(variables, cfg))]
    weights = {"unfolded": w_det, "folded": w_fold, "bf16_operands": w_det}
    with torch.no_grad():
        frames = [cs.sorted_clusters(dev, np.ascontiguousarray(
            load_point_cloud(example_cloud_path(n))[:, :3]))[4] for n in KITTI]
        unit = torch.cat(frames * 2).contiguous()
        cs.k6_step(card, "KITTI stream unit", unit, weights, cfg, parent)


if __name__ == "__main__":
    main()
