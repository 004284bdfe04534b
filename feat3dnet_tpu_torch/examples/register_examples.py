"""End-to-end registration over the vendored example clouds, on the port
(counterpart of examples/register_examples.py).

The reference workflow it replaces: inference_example.sh (descriptor
extraction) + scripts/computeAndVisualizeMatches.m (matching, RANSAC,
plots). The port's cli.infer extracts the four vendored clouds, then
cli.match matches and registers the pairs (oxford_270, oxford_456) and
(kitti_00_001554, kitti_00_004534). Outputs go to --out_dir (default
feat3dnet_tpu_torch/examples/results/register_examples).

    python -m feat3dnet_tpu_torch.examples.register_examples --device cuda \\
        --variables feat3dnet_tpu_torch/assets/ckpt4480_variables.npz

Without --variables or --tf1_checkpoint the model runs at its seeded init:
the descriptors are not discriminative, but every stage runs. --plots
renders each pair's matches and alignment (needs matplotlib).
"""
from __future__ import annotations

import argparse
import os
import time

from feat3dnet_tpu_torch.examples import RESULTS_DIR

PAIRS = [("oxford_270", "oxford_456"),
         ("kitti_00_001554", "kitti_00_004534")]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Register the vendored example pairs (port)")
    p.add_argument("--data_dir", default=None, help="defaults to the vendored examples/data")
    p.add_argument("--out_dir", default=os.path.join(RESULTS_DIR, "register_examples"))
    p.add_argument("--tf1_checkpoint", default=None)
    p.add_argument("--variables", default=None, help="variables npz (utils/convert.py)")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from feat3dnet_tpu_torch.cli.infer import main as infer_main
    from feat3dnet_tpu_torch.cli.match import main as match_main
    from feat3dnet_tpu_torch.data.io import example_data_dir
    from feat3dnet_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(args.device))
    data_dir = args.data_dir or example_data_dir()
    infer_args = ["--data_dir", data_dir, "--output_dir", args.out_dir, "--device", device]
    if args.tf1_checkpoint:
        infer_args += ["--tf1_checkpoint", args.tf1_checkpoint]
    if args.variables:
        infer_args += ["--variables", args.variables]
    t0 = time.time()
    infer_main(infer_args)
    print(f"[inference] {time.time() - t0:.1f}s for the clouds of {data_dir}")

    results = {}
    for a, b in PAIRS:
        margs = ["--desc1", os.path.join(args.out_dir, a + ".bin"),
                 "--desc2", os.path.join(args.out_dir, b + ".bin"),
                 "--cloud1", os.path.join(data_dir, a + ".bin"),
                 "--cloud2", os.path.join(data_dir, b + ".bin"), "--device", device]
        if args.plots:
            margs += ["--plot_dir", os.path.join(args.out_dir, f"figs_{a}_{b}")]
        t0 = time.time()
        result = match_main(margs)
        results[(a, b)] = result
        print(f"[{a} <-> {b}] inliers {result['num_inliers']}/{result['num_matches']}"
              f" in {time.time() - t0:.1f}s")
    return results


if __name__ == "__main__":
    main()
