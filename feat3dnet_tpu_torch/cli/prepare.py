"""Dataset-preparation CLI of the port (the subcommands and flags of
feat3dnet_tpu/cli/prepare.py, over the port's numpy dataprep/): the
reference's offline MATLAB + converter layer as subcommands.

    # KITTI odometry sequence -> processed clouds + pair groundtruths
    python -m feat3dnet_tpu_torch.cli.prepare kitti \\
        --poses data_raw/kitti/poses/00.txt \\
        --calib data_raw/kitti/sequences/00/calib.txt \\
        --velodyne data_raw/kitti/sequences/00/velodyne \\
        --out data/kitti/processed/00

    # metadata.txt files -> train.txt (positives/nonnegatives)
    python -m feat3dnet_tpu_torch.cli.prepare train-cases \\
        --train_folder data/oxford/train --datasets 2014-06-24-14-15-17 ...

    # SLAM submap binaries -> framework .bin clouds (+ metadata)
    python -m feat3dnet_tpu_torch.cli.prepare submaps --out local_data file1.bin file2.bin ...
"""
from __future__ import annotations

import argparse
import os
import sys


def _cmd_kitti(args):
    from feat3dnet_tpu_torch.dataprep.kitti import process_sequence

    scans = process_sequence(args.poses, args.calib, args.velodyne, args.out,
                             meters_per_cloud=args.meters_per_cloud,
                             pair_max_dist=args.pair_max_dist)
    print(f"Processed {len(scans)} scans -> {args.out}")


def _cmd_train_cases(args):
    import numpy as np

    from feat3dnet_tpu_torch.dataprep.train_cases import generate_train_cases

    fnames, positions = [], []
    for ds in args.datasets:
        meta_path = os.path.join(args.train_folder, ds, "metadata.txt")
        with open(meta_path) as f:
            header = f.readline().split()
            ix, iy, iz = header.index("X"), header.index("Y"), header.index("Z")
            idx_col = header.index("Idx")
            for line in f:
                vals = line.split("\t")
                if len(vals) < len(header):
                    continue
                fnames.append(f"{ds}/{vals[idx_col].strip()}.bin")
                positions.append([float(vals[ix]), float(vals[iy]), float(vals[iz])])
    bounds = None if args.no_test_split else ((-np.inf, np.inf), (-np.inf, args.test_y_max))
    n = generate_train_cases(fnames, np.asarray(positions),
                             os.path.join(args.train_folder, "train.txt"),
                             positive_thresh=args.positive_thresh,
                             negative_thresh=args.negative_thresh,
                             test_bounds=bounds)
    print(f"Wrote train.txt with {n} clouds")


def _cmd_submaps(args):
    from feat3dnet_tpu_torch.dataprep.submap import convert_submaps

    outs = convert_submaps(args.files, args.out, compute_normals=args.normals)
    print(f"Converted {len(outs)} submaps -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Offline dataset preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti")
    k.add_argument("--poses", required=True)
    k.add_argument("--calib", required=True)
    k.add_argument("--velodyne", required=True)
    k.add_argument("--out", required=True)
    k.add_argument("--meters_per_cloud", type=float, default=10.0)
    k.add_argument("--pair_max_dist", type=float, default=10.0)
    k.set_defaults(fn=_cmd_kitti)

    t = sub.add_parser("train-cases")
    t.add_argument("--train_folder", required=True)
    t.add_argument("--datasets", nargs="+", required=True)
    t.add_argument("--positive_thresh", type=float, default=11.0)
    t.add_argument("--negative_thresh", type=float, default=50.0)
    t.add_argument("--test_y_max", type=float, default=100.0)
    t.add_argument("--no_test_split", action="store_true")
    t.set_defaults(fn=_cmd_train_cases)

    s = sub.add_parser("submaps")
    s.add_argument("files", nargs="+")
    s.add_argument("--out", default="./local_data")
    s.add_argument("--normals", action="store_true",
                   help="estimate real normals (reference writes zeros)")
    s.set_defaults(fn=_cmd_submaps)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
