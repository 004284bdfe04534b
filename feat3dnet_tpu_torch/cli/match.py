"""Descriptor matching + RANSAC registration CLI of the port (flags of
feat3dnet_tpu/cli/match.py, plus --device).

Port of scripts/computeAndVisualizeMatches.m: load two [xyz|descriptor]
.bin outputs of the inference CLI, nearest-neighbour match, RANSAC rigid
fit (1.0 m inlier threshold), print the transform and inlier count as
JSON, and optionally render match/alignment figures (needs matplotlib).

    python -m feat3dnet_tpu_torch.cli.match --desc1 out/a.bin --desc2 out/b.bin \\
        --cloud1 data/a.bin --cloud2 data/b.bin --device cuda

Matching and RANSAC run on --device (default cuda; raises without a CUDA
device, cpu only when named). RANSAC draws its triples from a
torch.Generator seeded with --seed, so its draw differs from the JAX CLI's.
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Match descriptors + register clouds (PyTorch port)")
    p.add_argument("--desc1", required=True, help="[xyz|desc] .bin of cloud 1")
    p.add_argument("--desc2", required=True, help="[xyz|desc] .bin of cloud 2")
    p.add_argument("--cloud1", default=None, help="raw cloud .bin (for plots)")
    p.add_argument("--cloud2", default=None)
    p.add_argument("--data_dim", type=int, default=6)
    p.add_argument("--feature_dim", type=int, default=32)
    p.add_argument("--inlier_threshold", type=float, default=1.0)
    p.add_argument("--num_hypotheses", type=int, default=2048)
    p.add_argument("--mutual", action="store_true",
                   help="restrict to mutual nearest neighbours before RANSAC")
    p.add_argument("--plot_dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:i] (the default; raises without a CUDA device) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from feat3dnet_tpu_torch.data.io import load_descriptors, load_point_cloud
    from feat3dnet_tpu_torch.eval.matching import match_descriptors, mutual_matches
    from feat3dnet_tpu_torch.eval.ransac import ransac_rigid
    from feat3dnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    xyz1, desc1 = load_descriptors(args.desc1, args.feature_dim)
    xyz2, desc2 = load_descriptors(args.desc2, args.feature_dim)
    d1 = torch.from_numpy(desc1.copy()).to(device)
    d2 = torch.from_numpy(desc2.copy()).to(device)

    idx, _ = match_descriptors(d1, d2)
    idx = idx.cpu().numpy()
    valid = mutual_matches(d1, d2) if args.mutual else None

    src = torch.from_numpy(xyz2.copy()).to(device)      # points in cloud-2 frame
    dst = torch.from_numpy(xyz1[idx]).to(device)        # their matches in cloud-1 frame
    gen = torch.Generator(device=device).manual_seed(args.seed)
    transform, inliers, count = ransac_rigid(
        gen, src, dst, inlier_threshold=args.inlier_threshold,
        num_hypotheses=args.num_hypotheses, valid=valid)

    result = {
        "num_matches": int(idx.shape[0]),
        "num_inliers": int(count),
        "rotation": transform.rotation.cpu().numpy().tolist(),
        "translation": transform.translation.cpu().numpy().tolist(),
    }
    print(json.dumps(result, indent=2))

    if args.plot_dir:
        from feat3dnet_tpu_torch.eval.visualize import plot_alignment, plot_matches

        os.makedirs(args.plot_dir, exist_ok=True)
        c1 = load_point_cloud(args.cloud1, args.data_dim) if args.cloud1 else xyz1
        c2 = load_point_cloud(args.cloud2, args.data_dim) if args.cloud2 else xyz2
        plot_matches(c1, xyz1, c2, xyz2, idx, inliers.cpu().numpy(),
                     out_path=os.path.join(args.plot_dir, "matches.png"))
        plot_alignment(c1, c2, transform.rotation.cpu().numpy(),
                       transform.translation.cpu().numpy(),
                       out_path=os.path.join(args.plot_dir, "alignment.png"))
    return result


if __name__ == "__main__":
    main()
