"""One-command TF1 descriptor-parity gate (port of
feat3dnet_tpu/cli/verify_parity.py).

    python -m feat3dnet_tpu_torch.cli.verify_parity --npz ckpt.npz \\
        [--cloud examples/data/oxford_270.bin] \\
        [--reference_output ref_out/oxford_270.bin] \\
        [--cosine_threshold 0.999] [--device cuda]

Steps:
  1. strictly restore the TF1 npz export into the model
     (utils/tf1_loader.py; export recipe in its module docstring);
  2. extract keypoints + descriptors from --cloud through
     InferencePipeline.extract and, with BN, cross-check the fused serving
     tower (K3 on the folded weights, ops/fused_describe.py) against the
     model's descriptors at the same keypoints, printing the min and
     median cosine (skipped under --no_bn: nothing to fold);
  3. if --reference_output is given (a [xyz|desc] .bin the reference's
     inference.py wrote for the same cloud), recompute the descriptors AT
     the reference's keypoints (so NMS differences cannot confound the
     comparison) and report per-keypoint cosine similarity. Exit 0 iff the
     median cosine >= --cosine_threshold.
Runs on --device (default cuda; raises without a CUDA device, cpu only
when named).
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TF1 checkpoint descriptor-parity gate")
    p.add_argument("--npz", required=True, help="TF1 checkpoint exported to .npz")
    p.add_argument("--cloud", default=None,
                   help="point cloud .bin (default: vendored oxford_270.bin)")
    p.add_argument("--data_dim", type=int, default=6)
    p.add_argument("--reference_output", default=None,
                   help="[xyz|desc] .bin the reference wrote for the same cloud")
    p.add_argument("--feature_dim", type=int, default=32, choices=[16, 32, 64, 128])
    p.add_argument("--base_scale", type=float, default=2.0)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--cosine_threshold", type=float, default=0.999)
    p.add_argument("--restore_exclude", nargs="*", default=None)
    p.add_argument("--no_bn", action="store_true",
                   help="checkpoint was trained with USE_BN=False "
                        "(reference config.py:2) — no bn/* variables")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:i] (the default; raises without a CUDA device) or cpu")
    return p


def cosine_summary(ref_desc, ours):
    """Per-row cosine of two (K, D) descriptor arrays: n, min, p5, median, mean."""
    import numpy as np

    ref_n = ref_desc / np.maximum(np.linalg.norm(ref_desc, axis=1, keepdims=True), 1e-8)
    ours_n = ours / np.maximum(np.linalg.norm(ours, axis=1, keepdims=True), 1e-8)
    cos = np.sum(ref_n * ours_n, axis=1)
    return {"n": len(cos), "min": float(cos.min()), "p5": float(np.percentile(cos, 5)),
            "median": float(np.median(cos)), "mean": float(cos.mean())}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
    from feat3dnet_tpu_torch.data.io import (example_cloud_path, load_descriptors,
                                             load_point_cloud)
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.utils.device import resolve_device
    from feat3dnet_tpu_torch.utils.init import init_variables
    from feat3dnet_tpu_torch.utils.tf1_loader import load_tf1_arrays, restore_tf1_variables

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(num_clusters=-1, feature_dim=args.feature_dim,
                      base_scale=args.base_scale, num_samples=args.num_samples,
                      use_bn=not args.no_bn)
    variables, restored, skipped = restore_tf1_variables(
        init_variables(cfg, seed=0), load_tf1_arrays(args.npz),
        restore_exclude=args.restore_exclude)
    print(f"restored {len(restored)} TF1 variables, skipped {len(skipped)} "
          f"(optimizer slots / global_step / excluded scopes)")
    model_like = [s for s in skipped
                  if not any(t in s for t in ("Adam", "beta1_power",
                                              "beta2_power", "global_step"))]
    if model_like:
        print("WARNING: skipped model-looking variables:", flush=True)
        for s in model_like:
            print(f"  {s}")

    cloud_path = args.cloud or example_cloud_path("oxford_270.bin")
    cloud = load_point_cloud(cloud_path, num_cols=args.data_dim)
    pipe = InferencePipeline(Feat3DNet(cfg), variables, cfg, InferenceConfig(), device=device)
    res = pipe.extract(cloud)
    print(f"{cloud_path}: {res.num_keypoints} keypoints, "
          f"descriptor norm mean {np.linalg.norm(res.features, axis=1).mean():.4f}")

    if cfg.use_bn:
        # internal gate: the fused serving tower (K3, BN folded) against the
        # model's descriptors at the same keypoints; a no-BN model has
        # nothing to fold and serves through the model
        from feat3dnet_tpu_torch.ops import fused_describe as fd
        from feat3dnet_tpu_torch.ops.neighborhoods import ball_query, group_points

        with torch.no_grad():
            xyz = torch.from_numpy(np.ascontiguousarray(cloud[None, :, :3])).to(device)
            kp = torch.from_numpy(np.ascontiguousarray(res.keypoints[None])).to(device)
            idx, _ = ball_query(xyz, kp, cfg.base_scale, cfg.num_samples)
            clusters = (group_points(xyz, idx) - kp[:, :, None, :])[0]
            desc_fused, _ = fd.fused_describe_clusters(fd.folded_weights(variables, cfg),
                                                       clusters, cfg)
        cos_int = np.sum(desc_fused.cpu().numpy() * res.features, axis=1)
        print(f"fused-vs-model cosine: min {cos_int.min():.6f} "
              f"median {np.median(cos_int):.6f}")

    if args.reference_output is None:
        print("no --reference_output given: checkpoint loads and runs; "
              "drop the reference inference.py output here for the full gate")
        return 0

    ref_xyz, ref_desc = load_descriptors(args.reference_output, feature_dim=args.feature_dim)
    # descriptors at the REFERENCE's keypoints — NMS cannot confound
    stats = cosine_summary(ref_desc, pipe.extract(cloud, keypoints=ref_xyz).features)
    print("descriptor cosine vs reference:", stats)
    ok = stats["median"] >= args.cosine_threshold
    print("PARITY", "PASS" if ok else "FAIL",
          f"(median {stats['median']:.6f} vs threshold {args.cosine_threshold})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
