"""Inference CLI of the port (flags of feat3dnet_tpu/cli/infer.py).

    python -m feat3dnet_tpu_torch.cli.infer \\
        --data_dir examples/data --output_dir out \\
        --variables feat3dnet_tpu_torch/assets/ckpt4480_variables.npz --device cuda

--variables is a flat npz of the flax variable tree (utils/convert.py;
the trained checkpoint ships as assets/ckpt4480_variables.npz) and takes
the place of the JAX CLI's Orbax --checkpoint, which needs the JAX package
and is refused here. --tf1_checkpoint restores a TF1 export of the
reference's weights into the seeded init (utils/tf1_loader.py; names the
model lacks are skipped). --device cuda raises when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract keypoints + descriptors (PyTorch port)")
    p.add_argument("--model", type=str, default="3DFeatNet")
    p.add_argument("--data_dim", type=int, default=6)
    p.add_argument("--num_points", type=int, default=-1)
    p.add_argument("--base_scale", type=float, default=2.0)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--feature_dim", type=int, default=32, choices=[16, 32, 64, 128])
    p.add_argument("--use_keypoints_from", default=None)
    p.add_argument("--randomize_points", action="store_true")
    p.add_argument("--nms_radius", type=float, default=0.5)
    p.add_argument("--min_response_ratio", type=float, default=1e-2)
    p.add_argument("--max_keypoints", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=1,
                   help="clouds packed per device dispatch (extract_batch; "
                        "per-cloud results are bit-equal to batch_size=1)")
    p.add_argument("--use_fused_detector", action="store_true",
                   help="attention pass through the detector-only kernel and "
                        "descriptors through the fused describe kernel")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Orbax checkpoint dir: needs the JAX package; use --variables")
    p.add_argument("--tf1_checkpoint", type=str, default=None, help="TF1 npz export")
    p.add_argument("--variables", type=str, default=None,
                   help="flat npz of the flax variable tree (utils/convert.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:i] (the default; raises without a CUDA device) or cpu")
    p.add_argument("--output_dir", type=str, required=True)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import get_network
    from feat3dnet_tpu_torch.utils import init_variables, load_variables_npz
    from feat3dnet_tpu_torch.utils.device import resolve_device

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("feat3dnet_tpu_torch.infer")
    logger.info("Arguments: %s", vars(args))
    if args.checkpoint:
        raise SystemExit("--checkpoint needs the JAX package; export the variables to npz "
                         "and pass --variables")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    mcfg = ModelConfig(num_clusters=-1, base_scale=args.base_scale,
                       num_samples=args.num_samples, feature_dim=args.feature_dim)
    icfg = InferenceConfig(nms_radius=args.nms_radius,
                           min_response_ratio=args.min_response_ratio,
                           max_keypoints=args.max_keypoints,
                           num_points=args.num_points,
                           randomize_points=args.randomize_points,
                           use_fused_detector=args.use_fused_detector)
    if args.tf1_checkpoint:
        from feat3dnet_tpu_torch.utils.tf1_loader import (load_tf1_arrays,
                                                          restore_tf1_variables)
        variables, restored, skipped = restore_tf1_variables(
            init_variables(mcfg, seed=0), load_tf1_arrays(args.tf1_checkpoint),
            ignore_missing=True)
        logger.info("TF1 restore: %d restored, %d skipped", len(restored), len(skipped))
    elif args.variables:
        variables = load_variables_npz(args.variables)
    else:
        logger.warning("No --variables given: running with a seeded random init")
        variables = init_variables(mcfg, seed=0)
    model = get_network(args.model)(mcfg)
    pipe = InferencePipeline(model, variables, mcfg, icfg, device=device)
    n = pipe.process_directory(args.data_dir, args.output_dir, data_dim=args.data_dim,
                               keypoints_dir=args.use_keypoints_from, log=logger.info,
                               batch_size=args.batch_size)
    logger.info("Done: %d files on %s", n, device)


if __name__ == "__main__":
    main()
