"""FPR@95 of every checkpoint stage 2 of the recipe kept, on the scaled-accuracy
dataset's held-out cluster pairs (clusters_test/) and its training places'
pairs (clusters/): how the held-out figure of a run moves over its last
checkpoints.

    python scripts/heldout_fpr_by_checkpoint.py <data_dir> [--device cuda]

<data_dir> is a `scaled_accuracy_run --keep_dir` directory (its
run_stage2/ckpt/ckpt_<step>.pt files and the two cluster folders). Prints
one JSON line per checkpoint.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data_dir")
    p.add_argument("--num_clusters", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.eval.validate import ClusterPairValidator
    from feat3dnet_tpu_torch.examples.scaled_accuracy_run import host_variables
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.utils import load_variables
    from feat3dnet_tpu_torch.utils.checkpoint import CheckpointManager
    from feat3dnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(num_clusters=args.num_clusters, num_samples=64)
    ckpt_dir = os.path.join(args.data_dir, "run_stage2", "ckpt")
    rows = []
    for step in CheckpointManager(ckpt_dir).all_steps():
        ckpt = torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"), map_location="cpu",
                          weights_only=True)
        model = load_variables(Feat3DNet(cfg), host_variables(ckpt["variables"]))
        model = model.to(device).eval()
        row = {"step": step}
        for split in ("clusters_test", "clusters"):
            row[split] = ClusterPairValidator(model, cfg, os.path.join(args.data_dir, split),
                                              device=device)()
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
