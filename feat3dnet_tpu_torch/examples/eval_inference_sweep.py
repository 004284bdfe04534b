"""Inference-setting sweep on a trained model, on the port (counterpart of
examples/eval_inference_sweep.py).

Evaluates one set of weights (a variables npz; default the shipped
ckpt/4480 export, feat3dnet_tpu_torch/assets/ckpt4480_variables.npz) on
the held-out pairs of the scaled-accuracy dataset (eval/heldout.
build_test_set, byte-equal to the JAX split) under six InferenceConfig
settings: the default ratio gate, then the handcrafted baseline's 1 024
keypoint budget without it at NMS radii 0.5, 0.25, 0.2 and 0.15 m, and the
gate at 0.25 m. Each setting runs the whole protocol
(eval/heldout.evaluate_setting: process_directory, fig4, keypoints per
cloud, registration) and the results go to --out (default
feat3dnet_tpu_torch/examples/results/scaled_accuracy/inference_sweep.json),
written after every setting.

--record <json> holds each setting to a recorded sweep (the JAX one is
examples/results/scaled_accuracy/inference_sweep.json): precision@1m within
1.0 point, total putative and keypoints per cloud within 1 %, registrations
at least the record's less 2 (RANSAC draws from a torch generator, not
JAX's PRNGKey(0)); the run fails when a setting misses.

    python -m feat3dnet_tpu_torch.examples.eval_inference_sweep --device cuda \\
        --record examples/results/scaled_accuracy/inference_sweep.json
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

from feat3dnet_tpu_torch.examples import RESULTS_DIR

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                     "ckpt4480_variables.npz")

# name: InferenceConfig arguments
SETTINGS = {
    # the recorded run's protocol (the ratio gate prunes to ~150 keypoints)
    "default": {},
    # the handcrafted baseline's budget of 1 024 keypoints, no ratio gate
    "kp1024_ratio0": dict(min_response_ratio=0.0),
    # denser NMS on the open budget
    "kp1024_ratio0_nms025": dict(min_response_ratio=0.0, nms_radius=0.25),
    "kp1024_ratio0_nms02": dict(min_response_ratio=0.0, nms_radius=0.2),
    "kp1024_ratio0_nms015": dict(min_response_ratio=0.0, nms_radius=0.15),
    # the default ratio gate at a dense NMS
    "kp1024_ratio001_nms025": dict(nms_radius=0.25),
}

# the limits of --record (chip_smoke phase 18's)
PRECISION_POINTS, PUTATIVE_SHARE, KEYPOINT_SHARE, REGISTRATIONS_LESS = 1.0, 0.01, 0.01, 2


def registrations(entry) -> int:
    reg = entry["registration"]
    return round(reg["success_rate"] * reg["n_pairs"])


def misses(entry, record) -> list:
    """What of one setting's entry falls outside the limits of `record`'s."""
    out = []
    p, rp = entry["fig4"]["precision_at_1m"], record["fig4"]["precision_at_1m"]
    if abs(p - rp) > PRECISION_POINTS:
        out.append(f"precision@1m {p:.4f} vs {rp:.4f} +- {PRECISION_POINTS}")
    n, rn = entry["fig4"]["total_putative"], record["fig4"]["total_putative"]
    if abs(n - rn) > PUTATIVE_SHARE * rn:
        out.append(f"total putative {n:.0f} vs {rn:.0f} +- 1 %")
    k, rk = entry["keypoints_per_cloud"], record["keypoints_per_cloud"]
    if abs(k - rk) > KEYPOINT_SHARE * rk:
        out.append(f"keypoints per cloud {k:.4f} vs {rk:.4f} +- 1 %")
    if registrations(entry) < registrations(record) - REGISTRATIONS_LESS:
        out.append(f"registrations {registrations(entry)} < {registrations(record)} - "
                   f"{REGISTRATIONS_LESS}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Inference-setting sweep on the held-out pairs")
    p.add_argument("--test_pairs", type=int, default=24)
    p.add_argument("--variables", default=ASSET, help="variables npz (utils/convert.py)")
    p.add_argument("--use_fused_detector", action="store_true",
                   help="extract through K6 + K3 (the fused route)")
    p.add_argument("--out", default=os.path.join(RESULTS_DIR, "scaled_accuracy",
                                                 "inference_sweep.json"))
    p.add_argument("--record", default=None,
                   help="a recorded sweep to hold every setting to (fails on a miss)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
    from feat3dnet_tpu_torch.eval.heldout import build_test_set, evaluate_setting
    from feat3dnet_tpu_torch.examples.scaled_accuracy_run import card_name
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.utils import load_variables_npz
    from feat3dnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = None
    if args.record:
        with open(args.record) as f:
            record = json.load(f)
    cfg = ModelConfig(num_clusters=256, num_samples=64)
    variables = load_variables_npz(args.variables)
    results = {"variables": os.path.basename(args.variables), "device": card_name(device),
               "route": "fused" if args.use_fused_detector else "default"}
    failed = {}
    root = tempfile.mkdtemp(prefix="f3d_evalsweep_")
    try:
        print("rebuilding the held-out pairs...", flush=True)
        test_dir = build_test_set(root, args.test_pairs)
        for name in SETTINGS:
            icfg = InferenceConfig(use_fused_detector=args.use_fused_detector,
                                   **SETTINGS[name])
            pipe = InferencePipeline(Feat3DNet(cfg), variables, cfg, icfg, device=device)
            entry = evaluate_setting(pipe, test_dir, os.path.join(root, f"results_{name}"))
            results[name] = entry
            print(name, json.dumps(entry), flush=True)
            if record is not None:
                miss = misses(entry, record[name])
                print(f"{name} against the record: {'; '.join(miss) or 'within the limits'}",
                      flush=True)
                if miss:
                    failed[name] = miss
            # written after every setting: a crash later keeps what finished
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise SystemExit(f"settings outside the record's limits: {failed}")
    return results


if __name__ == "__main__":
    main()
