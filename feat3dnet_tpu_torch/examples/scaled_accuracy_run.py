"""Scaled end-to-end accuracy run on the port (counterpart of
examples/scaled_accuracy_run.py).

Builds the structured synthetic dataset of the JAX example in the
reference layout (240 places x 4 views, validation and held-out cluster
pairs, 24 held-out registration pairs; byte for byte, from
RandomState(0)), trains the real two-stage recipe through the port's
cli.train (stage 1 descriptor-only with Jitter, RotateSmall and Shift;
stage 2 from stage 1 minus `detection`, adding Rotate1D), then evaluates
the stage-2 weights on the held-out places:

  * FPR@95 on the held-out cluster pairs (ClusterPairValidator);
  * fig4 precision@1m and RANSAC registration with the default
    InferenceConfig and at the two matched budgets (1 024 keypoints, no
    ratio gate, NMS 0.2 and 0.15 m; eval/heldout.evaluate_setting);
  * the handcrafted baseline on the same pairs (handcrafted_baseline.py).

Writes to --results_dir (default feat3dnet_tpu_torch/examples/results/
scaled_accuracy): summary.json (the JAX example's sections, plus
`keypoints_per_cloud` per setting, `device` (nvidia-smi's name and power
limit), `route`, `seed`, `train_s`, `ms_per_step`, `peak_gib`,
`launches` (each kernel's launches in training and in evaluation) and
`limits`), metrics_stage1.jsonl, metrics_stage2.jsonl and the stage-2
weights as variables.npz (utils/convert.py's flat layout).

    python -m feat3dnet_tpu_torch.examples.scaled_accuracy_run --device cuda
    python -m feat3dnet_tpu_torch.examples.scaled_accuracy_run --fused_towers --seed 1 \\
        --results_dir out/fused_seed1
    python -m feat3dnet_tpu_torch.examples.scaled_accuracy_run --eval_only \\
        --variables out/fused_seed1/variables.npz        # evaluation alone
    python -m feat3dnet_tpu_torch.examples.scaled_accuracy_run --places 48 \\
        --stage1_epochs 1 --stage2_epochs 4              # smoke size
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

from feat3dnet_tpu_torch.eval.heldout import _write6, make_place, se3_view
from feat3dnet_tpu_torch.eval.heldout import write_cluster_pairs as _cluster_pairs
from feat3dnet_tpu_torch.examples import RESULTS_DIR

# the matched-budget settings: the handcrafted baseline's full 1 024
# keypoints, no ratio gate, two NMS radii
MATCHED_BUDGET = {"kp1024_ratio0_nms02": dict(min_response_ratio=0.0, nms_radius=0.2),
                  "kp1024_ratio0_nms015": dict(min_response_ratio=0.0, nms_radius=0.15)}

# the limits a run at the default size is held to (the JAX record: ckpt/4480's
# kp1024_ratio0_nms02 in examples/results/scaled_accuracy/inference_sweep.json)
LIMITS = {"heldout_fpr95_max": 0.10, "precision_min": 87.19827410754264 - 2.0,
          "keypoints_min": 1023.8125 * 0.99, "registrations_min": 20,
          "stage2_fpr95_max": 0.10, "stage2_fpr95_by_step": 3000}

# the kernel wrappers whose launches the summary counts (name: module, attribute)
KERNELS = {"fps": ("fps", "farthest_point_sample"),
           "ball_query": ("batch_group", "ball_query_fused"),
           "train_stats": ("fused_train", "stats_pass"),
           "train_final": ("fused_train", "final_pass"),
           "train_bwd_top": ("fused_train", "bwd_top_pass"),
           "train_bwd": ("fused_train", "bwd_pass"),
           "sorted_ball_query": ("hash_grid", "sorted_ball_query"),
           "ball_max": ("hash_grid", "ball_max_sorted"),
           "fused_detect": ("fused_describe", "fused_detect_clusters"),
           "fused_describe": ("fused_describe", "fused_describe_clusters_t")}


def build_dataset(root, rng, n_places, n_views, n_val_pairs, n_test_pairs):
    """The JAX example's dataset, the same draws in the same order: train/
    (views + train.txt), clusters/ (validation pairs of training places),
    clusters_test/ (pairs of held-out places), test/ (registration pairs +
    groundtruths.txt, cloud_a = R cloud_b + t)."""
    train = os.path.join(root, "train")
    os.makedirs(train)
    places = [make_place(rng) for _ in range(n_places)]

    lines = []
    idx = 0
    for place in places:
        ids = []
        for _ in range(n_views):
            view, _, _ = se3_view(rng, place)
            _write6(os.path.join(train, f"{idx}.bin"), view)
            ids.append(idx)
            idx += 1
        pos = " ".join(str(j) for j in ids)
        for i in ids:
            lines.append(f"{i}.bin | {pos} | {pos}")
    with open(os.path.join(train, "train.txt"), "w") as f:
        f.write("\n".join(lines))

    # training-time validation pairs from the training places
    _cluster_pairs(os.path.join(root, "clusters"), rng, places, n_val_pairs)

    # held out: fresh places never seen in training
    test_places = [make_place(rng) for _ in range(n_test_pairs)]
    _cluster_pairs(os.path.join(root, "clusters_test"), rng, test_places, n_val_pairs)
    test = os.path.join(root, "test")
    os.makedirs(test)
    gt_lines = ["idx1 idx2 t1 t2 t3 q1 q2 q3 q4"]
    for k, place in enumerate(test_places):
        v0, _, _ = se3_view(rng, place)
        v1, theta, t = se3_view(rng, place)
        # v1 from v0's frame, so that the relative SE3 is known exactly
        c, s = np.cos(theta), np.sin(theta)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        v1 = v0 @ rz.T + t + rng.randn(*v0.shape).astype(np.float32) * 0.02
        a, b = 2 * k, 2 * k + 1
        _write6(os.path.join(test, f"{a}.bin"), v0)
        _write6(os.path.join(test, f"{b}.bin"), v1)
        # cloud_a = R cloud_b + t_gt with R = Rz(-theta), t_gt = -R t
        r_inv = rz.T
        t_gt = -r_inv @ t
        q = np.array([np.cos(-theta / 2), 0.0, 0.0, np.sin(-theta / 2)])
        gt_lines.append(
            f"{a} {b} {t_gt[0]:.6f} {t_gt[1]:.6f} {t_gt[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    with open(os.path.join(test, "groundtruths.txt"), "w") as f:
        f.write("\n".join(gt_lines))
    return root


def launch_counts():
    """{kernel: its wrapper's launch count} (CUDA launches only)."""
    import importlib

    return {name: getattr(importlib.import_module(f"feat3dnet_tpu_torch.ops.{mod}"),
                          attr).launches
            for name, (mod, attr) in KERNELS.items()}


def launches_since(before):
    return {k: n - before[k] for k, n in launch_counts().items()}


def card_name(device) -> str:
    """nvidia-smi's `name, power.limit` of the card, or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index or 0)], capture_output=True, text=True,
        check=True).stdout.strip()


def metrics_rows(path):
    """The rows of a metrics.jsonl ([] when the run wrote none)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def ms_per_step(rows):
    """Median host ms a step between consecutive loss rows."""
    loss = [r for r in rows if "loss" in r]
    gaps = [(b["ts"] - a["ts"]) * 1e3 / (b["step"] - a["step"])
            for a, b in zip(loss, loss[1:]) if b["step"] > a["step"]]
    return float(np.median(gaps)) if gaps else None


def limit_report(summary, stage2_rows):
    """Each limit of LIMITS against the run: {name: {value, limit, ok}}."""
    mb = summary["matched_budget"]["kp1024_ratio0_nms02"]
    reg = mb["registration"]
    early = [r["fp_rate"] for r in stage2_rows
             if "fp_rate" in r and r["step"] <= LIMITS["stage2_fpr95_by_step"]]
    best = min(early) if early else None
    checks = {
        "heldout_fpr95": (summary["heldout_fpr95"], f"<= {LIMITS['heldout_fpr95_max']}",
                          summary["heldout_fpr95"] <= LIMITS["heldout_fpr95_max"]),
        "precision_at_1m": (mb["fig4"]["precision_at_1m"], f">= {LIMITS['precision_min']}",
                            mb["fig4"]["precision_at_1m"] >= LIMITS["precision_min"]),
        "keypoints_per_cloud": (mb["keypoints_per_cloud"], f">= {LIMITS['keypoints_min']}",
                                mb["keypoints_per_cloud"] >= LIMITS["keypoints_min"]),
        "registrations": (round(reg["success_rate"] * reg["n_pairs"]),
                          f">= {LIMITS['registrations_min']}",
                          round(reg["success_rate"] * reg["n_pairs"])
                          >= LIMITS["registrations_min"]),
        "stage2_min_fpr95_by_3000": (best, f"<= {LIMITS['stage2_fpr95_max']}",
                                     best is not None and best <= LIMITS["stage2_fpr95_max"]),
    }
    return {k: {"value": v, "limit": lim, "ok": bool(ok)} for k, (v, lim, ok) in checks.items()}


def host_variables(tree):
    """A variable tree of tensors as numpy arrays."""
    return {k: host_variables(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def finite(tree) -> bool:
    """Every number in a summary tree is finite (None counts as not)."""
    if isinstance(tree, dict):
        return all(finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite(v) for v in tree)
    if isinstance(tree, bool) or isinstance(tree, str):
        return True
    return tree is not None and math.isfinite(tree)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Two-stage recipe + held-out accuracy (port)")
    p.add_argument("--places", type=int, default=240)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--val_pairs", type=int, default=96)
    p.add_argument("--test_pairs", type=int, default=24)
    p.add_argument("--stage1_epochs", type=int, default=4)
    p.add_argument("--stage2_epochs", type=int, default=24)
    p.add_argument("--num_points", type=int, default=4096)
    p.add_argument("--num_clusters", type=int, default=256)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--keep_dir", default=None,
                   help="dataset and runs here (kept); default a temporary directory")
    p.add_argument("--eval_only", action="store_true",
                   help="no training: evaluate --variables (or --keep_dir's stage-2 "
                        "checkpoint)")
    p.add_argument("--variables", default=None,
                   help="with --eval_only: a variables npz to evaluate")
    p.add_argument("--results_dir", default=os.path.join(RESULTS_DIR, "scaled_accuracy"))
    p.add_argument("--seed", type=int, default=0,
                   help="cli.train's seed (init, shuffling, augmentation); the dataset "
                        "is always RandomState(0)'s")
    p.add_argument("--init_variables", default=None,
                   help="stage 1 starts from this variables npz (e.g. the JAX CLI's "
                        "initial weights, scripts/export_jax_train_state.py --init_seed) "
                        "and stage 2 restores all of stage 1: stage 1 trains no "
                        "`detection` parameter, so the detector keeps the npz's initial "
                        "weights (its BN statistics are stage 1's running averages)")
    p.add_argument("--fused_towers", action="store_true",
                   help="train through the fused tower kernels (K7-K10)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    return p


def train_recipe(args, root, device):
    """Both stages through cli.train; returns stage 2's final TrainState."""
    from feat3dnet_tpu_torch.cli.train import main as train_main

    spe = args.places * args.views // args.batch_size
    total = spe * (args.stage1_epochs + args.stage2_epochs)
    common = [
        "--data_dir", root, "--num_points", str(args.num_points),
        "--num_clusters", str(args.num_clusters),
        "--num_samples", str(args.num_samples),
        "--batch_size", str(args.batch_size),
        "--learning_rate", str(args.learning_rate),
        "--validate_every_n_steps", "100",
        "--summary_every_n_steps", "20",
        "--checkpoint_every_n_steps", "500",
        "--seed", str(args.seed), "--device", str(device),
    ]
    if args.fused_towers:
        common.append("--fused_towers")
    if args.lr_schedule != "constant":
        # one schedule across both stages: stage 2 resumes the restored count
        common += ["--lr_schedule", args.lr_schedule,
                   "--warmup_steps", str(args.warmup_steps),
                   "--decay_steps", str(total)]
    s1, s2 = os.path.join(root, "run_stage1"), os.path.join(root, "run_stage2")
    init = ["--variables", args.init_variables] if args.init_variables else []
    # stage 1: descriptor only, rotation-free augmentations (reference train.sh:8-13)
    train_main(common + init + [
        "--log_dir", s1, "--noattention", "--noregress",
        "--augmentation", "Jitter", "RotateSmall", "Shift",
        "--num_epochs", str(args.stage1_epochs)])
    # stage 2: the full model from stage 1 minus `detection`, adding Rotate1D
    exclude = [] if args.init_variables else ["--restore_exclude", "detection"]
    return train_main(common + exclude + [
        "--log_dir", s2, "--checkpoint", s1,
        "--augmentation", "Jitter", "RotateSmall", "Shift", "Rotate1D",
        "--num_epochs", str(args.stage2_epochs)])


def evaluate(variables, cfg, root, device, log=lambda *_: None):
    """The held-out evaluation of `variables`: the summary's sections."""
    from feat3dnet_tpu_torch.config import InferenceConfig
    from feat3dnet_tpu_torch.eval.heldout import evaluate_setting
    from feat3dnet_tpu_torch.eval.validate import ClusterPairValidator
    from feat3dnet_tpu_torch.examples.handcrafted_baseline import (HandcraftedExtractor,
                                                                   evaluate_baseline)
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.utils import load_variables

    summary = {}
    model = load_variables(Feat3DNet(cfg), variables).to(device).eval()
    val = ClusterPairValidator(model, cfg, os.path.join(root, "clusters_test"), device=device)
    summary["heldout_fpr95"] = float(val())
    print(f"held-out FPR@95: {summary['heldout_fpr95']:.4f}", flush=True)

    test_dir = os.path.join(root, "test")
    pipe = InferencePipeline(Feat3DNet(cfg), variables, cfg, InferenceConfig(), device=device)
    entry = evaluate_setting(pipe, test_dir, os.path.join(root, "test_results"), log=log)
    summary.update(entry)
    print("default", json.dumps(entry), flush=True)

    summary["matched_budget"] = {}
    for name, icfg in MATCHED_BUDGET.items():
        mpipe = InferencePipeline(Feat3DNet(cfg), variables, cfg, InferenceConfig(**icfg),
                                  device=device)
        entry = evaluate_setting(mpipe, test_dir, os.path.join(root, f"test_results_{name}"),
                                 log=log)
        summary["matched_budget"][name] = entry
        print(name, json.dumps(entry), flush=True)

    summary["handcrafted_baseline"] = evaluate_baseline(
        HandcraftedExtractor(max_keypoints=1024, device=device), test_dir, root, log=log)
    print("handcrafted_baseline", json.dumps(summary["handcrafted_baseline"]), flush=True)
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from feat3dnet_tpu_torch.config import ModelConfig
    from feat3dnet_tpu_torch.utils import (load_variables_npz, save_variables_npz,
                                           variables_from_module)
    from feat3dnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = args.keep_dir or tempfile.mkdtemp(prefix="f3d_scaled_")
    summary = {"device": card_name(device), "route": "fused" if args.fused_towers
               else "autograd", "seed": args.seed}
    if args.init_variables:
        summary["init_variables"] = os.path.basename(args.init_variables)
    try:
        if not os.path.isdir(os.path.join(root, "train")):
            print("building dataset...", flush=True)
            build_dataset(root, np.random.RandomState(0), args.places, args.views,
                          args.val_pairs, args.test_pairs)
            print(f"dataset at {root}: {args.places} places x {args.views} views", flush=True)
        s1, s2 = os.path.join(root, "run_stage1"), os.path.join(root, "run_stage2")
        cfg = ModelConfig(num_clusters=args.num_clusters, num_samples=args.num_samples)
        launches = {}
        if args.eval_only:
            if args.variables:
                variables = load_variables_npz(args.variables)
                summary["variables"] = os.path.basename(args.variables)
            else:
                from feat3dnet_tpu_torch.utils.checkpoint import CheckpointManager

                step = CheckpointManager(os.path.join(s2, "ckpt")).latest_step()
                ckpt = torch.load(os.path.join(s2, "ckpt", f"ckpt_{step}.pt"),
                                  map_location="cpu", weights_only=True)
                variables = host_variables(ckpt["variables"])
                summary["final_step"] = int(ckpt["step"])
        else:
            if cuda:
                torch.cuda.init()
                torch.cuda.reset_peak_memory_stats(device)
            before = launch_counts()
            t0 = time.perf_counter()
            state = train_recipe(args, root, device)
            if cuda:
                torch.cuda.synchronize(device)
                summary["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
            summary["train_s"] = time.perf_counter() - t0
            launches["train"] = launches_since(before)
            summary["final_step"] = int(state.step)
            summary["final_count"] = int(state.count)
            variables = host_variables(variables_from_module(state.model))
            del state
            summary["ms_per_step"] = {
                stage: ms_per_step(metrics_rows(os.path.join(d, "metrics.jsonl")))
                for stage, d in (("stage1", s1), ("stage2", s2))}
            print(f"trained {summary['final_step']} steps in {summary['train_s']:.1f} s "
                  f"({summary['ms_per_step']} ms a step)", flush=True)

        before = launch_counts()
        summary.update(evaluate(variables, cfg, root, device))
        launches["eval"] = launches_since(before)
        summary["launches"] = launches

        os.makedirs(args.results_dir, exist_ok=True)
        stage2_rows = []
        if not args.eval_only:
            for stage, d in (("stage1", s1), ("stage2", s2)):
                src = os.path.join(d, "metrics.jsonl")
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(args.results_dir, f"metrics_{stage}.jsonl"))
            stage2_rows = metrics_rows(os.path.join(s2, "metrics.jsonl"))
            save_variables_npz(os.path.join(args.results_dir, "variables.npz"), variables)
        summary["limits"] = limit_report(summary, stage2_rows)
        with open(os.path.join(args.results_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(json.dumps(summary, indent=2), flush=True)
        return summary
    finally:
        if not args.keep_dir:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
