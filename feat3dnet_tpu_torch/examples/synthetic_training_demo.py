"""Synthetic end-to-end training demo on the port (counterpart of
examples/synthetic_training_demo.py): weakly supervised descriptor
learning with a measurable FPR@95, no external dataset needed.

Builds P synthetic places (unions of planar patches) with V views each
(a full z-rotation, jitter and a shift: the nuisances the detector and
descriptor must become invariant to) in the reference layout
(train/train.txt and labelled cluster pairs in clusters/), byte-equal to
the JAX example's from RandomState(0); trains through the port's
cli.train, prints the loss and FPR@95 trajectories and writes them to
--out (default feat3dnet_tpu_torch/examples/results/
synthetic_training_demo.json). The dataset and the run's directory are
temporary unless --keep_dir is given.

    python -m feat3dnet_tpu_torch.examples.synthetic_training_demo --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import numpy as np

from feat3dnet_tpu_torch.eval.heldout import make_patch_place as make_place
from feat3dnet_tpu_torch.examples import RESULTS_DIR


def make_view(rng, place):
    theta = rng.rand() * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    view = place @ rot
    view = view + rng.randn(*view.shape).astype(np.float32) * 0.02
    view = view + (rng.rand(3).astype(np.float32) - 0.5) * 0.2
    return view


def build_dataset(root, rng, n_places=12, n_views=3, n_val_pairs=40):
    train = os.path.join(root, "train")
    clusters = os.path.join(root, "clusters")
    os.makedirs(train), os.makedirs(clusters)

    places = [make_place(rng) for _ in range(n_places)]
    lines = []
    idx = 0
    ids_by_place = []
    for place in places:
        ids = []
        for _ in range(n_views):
            view = make_view(rng, place)
            cloud6 = np.concatenate([view, np.zeros_like(view)], axis=1)
            cloud6.astype(np.float32).tofile(os.path.join(train, f"{idx}.bin"))
            ids.append(idx)
            idx += 1
        ids_by_place.append(ids)
    for ids in ids_by_place:
        for i in ids:
            pos = " ".join(str(j) for j in ids)
            lines.append(f"{i}.bin | {pos} | {pos}")
    with open(os.path.join(train, "train.txt"), "w") as f:
        f.write("\n".join(lines))

    # validation cluster pairs: crops of 4 m around a random point
    vlines = ["idx label"]
    for k in range(n_val_pairs):
        label = k % 2
        pa = rng.randint(n_places)
        place = places[pa]
        center = place[rng.randint(place.shape[0])]
        crop = place[np.linalg.norm(place - center, axis=1) < 4.0] - center
        v0 = make_view(rng, crop)
        if label:
            v1 = make_view(rng, crop)
        else:
            pb = (pa + 1 + rng.randint(n_places - 1)) % n_places
            other = places[pb]
            c2 = other[rng.randint(other.shape[0])]
            v1 = make_view(rng, other[np.linalg.norm(other - c2, axis=1) < 4.0] - c2)
        for name, v in ((f"{k}_0.bin", v0), (f"{k}_1.bin", v1)):
            c6 = np.concatenate([v, np.zeros_like(v)], axis=1)
            c6.astype(np.float32).tofile(os.path.join(clusters, name))
        vlines.append(f"{k} {label}")
    with open(os.path.join(clusters, "filenames.txt"), "w") as f:
        f.write("\n".join(vlines))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Synthetic training demo (port)")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--keep_dir", default=None,
                   help="dataset and the run (<keep_dir>/run) here, kept")
    p.add_argument("--out", default=os.path.join(RESULTS_DIR, "synthetic_training_demo.json"))
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from feat3dnet_tpu_torch.cli.train import main as train_main
    from feat3dnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    root = args.keep_dir or tempfile.mkdtemp(prefix="f3d_synth_")
    log_dir = os.path.join(root, "run")
    try:
        build_dataset(root, np.random.RandomState(0))
        print(f"dataset at {root}")
        train_main([
            "--data_dir", root, "--log_dir", log_dir,
            "--num_points", str(args.num_points),
            "--num_clusters", "128", "--num_samples", "32",
            "--batch_size", "4", "--learning_rate", str(args.learning_rate),
            "--num_epochs", str(args.epochs),
            "--validate_every_n_steps", "9", "--summary_every_n_steps", "3",
            "--checkpoint_every_n_steps", "500",
            "--augmentation", "Jitter", "RotateSmall", "Shift", "Rotate1D",
            "--device", str(device),
        ])
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    finally:
        if not args.keep_dir:
            shutil.rmtree(root, ignore_errors=True)
    losses = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    fprs = [(r["step"], r["fp_rate"]) for r in rows if "fp_rate" in r]
    print("\nloss trajectory:", [f"{s}:{v:.4f}" for s, v in losses])
    print("FPR@95 trajectory:", [f"{s}:{v:.3f}" for s, v in fprs])
    if len(fprs) >= 2:
        print(f"\nFPR@95: {fprs[0][1]:.3f} -> {fprs[-1][1]:.3f}")
    out = {"device": str(device), "losses": losses, "fp_rates": fprs}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
