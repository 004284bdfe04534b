"""Non-learned baseline of the scaled accuracy run, on the port (counterpart
of examples/handcrafted_baseline.py).

A handcrafted pipeline through the same held-out protocol as the learned
model: farthest-point-sampled keypoints (numpy, the learned pipeline's
1 024 budget) and a 24-D z-rotation-invariant descriptor of each radius-2 m
neighbourhood (PCA shape features, normal verticality, density, an 8-bin
relative-height and an 8-bin horizontal-radius histogram, L2-normalised),
scored by the port's fig4 and registered by its matching and RANSAC
(eval/heldout.py). The extractor is numpy and equals the JAX example's
bit for bit; matching and RANSAC run on `--device`.

`main` evaluates on eval/heldout.build_test_set (the held-out split of the
default dataset, byte-equal to the JAX one, without the 960 training
clouds) and writes a `handcrafted_baseline` section into the port's
summary (default feat3dnet_tpu_torch/examples/results/scaled_accuracy/
summary.json).

    python -m feat3dnet_tpu_torch.examples.handcrafted_baseline --device cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np

from feat3dnet_tpu_torch.examples import RESULTS_DIR


def fps_numpy(xyz: np.ndarray, k: int, seed_idx: int = 0) -> np.ndarray:
    """Plain numpy farthest-point sampling (host baseline, no model)."""
    n = xyz.shape[0]
    k = min(k, n)
    idx = np.empty(k, np.int64)
    idx[0] = seed_idx
    d = np.sum((xyz - xyz[seed_idx]) ** 2, axis=1)
    for i in range(1, k):
        idx[i] = int(np.argmax(d))
        d = np.minimum(d, np.sum((xyz - xyz[idx[i]]) ** 2, axis=1))
    return idx


def handcrafted_descriptor(neigh: np.ndarray, radius: float) -> np.ndarray:
    """24-D z-rotation-invariant local descriptor of a centred neighbourhood
    (m, 3). Zeros for degenerate (< 4 point) balls."""
    out = np.zeros(24, np.float32)
    m = neigh.shape[0]
    if m >= 4:
        cov = np.cov(neigh.T)
        w, v = np.linalg.eigh(cov)            # ascending
        w = np.maximum(w[::-1], 1e-12)        # l1 >= l2 >= l3
        e3 = v[:, 0]                          # smallest-eigenvalue direction
        s = w.sum()
        out[0] = (w[0] - w[1]) / w[0]         # linearity
        out[1] = (w[1] - w[2]) / w[0]         # planarity
        out[2] = w[2] / w[0]                  # sphericity
        out[3] = abs(e3[2])                   # normal verticality
        out[4] = np.sqrt(w[0] / s)
        out[5] = np.sqrt(w[2] / s)
        out[6] = np.log1p(float(m)) / 8.0     # density
        zs = neigh[:, 2]
        hh, _ = np.histogram(zs, bins=8, range=(-radius, radius))
        out[7:15] = hh / m
        rr = np.linalg.norm(neigh[:, :2], axis=1)
        rh, _ = np.histogram(rr, bins=8, range=(0.0, radius))
        out[15:23] = rh / m
        out[23] = float(np.std(zs)) / radius
    nrm = np.linalg.norm(out)
    return out / nrm if nrm > 1e-8 else out


@dataclasses.dataclass
class BaselineResult:
    keypoints: np.ndarray
    features: np.ndarray
    attention: np.ndarray
    num_keypoints: int


class HandcraftedExtractor:
    """InferencePipeline.extract's interface for the baseline. `device` is
    where eval/heldout.evaluate_registration matches and runs RANSAC (`cuda`
    unless the caller names another); the extraction itself is numpy."""

    def __init__(self, max_keypoints: int = 1024, radius: float = 2.0, device=None):
        from feat3dnet_tpu_torch.utils.device import resolve_device

        self.max_keypoints = max_keypoints
        self.radius = radius
        self.device = resolve_device(device)

    def extract(self, cloud: np.ndarray) -> BaselineResult:
        xyz = np.asarray(cloud[:, :3], np.float32)
        # the two views of a pair keep their point order (se3_view), so FPS
        # from a fixed index would pick corresponding points in both: permute
        # first, from the cloud's contents, so that repeated calls agree
        seed = int(np.abs(xyz[:16]).sum() * 1e3) % (2 ** 31)
        xyz = xyz[np.random.RandomState(seed).permutation(xyz.shape[0])]
        idx = fps_numpy(xyz, self.max_keypoints)
        kp = xyz[idx]
        descs = np.empty((kp.shape[0], 24), np.float32)
        for i, c in enumerate(kp):
            d2 = np.sum((xyz - c) ** 2, axis=1)
            neigh = xyz[d2 < self.radius ** 2] - c
            descs[i] = handcrafted_descriptor(neigh, self.radius)
        return BaselineResult(keypoints=kp, features=descs,
                              attention=np.ones(kp.shape[0], np.float32),
                              num_keypoints=kp.shape[0])


def _extract_file(job):
    """(keypoints, features) of the cloud file `path` (a worker's job)."""
    max_keypoints, radius, path = job
    from feat3dnet_tpu_torch.data.io import load_point_cloud

    ext = HandcraftedExtractor(max_keypoints, radius, device="cpu")
    res = ext.extract(load_point_cloud(path, 6))
    return res.keypoints, res.features


def evaluate_baseline(ext: HandcraftedExtractor, test_dir: str, work_dir: str,
                      log=lambda *_: None) -> dict:
    """The baseline through the held-out protocol on test_dir (clouds +
    groundtruths.txt): descriptors written under work_dir, fig4 over the
    pairs, registration on those files; returns the summary section. The
    clouds are extracted in spawned processes, one a CPU core (at most 8;
    in this process on one core): each cloud's result depends on the cloud
    alone."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from feat3dnet_tpu_torch.data.io import save_descriptors
    from feat3dnet_tpu_torch.eval.fig4 import evaluate_dataset
    from feat3dnet_tpu_torch.eval.heldout import evaluate_registration

    result_dir = os.path.join(work_dir, "baseline_results")
    os.makedirs(result_dir, exist_ok=True)
    bins = sorted(f for f in os.listdir(test_dir) if f.endswith(".bin"))
    jobs = [(ext.max_keypoints, ext.radius, os.path.join(test_dir, f)) for f in bins]
    workers = min(8, os.cpu_count() or 1, len(jobs))
    if workers > 1:
        with ProcessPoolExecutor(workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            results = list(pool.map(_extract_file, jobs))
    else:
        results = [_extract_file(job) for job in jobs]
    for i, (fname, (kp, feats)) in enumerate(zip(bins, results)):
        save_descriptors(os.path.join(result_dir, fname), kp, feats)
        log(f"baseline {i + 1}/{len(bins)}: {fname}")
    _, agg = evaluate_dataset(test_dir, result_dir, feature_dim=24, log=log,
                              device=ext.device)
    out = {"fig4": {k: float(v) for k, v in agg.items()}}
    evaluate_registration(ext, test_dir, out, result_dir=result_dir, feature_dim=24)
    out["descriptor"] = "PCA shape + height/radius histograms (24-D)"
    out["keypoints"] = f"FPS {ext.max_keypoints}"
    return out


def merge_section(results_dir: str, name: str, section: dict) -> str:
    """Write `section` as summary.json's `name` in results_dir, keeping the
    file's other sections; returns the path."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, "summary.json")
    full = {}
    if os.path.exists(path):
        with open(path) as f:
            full = json.load(f)
    full[name] = section
    with open(path, "w") as f:
        json.dump(full, f, indent=2)
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Handcrafted baseline on the held-out pairs")
    p.add_argument("--test_pairs", type=int, default=24)
    p.add_argument("--max_keypoints", type=int, default=1024)
    p.add_argument("--results_dir", default=os.path.join(RESULTS_DIR, "scaled_accuracy"))
    p.add_argument("--device", default="cuda",
                   help="where matching and RANSAC run: cuda (the default; raises "
                        "without a CUDA device) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from feat3dnet_tpu_torch.eval.heldout import build_test_set

    ext = HandcraftedExtractor(max_keypoints=args.max_keypoints, device=args.device)
    root = tempfile.mkdtemp(prefix="f3d_baseline_")
    try:
        print("rebuilding the held-out pairs (the learned run's split)...", flush=True)
        test_dir = build_test_set(root, args.test_pairs)
        summary = evaluate_baseline(ext, test_dir, root, log=lambda m: print(m, flush=True))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(summary, indent=2))
    merge_section(args.results_dir, "handcrafted_baseline", summary)
    return summary


if __name__ == "__main__":
    main()
