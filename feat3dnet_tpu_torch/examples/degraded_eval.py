"""Degraded-views evaluation on the port, learned against handcrafted
(counterpart of examples/degraded_eval.py).

The clean held-out pairs give both views the same points up to SE3 and
0.02 m jitter, the easiest case for a geometric descriptor. This rebuilds
pairs of fresh places (RandomState(7) per level, as the JAX example) with
each view degraded on its own: a random subsample, a random occlusion
sector about the sensor origin and stronger noise, at three levels
(`LEVELS`). Both pipelines, the learned model (a variables npz; default
the shipped ckpt/4480 export) at the default InferenceConfig and
handcrafted_baseline.HandcraftedExtractor, go through the same fig4 and
registration protocol at each level. The result is written as a
`degraded_eval` section of --results_dir's summary.json (default
feat3dnet_tpu_torch/examples/results/scaled_accuracy).

    python -m feat3dnet_tpu_torch.examples.degraded_eval --device cuda
    python -m feat3dnet_tpu_torch.examples.degraded_eval --device cuda \\
        --variables <a port-trained variables.npz> --results_dir <its results dir>
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from types import SimpleNamespace

import numpy as np

from feat3dnet_tpu_torch.eval.heldout import _write6, make_place, se3_view
from feat3dnet_tpu_torch.examples import RESULTS_DIR
from feat3dnet_tpu_torch.examples.eval_inference_sweep import ASSET
from feat3dnet_tpu_torch.examples.handcrafted_baseline import (HandcraftedExtractor,
                                                               merge_section)

LEVELS = {
    # keep_frac, occlusion sector (deg), noise sigma (m)
    "clean": (1.0, 0.0, 0.02),
    "mild": (0.7, 45.0, 0.03),
    "hard": (0.5, 90.0, 0.08),
}


def degrade(rng, view, keep_frac, sector_deg, noise):
    """Independent per-view corruption: random subsample + a random
    occlusion sector (about the sensor origin) + additive noise."""
    keep = rng.rand(view.shape[0]) < keep_frac
    if sector_deg > 0.0:
        ang0 = rng.rand() * 2 * np.pi
        ang = np.arctan2(view[:, 1], view[:, 0])
        d = np.abs(np.angle(np.exp(1j * (ang - ang0))))
        keep &= d > np.radians(sector_deg) / 2
    out = view[keep]
    return (out + rng.randn(*out.shape) * noise).astype(np.float32)


def build_degraded_test(root, rng, n_pairs, keep_frac, sector_deg, noise):
    """Pairs of fresh places with the relative SE3 known exactly, each view
    degraded after the transform (groundtruths.txt as the scaled-accuracy
    test split's)."""
    os.makedirs(root)
    gt_lines = ["idx1 idx2 t1 t2 t3 q1 q2 q3 q4"]
    for k in range(n_pairs):
        place = make_place(rng)
        v0, _, _ = se3_view(rng, place, noise=0.0)
        theta = rng.rand() * 2 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = np.zeros(3, np.float32)
        t[:2] = (rng.rand(2).astype(np.float32) - 0.5) * 4.0
        v1 = v0 @ rz.T + t
        d0 = degrade(rng, v0, keep_frac, sector_deg, noise)
        d1 = degrade(rng, v1, keep_frac, sector_deg, noise)
        a, b = 2 * k, 2 * k + 1
        _write6(os.path.join(root, f"{a}.bin"), d0)
        _write6(os.path.join(root, f"{b}.bin"), d1)
        r_inv = rz.T
        t_gt = -r_inv @ t
        q = np.array([np.cos(-theta / 2), 0.0, 0.0, np.sin(-theta / 2)])
        gt_lines.append(
            f"{a} {b} {t_gt[0]:.6f} {t_gt[1]:.6f} {t_gt[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    with open(os.path.join(root, "groundtruths.txt"), "w") as f:
        f.write("\n".join(gt_lines))


def eval_pipeline(pipe, test_dir, work_dir, feature_dim):
    """Extract every cloud of test_dir with `pipe`, then fig4 and
    registration on those outputs (matching on pipe.device)."""
    from feat3dnet_tpu_torch.data.io import load_point_cloud, save_descriptors
    from feat3dnet_tpu_torch.eval.fig4 import evaluate_dataset
    from feat3dnet_tpu_torch.eval.heldout import evaluate_registration

    result_dir = os.path.join(work_dir, "results")
    os.makedirs(result_dir, exist_ok=True)
    for fname in sorted(f for f in os.listdir(test_dir) if f.endswith(".bin")):
        res = pipe.extract(load_point_cloud(os.path.join(test_dir, fname), 6))
        save_descriptors(os.path.join(result_dir, fname),
                         np.asarray(res.keypoints)[:res.num_keypoints],
                         np.asarray(res.features)[:res.num_keypoints])
    _, agg = evaluate_dataset(test_dir, result_dir, feature_dim=feature_dim,
                              log=lambda *_: None, device=pipe.device)
    out = {"fig4": {k: float(v) for k, v in agg.items()}}
    evaluate_registration(pipe, test_dir, out, result_dir=result_dir,
                          feature_dim=feature_dim)
    shutil.rmtree(result_dir, ignore_errors=True)
    return out


class _TrimmedPipe:
    """A pipeline whose results are cut to num_keypoints, so that padded rows
    never enter matching (process_directory's convention). The port's
    InferencePipeline already returns trimmed results; the wrapper keeps the
    JAX example's interface."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.device = pipe.device

    def extract(self, cloud):
        res = self._pipe.extract(cloud)
        n = int(res.num_keypoints)
        return SimpleNamespace(keypoints=np.asarray(res.keypoints)[:n],
                               features=np.asarray(res.features)[:n], num_keypoints=n)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Learned vs handcrafted on degraded views")
    p.add_argument("--pairs", type=int, default=24)
    p.add_argument("--variables", default=ASSET, help="variables npz of the learned model")
    p.add_argument("--results_dir", default=os.path.join(RESULTS_DIR, "scaled_accuracy"))
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.utils import load_variables_npz
    from feat3dnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(num_clusters=256, num_samples=64)
    learned = _TrimmedPipe(InferencePipeline(
        Feat3DNet(cfg), load_variables_npz(args.variables), cfg, InferenceConfig(),
        device=device))
    handcrafted = HandcraftedExtractor(max_keypoints=1024, device=device)

    out = {"pairs": args.pairs, "variables": os.path.basename(args.variables), "levels": {}}
    for level, (keep, sector, noise) in LEVELS.items():
        rng = np.random.RandomState(7)
        root = tempfile.mkdtemp(prefix=f"f3d_degraded_{level}_")
        try:
            test_dir = os.path.join(root, "test")
            build_degraded_test(test_dir, rng, args.pairs, keep, sector, noise)
            entry = {"keep_frac": keep, "occlusion_sector_deg": sector, "noise_m": noise}
            for name, pipe, fd in (("learned", learned, cfg.feature_dim),
                                   ("handcrafted", handcrafted, 24)):
                entry[name] = eval_pipeline(pipe, test_dir, root, fd)
                print(f"{level:5s} {name:11s}: p@1m "
                      f"{entry[name]['fig4']['precision_at_1m']:.1f}%  reg "
                      f"{entry[name]['registration']['success_rate']:.2f}", flush=True)
            out["levels"][level] = entry
        finally:
            shutil.rmtree(root, ignore_errors=True)
    merge_section(args.results_dir, "degraded_eval", out)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
