"""The synthetic held-out suite of the scaled-accuracy run, in numpy, and
its registration protocol on the port.

Copies of examples/synthetic_training_demo.py (`make_patch_place`),
examples/scaled_accuracy_run.py (`make_place`, `se3_view`, `_write6`,
`write_cluster_pairs`, `evaluate_registration`) and
examples/eval_inference_sweep.py (`_replay_cluster_pairs`,
`build_test_set`), and the sweep's protocol for one setting
(`evaluate_setting`). `build_test_set` replays every draw of the dataset
builder from RandomState(0), so it writes the held-out pairs that the
recorded accuracy (examples/results/scaled_accuracy/inference_sweep.json)
was measured on, byte for byte. `evaluate_registration` runs the port's
matching and RANSAC on the pipeline's device.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from feat3dnet_tpu_torch.data.io import load_descriptors, load_point_cloud
from feat3dnet_tpu_torch.eval.fig4 import read_groundtruths, rotmat_from_quat
from feat3dnet_tpu_torch.eval.matching import match_descriptors, mutual_matches
from feat3dnet_tpu_torch.eval.ransac import ransac_rigid


def make_patch_place(rng, n_patches=24, extent=18.0):
    """A 'place': union of oriented planar patches (walls/ground-like)."""
    pts = []
    for _ in range(n_patches):
        center = (rng.rand(3) - 0.5) * np.array([2 * extent, 2 * extent, 6.0])
        a, b = rng.randn(3), rng.randn(3)
        a /= np.linalg.norm(a)
        b -= a * (a @ b)
        b /= np.linalg.norm(b)
        size = 1.5 + 3.0 * rng.rand(2)
        uv = (rng.rand(220, 2) - 0.5)
        pts.append(center + uv[:, :1] * a * size[0] + uv[:, 1:] * b * size[1])
    cloud = np.concatenate(pts, axis=0)
    keep = np.sum(cloud[:, :2] ** 2, axis=1) < extent * extent
    return cloud[keep].astype(np.float32)


def make_place(rng, extent=18.0):
    """Structured scene: planar patches + vertical poles + box corners."""
    parts = [make_patch_place(rng, n_patches=20, extent=extent)]
    # poles (tree-trunk/lamp-post-like vertical structures)
    for _ in range(8):
        base = (rng.rand(3) - 0.5) * np.array([2 * extent, 2 * extent, 0.5])
        h = 2.0 + 4.0 * rng.rand()
        z = rng.rand(140, 1) * h
        ang = rng.rand(140, 1) * 2 * np.pi
        rad = 0.1 + 0.1 * rng.rand()
        parts.append(base + np.concatenate(
            [rad * np.cos(ang), rad * np.sin(ang), z], axis=1))
    # box corners (building-corner-like intersections of 3 planes)
    for _ in range(5):
        c = (rng.rand(3) - 0.5) * np.array([2 * extent, 2 * extent, 3.0])
        s = 1.0 + 2.0 * rng.rand()
        for axes in ((0, 1), (0, 2), (1, 2)):
            uv = rng.rand(70, 2) * s
            pts = np.tile(c, (70, 1))
            pts[:, axes[0]] += uv[:, 0]
            pts[:, axes[1]] += uv[:, 1]
            parts.append(pts)
    cloud = np.concatenate(parts, axis=0).astype(np.float32)
    keep = np.sum(cloud[:, :2] ** 2, axis=1) < extent * extent
    return cloud[keep]


def se3_view(rng, place, max_shift=2.0, noise=0.02):
    """Apply a known z-rotation + shift: view = place @ Rz(theta).T + t.
    Returns (view, theta, t)."""
    theta = rng.rand() * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = np.zeros(3, np.float32)
    t[:2] = (rng.rand(2).astype(np.float32) - 0.5) * 2 * max_shift
    view = place @ rz.T + t
    view = view + rng.randn(*view.shape).astype(np.float32) * noise
    return view.astype(np.float32), theta, t


def _write6(path, xyz):
    np.concatenate([xyz, np.zeros_like(xyz)], axis=1).astype(
        np.float32).tofile(path)


def write_cluster_pairs(folder, rng, places, n_pairs, crop_radius=4.0):
    """The reference's clusters/ layout: {i}_0.bin / {i}_1.bin crops (label
    1: two views of one crop; 0: crops of two places) + filenames.txt."""
    os.makedirs(folder, exist_ok=True)
    lines = ["idx label"]
    for k in range(n_pairs):
        label = k % 2
        pa = rng.randint(len(places))
        place = places[pa]
        center = place[rng.randint(place.shape[0])]
        crop = place[np.linalg.norm(place - center, axis=1) < crop_radius] - center
        v0, _, _ = se3_view(rng, crop, max_shift=0.2)
        if label:
            v1, _, _ = se3_view(rng, crop, max_shift=0.2)
        else:
            pb = (pa + 1 + rng.randint(len(places) - 1)) % len(places)
            other = places[pb]
            c2 = other[rng.randint(other.shape[0])]
            v1, _, _ = se3_view(
                rng, other[np.linalg.norm(other - c2, axis=1) < crop_radius] - c2,
                max_shift=0.2)
        _write6(os.path.join(folder, f"{k}_0.bin"), v0)
        _write6(os.path.join(folder, f"{k}_1.bin"), v1)
        lines.append(f"{k} {label}")
    with open(os.path.join(folder, "filenames.txt"), "w") as f:
        f.write("\n".join(lines))


def _replay_cluster_pairs(rng, places, n_pairs):
    """Consume exactly the rng draws of write_cluster_pairs without writing
    any files."""
    for k in range(n_pairs):
        label = k % 2
        pa = rng.randint(len(places))
        place = places[pa]
        center = place[rng.randint(place.shape[0])]
        crop = place[np.linalg.norm(place - center, axis=1) < 4.0] - center
        se3_view(rng, crop, max_shift=0.2)
        if label:
            se3_view(rng, crop, max_shift=0.2)
        else:
            pb = (pa + 1 + rng.randint(len(places) - 1)) % len(places)
            other = places[pb]
            c2 = other[rng.randint(other.shape[0])]
            se3_view(rng,
                     other[np.linalg.norm(other - c2, axis=1) < 4.0] - c2,
                     max_shift=0.2)


def build_test_set(root, test_pairs):
    """The held-out test set of the scaled-accuracy dataset builder (default
    arguments), regenerated: the builder draws 240 places x 4 views + 96
    validation cluster pairs from RandomState(0), then the test places, then
    96 held-out cluster pairs, and only then the test views. This replays
    every draw in that order and writes <root>/test (2 clouds a pair +
    groundtruths.txt); returns its path."""
    rng = np.random.RandomState(0)
    places = [make_place(rng) for _ in range(240)]
    for place in places:
        for _ in range(4):
            se3_view(rng, place)
    _replay_cluster_pairs(rng, places, 96)
    test_places = [make_place(rng) for _ in range(test_pairs)]
    _replay_cluster_pairs(rng, test_places, 96)
    test = os.path.join(root, "test")
    os.makedirs(test)
    gt_lines = ["idx1 idx2 t1 t2 t3 q1 q2 q3 q4"]
    for k, place in enumerate(test_places):
        v0, _, _ = se3_view(rng, place)
        v1, theta, t = se3_view(rng, place)
        c, s = np.cos(theta), np.sin(theta)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        v1 = v0 @ rz.T + t + rng.randn(*v0.shape).astype(np.float32) * 0.02
        a, b = 2 * k, 2 * k + 1
        _write6(os.path.join(test, f"{a}.bin"), v0)
        _write6(os.path.join(test, f"{b}.bin"), v1)
        # cloud_a = R·cloud_b + t_gt with R = Rz(-theta), t_gt = -R t
        r_inv = rz.T
        t_gt = -r_inv @ t
        q = np.array([np.cos(-theta / 2), 0.0, 0.0, np.sin(-theta / 2)])
        gt_lines.append(
            f"{a} {b} {t_gt[0]:.6f} {t_gt[1]:.6f} {t_gt[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    with open(os.path.join(test, "groundtruths.txt"), "w") as f:
        f.write("\n".join(gt_lines))
    return test


def _read_result(pipe, test_dir, result_dir, i, feature_dim):
    """Cloud i's keypoints and features: read back from result_dir's
    [xyz | descriptor] file when given, else extracted by `pipe`."""
    if result_dir is not None:
        kp, feats = load_descriptors(os.path.join(result_dir, f"{i}.bin"), feature_dim)
        return SimpleNamespace(keypoints=kp, features=feats)
    return pipe.extract(load_point_cloud(os.path.join(test_dir, f"{i}.bin"), 6))


def evaluate_registration(pipe, test_dir, out, seed=0, result_dir=None, feature_dim=32):
    """Extract -> mutual matches -> RANSAC (1 024 hypotheses, 1 m) -> the
    error against the known SE3; writes out["registration"]. A pair
    succeeds at < 5 degrees and < 2 m. The matching and RANSAC run on the
    pipeline's device, RANSAC drawing from a generator seeded with `seed`
    per pair. result_dir: the pipeline's outputs for test_dir
    (`process_directory`'s files, the extraction's float32 keypoints and
    features unchanged), read instead of extracting every cloud again."""
    dev = pipe.device
    pairs = read_groundtruths(os.path.join(test_dir, "groundtruths.txt"))
    rot_errs, trans_errs, inliers, successes = [], [], [], []
    for a, b, t_gt, q_gt in pairs:
        ra = _read_result(pipe, test_dir, result_dir, a, feature_dim)
        rb = _read_result(pipe, test_dir, result_dir, b, feature_dim)
        fa, fb = torch.from_numpy(ra.features).to(dev), torch.from_numpy(rb.features).to(dev)
        nn_in_a, _ = match_descriptors(fa, fb)     # per-B nearest in A
        sel = np.nonzero(mutual_matches(fa, fb).cpu().numpy())[0]
        if sel.size < 3:
            successes.append(False)
            continue
        src = torch.from_numpy(rb.keypoints[sel]).to(dev)
        dst = torch.from_numpy(ra.keypoints[nn_in_a.cpu().numpy()[sel]]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tf, _, n_in = ransac_rigid(gen, src, dst, inlier_threshold=1.0)
        r_est = tf.rotation.cpu().numpy().astype(np.float64)
        t_est = tf.translation.cpu().numpy().astype(np.float64)
        r_gt = rotmat_from_quat(q_gt)
        cosang = (np.trace(r_est.T @ r_gt) - 1) / 2
        rot_err = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
        trans_err = np.linalg.norm(t_est - t_gt)
        rot_errs.append(float(rot_err))
        trans_errs.append(float(trans_err))
        inliers.append(int(n_in))
        successes.append(bool(rot_err < 5.0 and trans_err < 2.0))
    out["registration"] = {
        "n_pairs": len(pairs),
        "success_rate": float(np.mean(successes)) if successes else 0.0,
        "median_rot_err_deg": float(np.median(rot_errs)) if rot_errs else None,
        "median_trans_err_m": float(np.median(trans_errs)) if trans_errs else None,
        "median_inliers": float(np.median(inliers)) if inliers else None,
    }


def evaluate_setting(pipe, test_dir, result_dir, log=lambda *_: None):
    """One inference setting through the whole held-out protocol (the body of
    the inference sweep): `process_directory` into result_dir, fig4 over the
    pairs, keypoints per cloud and registration (on result_dir's outputs,
    which equal a second extraction's). Matching runs on the pipeline's
    device. Returns {"fig4": ..., "keypoints_per_cloud": ...,
    "registration": ...}."""
    from feat3dnet_tpu_torch.eval.fig4 import evaluate_dataset

    pipe.process_directory(test_dir, result_dir, data_dim=6, log=log)
    _, agg = evaluate_dataset(test_dir, result_dir, log=log, device=pipe.device)
    entry = {"fig4": {k: float(v) for k, v in agg.items()},
             "keypoints_per_cloud": float(np.mean([
                 np.fromfile(os.path.join(result_dir, f), np.float32).reshape(-1, 35).shape[0]
                 for f in os.listdir(result_dir)]))}
    evaluate_registration(pipe, test_dir, entry, result_dir=result_dir)
    return entry
