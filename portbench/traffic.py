"""The one traffic generator: frames, cluster requests and triplet batches,
built from `--seed` out of the vendored clouds as a workload file's
`traffic` section says. Every seed gets the same sizes; the seed moves the
transforms, the jitter and the order.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.extract import ball_indices
from portbench.reference.train import fps


def load_xyz(root: str, name: str, cols: int = 6) -> np.ndarray:
    """(N, 3) float32 points of a vendored .bin (float32 rows of `cols`)."""
    raw = np.fromfile(os.path.join(root, name), dtype=np.float32)
    return np.ascontiguousarray(raw.reshape(-1, cols)[:, :3])


def _yaw(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per (seed, purpose)."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def frames(root: str, spec: Dict, seed: int) -> List[np.ndarray]:
    """`pool` frames, the clouds in turn, each under a seeded yaw, a
    translation of up to `translation_m` in x and y and Gaussian jitter of
    `jitter_m`: (N, 3) float32 host arrays. `points` (the tests' small
    frames) keeps that many points of each cloud, the first in index order."""
    rng = rng_for(seed, 1)
    clouds = [load_xyz(root, n)[:spec.get("points")] for n in spec["clouds"]]
    out = []
    for i in range(int(spec["pool"])):
        xyz = clouds[i % len(clouds)].astype(np.float64)
        t = np.zeros(3)
        t[:2] = rng.uniform(-spec["translation_m"], spec["translation_m"], 2)
        xyz = xyz @ _yaw(rng.uniform(0.0, 2.0 * math.pi)) + t
        xyz = xyz + rng.normal(0.0, spec["jitter_m"], xyz.shape)
        out.append(np.ascontiguousarray(xyz, np.float32))
    return out


def order(n_items: int, count: int, seed: int, stream: int) -> np.ndarray:
    """`count` indices into a pool of n_items: whole seeded permutations
    back to back (each pool item equally often)."""
    rng = rng_for(seed, stream)
    reps = -(-count // n_items)
    return np.concatenate([rng.permutation(n_items) for _ in range(reps)])[:count]


def cycle(n_items: int, seed: int, stream: int):
    """Endless pool indices: seeded permutations back to back."""
    rng = rng_for(seed, stream)
    while True:
        yield from rng.permutation(n_items).tolist()


def cluster_requests(root: str, spec: Dict, seed: int, device) -> List[np.ndarray]:
    """`requests` host arrays of (`batch`, ns, 3) origin-centred clusters:
    each cloud under a seeded yaw, `centres` FPS centres and the first ns
    points within `radius_m` of each, as offsets; the distinct clusters
    tiled to `batch` rows in a seeded order per request."""
    rng = rng_for(seed, 2)
    ns, radius = int(spec["num_samples"]), float(spec["radius_m"])
    distinct = []
    for name in spec["clouds"]:
        xyz = load_xyz(root, name).astype(np.float64) @ _yaw(rng.uniform(0.0, 2.0 * math.pi))
        pts = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(device)
        centres = pts[fps(pts[None], int(spec["centres"]))[0]]
        idx = ball_indices(pts, centres, radius, ns)
        distinct.append((pts[idx] - centres[:, None, :]).cpu().numpy())
    distinct = np.concatenate(distinct)
    out = []
    for _ in range(int(spec["requests"])):
        rows = np.concatenate([rng.permutation(len(distinct))
                               for _ in range(-(-spec["batch"] // len(distinct)))])
        out.append(np.ascontiguousarray(distinct[rows[:spec["batch"]]]))
    return out


def _crop(xyz: np.ndarray, centre: np.ndarray, radius: float, n: int,
          rng: np.random.Generator) -> np.ndarray:
    """The points within `radius` of `centre` (in x, y), resampled to n
    (without replacement where there are enough)."""
    near = xyz[np.sum((xyz[:, :2] - centre[:2]) ** 2, axis=1) < radius * radius]
    pick = rng.choice(len(near), n, replace=len(near) < n)
    return near[pick]


def triplet_batches(root: str, spec: Dict, seed: int) -> List[np.ndarray]:
    """`pool` stacked batches (3 B, N, 3) float32, anchors | positives |
    negatives: an anchor is a cloud cropped to `crop_m` around a seeded
    centre and resampled to N; its positive the same place of the same
    cloud under another seeded yaw and translation, cropped and resampled
    anew; its negative another cloud."""
    rng = rng_for(seed, 3)
    clouds = [load_xyz(root, n).astype(np.float64) for n in spec["clouds"]]
    b, n, crop = int(spec["triplets"]), int(spec["points"]), float(spec["crop_m"])
    out = []
    for _ in range(int(spec["pool"])):
        roles = [[], [], []]
        for _ in range(b):
            i = int(rng.integers(len(clouds)))
            j = (i + 1 + int(rng.integers(len(clouds) - 1))) % len(clouds)
            centre = np.zeros(3)
            centre[:2] = rng.uniform(-spec["centre_m"], spec["centre_m"], 2)
            anchor = _crop(clouds[i], centre, crop, n, rng)
            t = np.zeros(3)
            t[:2] = rng.uniform(-spec["translation_m"], spec["translation_m"], 2)
            moved = (clouds[i] - centre) @ _yaw(rng.uniform(0.0, 2.0 * math.pi)) + t
            positive = _crop(moved, t, crop, n, rng)
            negative = _crop(clouds[j], np.zeros(3), crop, n, rng)
            for r, c in zip(roles, (anchor - centre, positive - t, negative)):
                r.append(c)
        out.append(np.ascontiguousarray(np.concatenate([np.stack(r) for r in roles]),
                                        dtype=np.float32))
    return out
