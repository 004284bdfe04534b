"""KITTI odometry preprocessing.

Port of process_kitti_data.m: walk each sequence's camera-frame pose file,
keep one velodyne scan per 10 m of travel, record groundtruth relative
transforms (velodyne frame, translation + wxyz quaternion) for scan pairs
closer than 10 m, and write each kept scan voxel-downsampled (0.2 m grid
average) with plane-fit normals (viewpoint (0,0,1)) as [xyz|normal] float32
rows — the framework's standard .bin format.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from feat3dnet_tpu_torch.dataprep.normals import estimate_normals
from feat3dnet_tpu_torch.dataprep.voxel import voxel_downsample


def load_kitti_poses(path: str) -> np.ndarray:
    """poses/NN.txt: rows of 12 floats = row-major 3x4 cam0-frame pose."""
    flat = np.loadtxt(path, dtype=np.float64)
    return flat.reshape(-1, 3, 4)


def load_kitti_calib(path: str) -> Dict[str, np.ndarray]:
    """sequences/NN/calib.txt: 'name: 12 floats' rows -> {name: 4x4}."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            name, rest = line.split(":", 1)
            vals = np.fromstring(rest, sep=" ")
            if vals.size != 12:
                continue
            m = np.eye(4)
            m[:3, :] = vals.reshape(3, 4)
            out[name.strip()] = m
    return out


def select_scans_every(positions: np.ndarray, meters: float = 10.0) -> np.ndarray:
    """Greedy scan thinning: starting at scan 0, repeatedly jump to the scan
    just BEFORE the first one farther than `meters` from the current
    (process_kitti_data.m:39-50 — its find(>10)-1 walk)."""
    n = positions.shape[0]
    scans = [0]
    cur = 0
    while True:
        d = np.linalg.norm(positions[cur + 1:] - positions[cur], axis=1)
        beyond = np.nonzero(d > meters)[0]
        if beyond.size == 0:
            break
        nxt = cur + 1 + beyond[0] - 1
        if nxt <= cur:  # immediate jump farther than `meters`: take it anyway
            nxt = cur + 1 + beyond[0]
        scans.append(nxt)
        cur = nxt
    return np.asarray(scans, np.int64)


def pose_cam_to_velo(pose_cam0: np.ndarray, tr: np.ndarray) -> np.ndarray:
    """Move a cam0-frame pose into the velodyne frame: Tr⁻¹ · P · Tr
    (process_kitti_data.m poses2velo)."""
    p = np.eye(4)
    p[:3, :] = pose_cam0[:3, :]
    tr_inv = np.eye(4)
    tr_inv[:3, :3] = tr[:3, :3].T
    tr_inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return tr_inv @ p @ tr


def rotmat_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [w, x, y, z] (MATLAB rotm2quat order)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(r)))
        if i == 0:
            s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            w = (r[2, 1] - r[1, 2]) / s
            x = 0.25 * s
            y = (r[0, 1] + r[1, 0]) / s
            z = (r[0, 2] + r[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            w = (r[0, 2] - r[2, 0]) / s
            x = (r[0, 1] + r[1, 0]) / s
            y = 0.25 * s
            z = (r[1, 2] + r[2, 1]) / s
        else:
            s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            w = (r[1, 0] - r[0, 1]) / s
            x = (r[0, 2] + r[2, 0]) / s
            y = (r[1, 2] + r[2, 1]) / s
            z = 0.25 * s
    q = np.array([w, x, y, z])
    return q if w >= 0 else -q


def make_pair_groundtruths(poses: np.ndarray, scans: np.ndarray,
                           tr_velo: np.ndarray, max_dist: float = 10.0
                           ) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
    """(idx1, idx2, t, q_wxyz) for kept-scan pairs closer than max_dist;
    transform maps scan-2 velodyne points into scan-1's frame."""
    positions = poses[scans, :, 3]
    out = []
    for ai in range(len(scans)):
        for bi in range(ai + 1, len(scans)):
            if np.linalg.norm(positions[ai] - positions[bi]) >= max_dist:
                continue
            a, b = int(scans[ai]), int(scans[bi])
            p1 = pose_cam_to_velo(poses[a], tr_velo)
            p2 = pose_cam_to_velo(poses[b], tr_velo)
            t12 = np.linalg.solve(p1, p2)
            out.append((a, b, t12[:3, 3].copy(),
                        rotmat_to_quat_wxyz(t12[:3, :3])))
    return out


def write_groundtruths(path: str,
                       pairs: Sequence[Tuple[int, int, np.ndarray, np.ndarray]]) -> None:
    with open(path, "w") as f:
        f.write("idx1\tidx2\tt_1\tt_2\tt_3\tq_1\tq_2\tq_3\tq_4\n")
        for a, b, t, q in pairs:
            f.write(f"{a}\t{b}\t" + "\t".join(f"{v:.9g}" for v in (*t, *q)) + "\n")


def process_scan(xyzi: np.ndarray, voxel_grid: float = 0.2,
                 normal_neighbors: int = 9) -> np.ndarray:
    """One velodyne scan (N, >=3) -> voxel-averaged [xyz | normal] rows."""
    xyz = np.asarray(xyzi[:, :3], np.float64)
    normals, _, _ = estimate_normals(xyz, k=normal_neighbors, viewpoint=(0, 0, 1))
    pts, nrm = voxel_downsample(xyz, grid=voxel_grid, attributes=normals)
    return np.concatenate([pts, nrm], axis=1).astype(np.float32)


def process_sequence(poses_file: str, calib_file: str, velodyne_dir: str,
                     out_dir: str, meters_per_cloud: float = 10.0,
                     pair_max_dist: float = 10.0, log=print) -> np.ndarray:
    """A whole sequence (the per-sequence body of process_kitti_data.m)."""
    poses = load_kitti_poses(poses_file)
    calib = load_kitti_calib(calib_file)
    scans = select_scans_every(poses[:, :, 3], meters_per_cloud)
    os.makedirs(out_dir, exist_ok=True)

    pairs = make_pair_groundtruths(poses, scans, calib["Tr"], pair_max_dist)
    write_groundtruths(os.path.join(out_dir, "groundtruths.txt"), pairs)

    for i, s in enumerate(scans):
        src = os.path.join(velodyne_dir, f"{s:06d}.bin")
        xyzi = np.fromfile(src, np.float32).reshape(-1, 4)
        out = process_scan(xyzi)
        out.tofile(os.path.join(out_dir, f"{s:06d}.bin"))
        log(f"Processed {i + 1}/{len(scans)}")
    return scans
