"""Oxford RobotCar preprocessing: SE3 pose utilities, INS pose
interpolation, 2-D LMS scan accumulation into 3-D clouds, and the
crop/voxel/normals cloud processor.

Ports of the reference MATLAB internals (scripts_data_processing/oxford/):
  SE3MatrixFromComponents.m  -> se3_from_components
  InterpolatePoses.m         -> interpolate_poses (linear position +
                                quaternion slerp between bracketing INS rows)
  BuildPointcloud.m          -> accumulate_scans (push each planar LMS scan
                                through interp-pose @ ins->laser extrinsic)
  BuildPointclouds.m         -> segment_trajectory (one cloud per 10 m of
                                travel, 60 m accumulation window, stationary
                                frames below 0.2 m/s dropped)
  processPointCloud.m        -> process_cloud (center at centroid, crop
                                30 m, voxel 0.2 m average, 9-NN normals)
  oxford_build_pointclouds.m -> build_dataset, writing
                                <idx>.bin + metadata.txt
"""
from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from feat3dnet_tpu_torch.dataprep.normals import estimate_normals
from feat3dnet_tpu_torch.dataprep.voxel import voxel_downsample

MIN_SPEED = 0.2                 # m/s; reference BuildPointclouds.m:6
ACCUMULATE_DISTANCE = 60.0      # metres of travel per cloud (:7)
METERS_PER_POINT_CLOUD = 10.0   # distance between cloud origins (:8)
CROP_RADIUS = 30.0              # processPointCloud.m:12
VOXEL_GRID = 0.2                # processPointCloud.m:28


# --- SE3 ----------------------------------------------------------------

def se3_from_components(xyzrpy: Sequence[float]) -> np.ndarray:
    """[x y z roll pitch yaw] -> 4x4 (R = Rz(yaw) Ry(pitch) Rx(roll))."""
    x, y, z, roll, pitch, yaw = [float(v) for v in xyzrpy]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = rz @ ry @ rx
    m[:3, 3] = (x, y, z)
    return m


def quat_from_rotmat(r: np.ndarray) -> np.ndarray:
    from feat3dnet_tpu_torch.dataprep.kitti import rotmat_to_quat_wxyz

    return rotmat_to_quat_wxyz(r)


def rotmat_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Batch slerp: q0,q1 (N,4) wxyz; t (N,) in [0,1] -> (N,4)."""
    dot = np.sum(q0 * q1, axis=1)
    q1 = np.where(dot[:, None] < 0, -q1, q1)
    dot = np.abs(dot).clip(-1.0, 1.0)
    theta = np.arccos(dot)
    sin_theta = np.sin(theta)
    small = sin_theta < 1e-6
    w0 = np.where(small, 1.0 - t, np.sin((1.0 - t) * theta) / np.where(small, 1, sin_theta))
    w1 = np.where(small, t, np.sin(t * theta) / np.where(small, 1, sin_theta))
    out = w0[:, None] * q0 + w1[:, None] * q1
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def interpolate_poses(
    pose_timestamps: np.ndarray,       # (M,) sorted, microseconds
    poses_xyzrpy: np.ndarray,          # (M, 6)
    query_timestamps: np.ndarray,      # (Q,)
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Interpolated SE3 pose per query timestamp + finite-difference
    velocities (the InterpolatePoses.m contract: linear position,
    slerp rotation between bracketing INS records)."""
    pose_timestamps = np.asarray(pose_timestamps, np.float64)
    query = np.asarray(query_timestamps, np.float64)
    hi = np.clip(np.searchsorted(pose_timestamps, query, side="right"),
                 1, len(pose_timestamps) - 1)
    lo = hi - 1
    t0, t1 = pose_timestamps[lo], pose_timestamps[hi]
    frac = np.where(t1 > t0, (query - t0) / np.maximum(t1 - t0, 1e-9), 0.0)
    frac = frac.clip(0.0, 1.0)

    p0, p1 = poses_xyzrpy[lo, :3], poses_xyzrpy[hi, :3]
    positions = p0 + frac[:, None] * (p1 - p0)

    q0 = np.stack([quat_from_rotmat(se3_from_components(poses_xyzrpy[i])[:3, :3])
                   for i in np.unique(np.concatenate([lo, hi]))])
    # map unique index -> quaternion
    uniq = np.unique(np.concatenate([lo, hi]))
    qmap = {int(i): q0[j] for j, i in enumerate(uniq)}
    qa = np.stack([qmap[int(i)] for i in lo])
    qb = np.stack([qmap[int(i)] for i in hi])
    quats = _slerp(qa, qb, frac)

    out = []
    for pos, q in zip(positions, quats):
        m = np.eye(4)
        m[:3, :3] = rotmat_from_quat(q)
        m[:3, 3] = pos
        out.append(m)

    dt = np.maximum(t1 - t0, 1e-9) / 1e6   # microseconds -> seconds
    vel = (p1 - p0) / dt[:, None]
    return out, vel


# --- scan accumulation ---------------------------------------------------

def accumulate_scans(
    scans: Iterable[np.ndarray],       # each (K, >=2): planar (x, y[, refl]) LMS points
    poses: Sequence[np.ndarray],       # (F,) of 4x4 world<-ins at each scan time
    g_ins_laser: np.ndarray,           # 4x4 ins<-laser extrinsic
) -> np.ndarray:
    """Push every planar scan through its interpolated pose; returns the
    accumulated world-frame (N, 3) cloud (BuildPointcloud.m core: laser
    points (x, y, 0) homogenized, world = pose @ G_ins_laser @ p)."""
    out = []
    for scan, pose in zip(scans, poses):
        k = scan.shape[0]
        if k == 0:
            continue
        pts = np.zeros((4, k))
        pts[0] = scan[:, 0]
        pts[1] = scan[:, 1]
        pts[3] = 1.0
        world = (pose @ g_ins_laser) @ pts
        out.append(world[:3].T)
    if not out:
        return np.zeros((0, 3))
    return np.concatenate(out, axis=0)


def moving_mask(velocities: np.ndarray, min_speed: float = MIN_SPEED) -> np.ndarray:
    """Frames where the vehicle moves faster than min_speed — apply to
    laser timestamps/poses BEFORE accumulation, as BuildPointclouds.m:63-68
    does (stationary frames would over-weight stop locations)."""
    return np.linalg.norm(np.asarray(velocities), axis=1) > min_speed


def segment_trajectory(positions: np.ndarray,
                       accumulate_distance: float = ACCUMULATE_DISTANCE,
                       meters_per_cloud: float = METERS_PER_POINT_CLOUD
                       ) -> List[Tuple[int, int]]:
    """Split frame indices into overlapping windows: each window spans
    `accumulate_distance` of travel; a new window starts every
    `meters_per_cloud` of travel."""
    seg = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    windows = []
    start_arc = 0.0
    while start_arc + accumulate_distance <= arc[-1]:
        i0 = int(np.searchsorted(arc, start_arc))
        i1 = int(np.searchsorted(arc, start_arc + accumulate_distance))
        windows.append((i0, max(i1, i0 + 1)))
        start_arc += meters_per_cloud
    return windows


def process_cloud(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """processPointCloud.m port: center at centroid, crop to 30 m, voxel
    0.2 m average, 9-NN normals. Returns ([xyz|normal] rows, centroid)."""
    xyz = np.asarray(xyz, np.float64)
    mu = xyz.mean(axis=0)
    rel = xyz - mu
    rel = rel[np.sum(rel ** 2, axis=1) < CROP_RADIUS * CROP_RADIUS]
    pts, _ = voxel_downsample(rel, grid=VOXEL_GRID)
    normals, _, _ = estimate_normals(pts, k=9, viewpoint=(0, 0, 0))
    return np.concatenate([pts, normals], axis=1).astype(np.float32), mu


def build_dataset(clouds_with_positions: Iterable[Tuple[np.ndarray, np.ndarray]],
                  out_dir: str, dataset_name: str, log=print) -> int:
    """Write processed clouds + metadata.txt (oxford_build_pointclouds.m
    output contract: Idx/Dataset/StartIdx/EndIdx/NumPts/X/Y/Z rows)."""
    dst = os.path.join(out_dir, dataset_name)
    os.makedirs(dst, exist_ok=True)
    count = 0
    with open(os.path.join(dst, "metadata.txt"), "w") as meta:
        meta.write("Idx\tDataset\tStartIdx\tEndIdx\tNumPts\tX\tY\tZ\n")
        for cloud, origin in clouds_with_positions:
            rows, mu = process_cloud(cloud)
            rows.tofile(os.path.join(dst, f"{count}.bin"))
            meta.write(f"{count}\t{dataset_name}\t\t\t{rows.shape[0]}"
                       f"\t{mu[0]:.6f}\t{mu[1]:.6f}\t{mu[2]:.6f}\n")
            count += 1
            log(f"Wrote cloud {count}")
    return count
