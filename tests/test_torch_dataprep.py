"""The port's numpy dataprep/ and cli.prepare against the JAX package's
(tests/test_dataprep.py's and tests/test_prepare_cli.py's cases) on the
CPU: each function's output array_equal to JAX's on the same seeded
inputs, each subcommand's files byte-equal to JAX's CLI's (a submap
metadata.txt as its header and its sorted rows: convert_submaps appends a
row as each of its threads finishes, in either package). The port's
modules are copies, so nothing less than equality is expected.
"""
import os

import numpy as np
import pytest

import feat3dnet_tpu.dataprep as jdp
import feat3dnet_tpu_torch.dataprep as dp
from feat3dnet_tpu.cli.prepare import main as jax_prepare
from feat3dnet_tpu.dataprep import kitti as jkitti
from feat3dnet_tpu.dataprep import oxford as joxford
from feat3dnet_tpu.dataprep import submap as jsubmap
from feat3dnet_tpu_torch.cli.prepare import main as prepare
from feat3dnet_tpu_torch.dataprep import kitti, oxford, submap
from tests.test_dataprep import _write_submap


def _rigid(rs):
    q, _ = np.linalg.qr(rs.randn(3, 3))
    return q * np.sign(np.linalg.det(q)), rs.randn(3)


def _poses(rs, n=30):
    """(n, 3, 4) poses along a noisy drive."""
    out = np.zeros((n, 3, 4))
    for i in range(n):
        out[i, :, :3] = _rigid(rs)[0]
        out[i, :, 3] = [2.0 * i, rs.randn(), 0.1 * rs.randn()]
    return out


CALLS = {
    "estimate_normals": lambda m, rs: m.normals.estimate_normals(rs.randn(300, 3) * 4, k=9),
    "estimate_normals_dir": lambda m, rs: m.normals.estimate_normals(
        rs.randn(200, 3), k=6, viewpoint=(1.0, 2.0, 3.0), dir_largest=False),
    "voxel_downsample": lambda m, rs: m.voxel.voxel_downsample(
        rs.rand(500, 3) * 3, grid=0.2, attributes=rs.randn(500, 3),
        renormalize_attributes=True),
    "select_scans_every": lambda m, rs: m.kitti.select_scans_every(
        np.cumsum(rs.rand(80, 3) * 2.0, axis=0), meters=10.0),
    "pose_cam_to_velo": lambda m, rs: m.kitti.pose_cam_to_velo(
        _poses(rs, 1)[0], np.vstack([np.hstack([_rigid(rs)[0], rs.randn(3, 1)]),
                                     [[0, 0, 0, 1]]])),
    "rotmat_to_quat_wxyz": lambda m, rs: [m.kitti.rotmat_to_quat_wxyz(_rigid(rs)[0])
                                          for _ in range(10)],
    "make_pair_groundtruths": lambda m, rs: m.kitti.make_pair_groundtruths(
        _poses(rs), np.arange(0, 30, 3), np.eye(4) + 0.01 * rs.randn(4, 4), max_dist=10.0),
    "process_scan": lambda m, rs: m.kitti.process_scan(rs.randn(400, 4) * 5),
    "se3_from_components": lambda m, rs: m.oxford.se3_from_components(rs.randn(6)),
    "quat_rotmat": lambda m, rs: [m.oxford.rotmat_from_quat(m.oxford.quat_from_rotmat(
        _rigid(rs)[0])) for _ in range(5)],
    "interpolate_poses": lambda m, rs: m.oxford.interpolate_poses(
        np.arange(6) * 1e6, rs.randn(6, 6), np.sort(rs.rand(9)) * 5e6),
    "accumulate_scans": lambda m, rs: m.oxford.accumulate_scans(
        [rs.rand(20, 2) for _ in range(5)],
        [m.oxford.se3_from_components(rs.randn(6)) for _ in range(5)],
        m.oxford.se3_from_components(rs.randn(6))),
    "moving_mask": lambda m, rs: m.oxford.moving_mask(rs.randn(50, 3)),
    "segment_trajectory": lambda m, rs: m.oxford.segment_trajectory(
        np.cumsum(rs.rand(100, 3), axis=0), accumulate_distance=30, meters_per_cloud=10),
    "process_cloud": lambda m, rs: m.oxford.process_cloud(rs.randn(2000, 3) * 10.0),
}


class _Modules:
    def __init__(self, pkg, kitti_mod, oxford_mod):
        self.normals, self.voxel = pkg.normals, pkg.voxel
        self.kitti, self.oxford = kitti_mod, oxford_mod


def _assert_same(got, want, where):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, where
        np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_functions_equal_jax(name):
    got = CALLS[name](_Modules(dp, kitti, oxford), np.random.RandomState(0))
    want = CALLS[name](_Modules(jdp, jkitti, joxford), np.random.RandomState(0))
    _assert_same(got, want, name)


def test_file_writers_equal_jax(tmp_path):
    """generate_train_cases, write_groundtruths, build_dataset, read_submap
    and convert_submaps (with and without normals): the same bytes."""
    rs = np.random.RandomState(1)
    positions = np.cumsum(rs.rand(40, 3) * 6.0, axis=0)
    names = [f"s/{i}.bin" for i in range(40)]
    pairs = kitti.make_pair_groundtruths(_poses(rs), np.arange(0, 30, 2), np.eye(4), 12.0)
    clouds = [(rs.randn(1500, 3) * 8.0, rs.randn(3)) for _ in range(2)]
    os.makedirs(tmp_path / "raw" / "seq")
    raw = [str(tmp_path / "raw" / "seq" / f"r{i}.bin") for i in range(3)]
    for i, p in enumerate(raw):
        _write_submap(p, rs, num_points=40 + 10 * i, world=(float(i), 1.0, 2.0))
    for tag, pkg, kit, ox, sub in (("port", dp, kitti, oxford, submap),
                                   ("jax", jdp, jkitti, joxford, jsubmap)):
        out = tmp_path / tag
        os.makedirs(out)
        for bounds in (None, ((-np.inf, np.inf), (-np.inf, 50.0))):
            n = pkg.generate_train_cases(names, positions, str(out / f"train_{bounds is None}.txt"),
                                         test_bounds=bounds)
            assert n > 0
        kit.write_groundtruths(str(out / "gt.txt"), pairs)
        assert ox.build_dataset(iter(clouds), str(out), "ds", log=lambda *_: None) == 2
        for normals in (False, True):
            sub.convert_submaps(raw, str(out / f"sub_{normals}"), compute_normals=normals,
                                num_threads=2)
        _assert_same(sub.read_submap(raw[1])[0], jsubmap.read_submap(raw[1])[0], "read_submap")
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def _assert_same_tree(a, b):
    files_a = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a)
                     for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b)
                     for f in fs)
    assert files_a == files_b and files_a
    for f in files_a:
        got, want = (open(os.path.join(d, f), "rb").read() for d in (a, b))
        if f.startswith("sub") and f.endswith("metadata.txt"):
            # convert_submaps appends rows as its threads finish, in both packages
            got, want = (x.splitlines() for x in (got, want))
            got, want = [got[0]] + sorted(got[1:]), [want[0]] + sorted(want[1:])
        assert got == want, f


def _metadata(folder, name, xs):
    d = folder / name
    d.mkdir(parents=True)
    with open(d / "metadata.txt", "w") as f:
        f.write("Idx\tDataset\tStartIdx\tEndIdx\tNumPts\tX\tY\tZ\n")
        for i, x in enumerate(xs):
            f.write(f"{i}\t{name}\t\t\t100\t{x}\t{150.0 - 2 * x}\t0.0\n")


def test_prepare_subcommands_equal_jax(tmp_path):
    """train-cases (with and without the test split), submaps (with and
    without --normals) and kitti on a synthetic sequence: the files of the
    port's CLI are byte-equal to JAX's."""
    rs = np.random.RandomState(2)
    poses = _poses(rs, 25)
    calib = np.hstack([_rigid(rs)[0], rs.randn(3, 1)])
    os.makedirs(tmp_path / "kitti" / "velodyne")
    np.savetxt(tmp_path / "kitti" / "poses.txt", poses.reshape(25, 12))
    with open(tmp_path / "kitti" / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(["0.5"] * 12) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in calib.ravel()) + "\n")
    for i in range(25):
        (rs.randn(300, 4) * 6.0).astype(np.float32).tofile(
            str(tmp_path / "kitti" / "velodyne" / f"{i:06d}.bin"))
    os.makedirs(tmp_path / "raw" / "seq")
    raw = []
    for i in range(2):
        raw.append(str(tmp_path / "raw" / "seq" / f"r{i}.bin"))
        _write_submap(raw[-1], rs, num_points=60)
    for tag, main in (("port", prepare), ("jax", jax_prepare)):
        root = tmp_path / tag
        for split in ("split", "all"):
            folder = root / split
            _metadata(folder, "seqA", [0.0, 5.0, 30.0, 60.0])
            _metadata(folder, "seqB", [3.0, 80.0])
            main(["train-cases", "--train_folder", str(folder), "--datasets", "seqA", "seqB"]
                 + (["--no_test_split"] if split == "all" else []))
        main(["submaps", "--out", str(root / "sub")] + raw)
        main(["submaps", "--normals", "--out", str(root / "sub_normals")] + raw)
        main(["kitti", "--poses", str(tmp_path / "kitti" / "poses.txt"),
              "--calib", str(tmp_path / "kitti" / "calib.txt"),
              "--velodyne", str(tmp_path / "kitti" / "velodyne"), "--out", str(root / "k"),
              "--meters_per_cloud", "6"])
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    from feat3dnet_tpu_torch.data.datagenerator import parse_metadata

    meta = parse_metadata(str(tmp_path / "port" / "all" / "train.txt"))
    assert len(meta) == 6 and meta[0].positives == {0, 4} and meta[0].nonnegatives == {1}
