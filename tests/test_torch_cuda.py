"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device (decided
in the fixture, so every worker collects the same tests). The file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

FPS and the ball query must be index-exact; the fused describe kernel
within max |d| 1e-4 and attention relative 1e-4 (f32 products summed in
another order than cuBLAS's). TF32 is off.
"""
import numpy as np
import pytest
import torch

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
from feat3dnet_tpu_torch.ops import fused_describe as tfd
from feat3dnet_tpu_torch.ops.batch_group import ball_query_fused
from feat3dnet_tpu_torch.ops.fps import (farthest_point_sample,
                                         farthest_point_sample_scan)
from feat3dnet_tpu_torch.ops.neighborhoods import ball_query_plain
from feat3dnet_tpu_torch.utils import init_variables

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rs():
    return np.random.RandomState(0)


def test_fps_kernel_matches_plain(dev, rs):
    cloud = load_point_cloud(example_cloud_path("kitti_00_004534.bin"))[:, :3]
    xyz = torch.from_numpy(cloud[None].copy()).to(dev)
    assert torch.equal(farthest_point_sample(xyz, 512), farthest_point_sample_scan(xyz, 512))
    pts = torch.from_numpy(rs.randn(2, 3000, 3).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rs.rand(2, 3000) > 0.5).to(dev)
    assert torch.equal(farthest_point_sample(pts, 100, mask),
                       farthest_point_sample_scan(pts, 100, mask))
    # ties from duplicated points, and a cloud past the shared-memory path
    dup = torch.cat([pts[:1, :500]] * 3, dim=1).contiguous()
    assert torch.equal(farthest_point_sample(dup, 64), farthest_point_sample_scan(dup, 64))
    big = torch.from_numpy(rs.randn(1, 70000, 3).astype(np.float32)).to(dev)
    assert torch.equal(farthest_point_sample(big, 32), farthest_point_sample_scan(big, 32))


@pytest.mark.parametrize("case", ["random", "saturated", "empty", "mask"])
def test_ball_query_kernel_matches_plain(dev, rs, case):
    xyz = rs.randn(2, 3000, 3).astype(np.float32) * (0.1 if case == "saturated" else 2.0)
    ctr = xyz[:, ::30].copy()
    if case == "empty":
        ctr[:, ::2] += 40.0
    mask = rs.rand(2, 3000) > 0.3 if case == "mask" else None
    args = (torch.from_numpy(xyz).to(dev), torch.from_numpy(ctr).to(dev), 1.2, 64,
            None if mask is None else torch.from_numpy(mask).to(dev))
    (ik, ck), (ip, cp) = ball_query_fused(*args), ball_query_plain(*args)
    assert torch.equal(ik, ip) and torch.equal(ck, cp)


def test_fused_describe_kernel_matches_plain(dev, rs):
    cfg = ModelConfig()
    c = (rs.randn(300, cfg.num_samples, 3) * 1.6).astype(np.float32)
    c[5] += 30.0                                   # empty ball -> nearest fallback
    c[7, 32:] = c[7, :32]                          # duplicates -> first-min ties
    c[9, 32:] += 30.0                              # partial ball
    wt = [w.to(dev) for w in tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(cfg, seed=2, bn_perturb=0.1), cfg))]
    packed = torch.from_numpy(tfd.pack_clusters_lanes(c)).to(dev)
    dk, ak = tfd.fused_describe_clusters_t(wt, packed, cfg)
    dp, ap = tfd.fused_describe_clusters_t_plain(wt, packed, cfg)
    assert (dk - dp).abs().max().item() <= 1e-4
    assert ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item() <= 1e-4
