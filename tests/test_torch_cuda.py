"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device (decided
in the fixture, so every worker collects the same tests). The file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

FPS (K1, at every cluster size, with masks and ties across its slices),
the ball query (K2, at every cluster size, at the training shape, past a
round of its widest cluster, all masked, N and M off every boundary; its
per-centre form at every cluster size too, with radii of 0, NaN, below 0
and 1e3, and bit-equal to the scalar form when every radius is equal), the
sorted ball query (K4, also on padding, covered
blocks and a tile that straddles the padding) and the ball max (K5, also
on padding, covered blocks, a constant field and values past its start
values) must be index-exact; the fused describe kernel (K3) within max |d| 1e-4
and attention relative 1e-4 (also at batches of 1 and of an odd size, its
2 clusters a block, and 32 samples, two runs bit-equal), the
detector-only kernel (K6) within attention
relative 1e-5 and orientation 1e-5 rad (also at batches that are not a
multiple of its 2 clusters a block or of its post kernel's 16, batch 0 and
16 samples, two runs bit-equal, a cluster's bits the same wherever it sits
in the batch and on a side stream); their bf16 modes within one bf16 step,
as stated at each test; K3's stream body exact and its matmul bodies within
1e-5 max|ref| of their plain versions (TF32 operands in the pooled convs)
and within ABLATE_F32_LIMIT of the all-f32 ones; the training passes K7-K10 within the
tolerances of tests/test_fused_train.py (means rtol 1e-5, pooled 1e-4,
dW / dgamma / dbeta rtol 5e-3 with atol 5e-4 max|ref|, db atol 1e-3, dx
rtol 5e-3 / atol 5e-5), and bit-equal across two runs. TF32 is off. The
Morton layout built on the card (`build_sorted_cloud`, torch ops, no
kernel of its own) must be bit-equal to the host's numpy build. On a union
of clouds (`build_sorted_cloud_batch`, `segment=`) K4 and K5 must be
index-exact against their plain versions and equal, per cloud, to their
run on that cloud alone; `extract_batch` and `extract_many` (also on
clouds of two buckets) must give each cloud `extract`'s result bit for
bit on both detector routes. A data-parallel step over a one-rank nccl
group (K7-K10 with their all-reduces on the fused route, and the autograd
route) must equal the plain step bit for bit, and `extract` on a mesh
that names the card twice must equal `extract` bit for bit on the
default, fused and dense routes. The chained step (from an int16 upload)
must run with no host sync and equal k fused calls bit for bit, and
remat_towers and the trainer's remat must equal the plain step bit for
bit. K11 (the 3-NN interpolation) must be index-exact against its plain
version, its weights and sums within 1e-6 relative; PointNet++ MSG at
16 384 points must hold to the benchmark's plain reference within the
tier-1 tolerances, and `segment_many` must match a loop of `segment`.
"""
import os
import re

import numpy as np
import pytest
import torch

from feat3dnet_tpu_torch import kernels
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
from feat3dnet_tpu_torch.ops import fused_describe as tfd
from feat3dnet_tpu_torch.ops import fused_train as tft
from feat3dnet_tpu_torch.ops import hash_grid as thg
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


def _bq_case(case, rs):
    """(xyz, centres, mask or None) of a ball-query case at r 1.2, ns 64."""
    if case == "training":
        # the training shape: 18 clouds of 4 096 points, 512 centres each
        xyz = rs.randn(18, 4096, 3).astype(np.float32) * 3.0
        return xyz, xyz[:, ::8].copy(), None
    if case == "70000":
        # past a round of the widest cluster (16 x 8 x 8 chunks of 32 points)
        xyz = rs.randn(1, 70000, 3).astype(np.float32) * 8.0
        return xyz, xyz[:, ::137][:, :512].copy(), None
    if case == "ragged":
        # N and M off every chunk, round and group boundary; duplicates
        xyz = rs.randn(3, 3001, 3).astype(np.float32) * 2.0
        xyz[:, 2000:2300] = xyz[:, 10:310]
        ctr = xyz[:, 5::39][:, :77].copy()
        ctr[:, ::5] += 40.0                                  # empty balls
        return xyz, ctr, rs.rand(3, 3001) > 0.3
    xyz = rs.randn(2, 3000, 3).astype(np.float32) * (0.1 if case == "saturated" else 2.0)
    ctr = xyz[:, ::30].copy()
    if case == "empty":
        ctr[:, ::2] += 40.0
    mask = None
    if case == "mask":
        mask = rs.rand(2, 3000) > 0.3
    elif case == "all_masked":
        mask = np.zeros((2, 3000), bool)
    return xyz, ctr, mask


@pytest.mark.parametrize("case", ["random", "saturated", "empty", "mask", "training", "70000",
                                  "all_masked", "ragged"])
def test_ball_query_kernel_matches_plain(dev, rs, case):
    xyz, ctr, mask = _bq_case(case, rs)
    args = (torch.from_numpy(xyz).to(dev), torch.from_numpy(ctr).to(dev), 1.2, 64,
            None if mask is None else torch.from_numpy(mask).to(dev))
    (ik, ck), (ip, cp) = ball_query_fused(*args), ball_query_plain(*args)
    assert torch.equal(ik, ip) and torch.equal(ck, cp)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", ["random", "saturated", "ragged"])
def test_ball_query_kernel_every_cluster_size(dev, rs, case, cluster):
    """K2 at each cluster size, whatever the wrapper would choose: the split
    of the cloud over the cluster's warps must not move a hit."""
    xyz, ctr, mask = _bq_case(case, rs)
    x, c = torch.from_numpy(xyz).to(dev), torch.from_numpy(ctr).to(dev)
    mk = None if mask is None else torch.from_numpy(mask).to(dev)
    b, m = ctr.shape[:2]
    ik = torch.empty((b, m, 64), dtype=torch.int32, device=dev)
    ck = torch.empty((b, m), dtype=torch.int32, device=dev)
    kernels.launch_ball_query(x, c, mk, float(np.float32(1.2) * np.float32(1.2)), 64, cluster,
                              ik, ck)
    ip, cp = ball_query_plain(x, c, 1.2, 64, mk)
    assert torch.equal(ik, ip) and torch.equal(ck, cp)


def _radii(rs, b, m):
    """Per-centre radii 0.3-2.5 with a zero, a NaN, a negative one and 1e3."""
    r = rs.uniform(0.3, 2.5, (b, m)).astype(np.float32)
    r[:, 0], r[:, 1], r[:, 2], r[:, 3] = 0.0, np.nan, -r[:, 4], 1e3
    return r


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", ["random", "saturated", "ragged", "training"])
def test_ball_query_radii_kernel_every_cluster_size(dev, rs, case, cluster):
    """K2's per-centre form at each cluster size against the plain version."""
    xyz, ctr, mask = _bq_case(case, rs)
    x, c = torch.from_numpy(xyz).to(dev), torch.from_numpy(ctr).to(dev)
    mk = None if mask is None else torch.from_numpy(mask).to(dev)
    b, m = ctr.shape[:2]
    radii = torch.from_numpy(_radii(rs, b, m)).to(dev)
    ik = torch.empty((b, m, 64), dtype=torch.int32, device=dev)
    ck = torch.empty((b, m), dtype=torch.int32, device=dev)
    kernels.launch_ball_query(x, c, mk, 0.0, 64, cluster, ik, ck, radii=radii)
    ip, cp = ball_query_plain(x, c, radii, 64, mk)
    assert torch.equal(ik, ip) and torch.equal(ck, cp)


def test_ball_query_radii_through_the_wrapper(dev, rs):
    xyz, ctr, mask = _bq_case("ragged", rs)
    x, c, mk = (torch.from_numpy(a).to(dev) for a in (xyz, ctr, mask))
    radii = torch.from_numpy(_radii(rs, *ctr.shape[:2])).to(dev)
    n0, r0 = ball_query_fused.launches, ball_query_fused.mode_launches["radii"]
    ik, ck = ball_query_fused(x, c, radii, 64, mk)
    ip, cp = ball_query_plain(x, c, radii, 64, mk)
    assert torch.equal(ik, ip) and torch.equal(ck, cp)
    assert ball_query_fused.launches == n0 + 1
    assert ball_query_fused.mode_launches["radii"] == r0 + 1
    with pytest.raises(ValueError):
        ball_query_fused(x, c, radii.cpu(), 64, mk)


@pytest.mark.parametrize("case", ["random", "mask", "training", "70000"])
def test_ball_query_radii_equal_is_scalar(dev, rs, case):
    """Every radius equal: the per-centre launch bit-equal to the scalar one."""
    xyz, ctr, mask = _bq_case(case, rs)
    x, c = torch.from_numpy(xyz).to(dev), torch.from_numpy(ctr).to(dev)
    mk = None if mask is None else torch.from_numpy(mask).to(dev)
    radii = torch.full(ctr.shape[:2], 1.2, dtype=torch.float32, device=dev)
    (ir, cr), (i_s, cs) = ball_query_fused(x, c, radii, 64, mk), ball_query_fused(x, c, 1.2, 64, mk)
    assert torch.equal(ir, i_s) and torch.equal(cr, cs)


def test_ball_query_shape_is_the_sources(dev):
    """The wrapper sizes K2's cluster from the library's kWarps, kChunks and
    kMaxCluster: they must be csrc/ball_query.cu's."""
    with open(os.path.join(kernels.CSRC_DIR, "ball_query.cu")) as f:
        src = f.read()
    want = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kWarps", "kChunks", "kMaxCluster"))
    assert kernels.ball_query_shape() == want


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


def _sorted_cloud(rs, n, dev, block=64, spread=12.0):
    xyz = ((rs.rand(n, 3) - 0.5) * spread).astype(np.float32)
    xyz[: n // 3] = xyz[rs.randint(0, 5, n // 3)] + rs.randn(n // 3, 3).astype(np.float32) * 0.4
    valid = rs.rand(n) > 0.1
    return thg.build_sorted_cloud_host(xyz, valid, cell_size=2.0, block_size=block).to(dev)


@pytest.mark.parametrize("cell", [2.0, 0.7])
def test_device_layout_matches_host(dev, rs, cell):
    """f32 division by the cell size, clamp before the cast, non-finite and
    masked points, duplicates and pad rows: bit-equal on the card."""
    xyz = ((rs.rand(5000, 3) - 0.5) * 40.0).astype(np.float32)
    xyz[100:400] = xyz[:300]
    xyz[7], xyz[9, 2] = np.nan, np.inf
    valid = rs.rand(5000) > 0.2
    host = thg.build_sorted_cloud_host(xyz, valid, cell_size=cell, block_size=256)
    got = thg.build_sorted_cloud(torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev),
                                 cell_size=cell, block_size=256)
    for f in ("pts4", "blk_bbox", "orig_idx", "inv_perm"):
        assert np.array_equal(getattr(got, f).cpu().numpy(), getattr(host, f)), f

@pytest.mark.parametrize("ns,tile,block", [(8, 16, 32), (64, 256, 256), (33, 40, 64)])
def test_sorted_ball_query_kernel_matches_plain(dev, rs, ns, tile, block):
    sc = _sorted_cloud(rs, 3000, dev, block=block)
    ctr = torch.cat([sc.pts4[:, :3], sc.pts4[:50, :3] + 30.0]).contiguous()   # + empty balls
    n0 = thg.sorted_ball_query.launches
    tk, ck = thg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, 2.0, ns, tile=tile)
    tp, cp = thg.sorted_ball_query_plain(sc.pts4, ctr, 2.0, ns)
    torch.cuda.synchronize()
    assert thg.sorted_ball_query.launches == n0 + 1
    assert torch.equal(ck, cp) and torch.equal(tk, tp)
    assert (ck > ns).float().mean().item() > 0.1            # saturated balls present


@pytest.mark.parametrize("case", ["quarter_padding", "covered_cluster", "straddle_tile256"])
def test_sorted_ball_query_kernel_walk_cases(dev, rs, case):
    """The per-centre cull's edge cases: padding centres (every padding
    block lies inside their ball and counts without a test), blocks wholly
    inside a real ball, and a tile of 256 centres whose box spans the last
    real points and the padding at +1e9."""
    n, bucket, block, tile = {"quarter_padding": (3000, 4096, 64, 128),
                              "covered_cluster": (3000, 3072, 32, 64),
                              "straddle_tile256": (3900, 4096, 256, 256)}[case]
    xyz = ((rs.rand(n, 3) - 0.5) * 30.0).astype(np.float32)
    if case == "covered_cluster":
        xyz[:2000] = rs.randn(2000, 3).astype(np.float32) * 0.2
    padded = np.zeros((bucket, 3), np.float32)
    padded[:n] = xyz
    sc = thg.build_sorted_cloud_host(padded, np.arange(bucket) < n, cell_size=2.0,
                                     block_size=block).to(dev)
    ctr = sc.pts4[:, :3].contiguous()                         # padding centres too
    tk, ck = thg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, 2.0, 64, tile=tile)
    tp, cp = thg.sorted_ball_query_plain(sc.pts4, ctr, 2.0, 64)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and torch.equal(tk, tp)
    pad = ctr[:, 0] > 5e8
    assert bool((ck[pad] == bucket - n).all())                # every padding point counted
    if case == "covered_cluster":
        assert (ck > 1000).any()                               # whole blocks inside a ball


@pytest.mark.parametrize("tile", [32, 256, 512])
def test_ball_max_kernel_matches_plain(dev, rs, tile):
    sc = _sorted_cloud(rs, 4000, dev)
    vals = torch.from_numpy(rs.rand(sc.pts4.shape[0]).astype(np.float32)).to(dev)
    vals[100:140] = 0.75                                     # exact ties
    got = thg.ball_max_sorted(sc.pts4, sc.blk_bbox, vals, 0.5, tile=tile)
    want = thg.ball_max_plain(sc.pts4, vals, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    sub = sc.pts4[1000:1333, :3].contiguous()
    assert torch.equal(thg.ball_max_sorted(sc.pts4, sc.blk_bbox, vals, 0.5, centers=sub),
                       want[1000:1333])


@pytest.mark.parametrize("tile", [32, 256, 512])
@pytest.mark.parametrize("case", ["padding", "covered", "constant", "huge_values"])
def test_ball_max_kernel_cases(dev, rs, case, tile):
    """K5's pre-pass and walk on their edge cases, every sorted row a centre
    (the own block first) and given centres (padding, NaN and +2e9 rows
    among them): a bucket a quarter padding (padding tiles list nothing),
    blocks wholly inside the ball (their maximum serves untested), a
    constant field (every block after the own one skipped by value) and
    values past 1e30 on padding rows (a padding centre's ball max rises past
    its start, so its tile may not drop those blocks)."""
    n, bucket, block = {"padding": (3000, 4096, 64), "covered": (3000, 3072, 32),
                        "constant": (3000, 4096, 64), "huge_values": (3000, 4096, 32)}[case]
    xyz = ((rs.rand(n, 3) - 0.5) * 20.0).astype(np.float32)
    if case == "covered":
        xyz[:2000] = rs.randn(2000, 3).astype(np.float32) * 0.03
    padded = np.zeros((bucket, 3), np.float32)
    padded[:n] = xyz
    sc = thg.build_sorted_cloud_host(padded, np.arange(bucket) < n, cell_size=2.0,
                                     block_size=block).to(dev)
    vals = torch.from_numpy(rs.rand(bucket).astype(np.float32)).to(dev)
    if case == "constant":
        vals.fill_(0.5)
    if case == "huge_values":
        vals[sc.pts4[:, 0] > 5e8] = 2e30
    n0 = thg.ball_max_sorted.launches
    got = thg.ball_max_sorted(sc.pts4, sc.blk_bbox, vals, 0.5, tile=tile)
    want = thg.ball_max_plain(sc.pts4, vals, 0.5)
    torch.cuda.synchronize()
    assert thg.ball_max_sorted.launches == n0 + 1
    assert torch.equal(got, want)
    pad = sc.pts4[:, 0] > 5e8
    assert bool((want[pad] == (2e30 if case == "huge_values" else 1e30)).all())
    ctr = torch.cat([sc.pts4[::7, :3], torch.full((5, 3), float("nan"), device=dev),
                     torch.full((5, 3), 2e9, device=dev), sc.pts4[-9:, :3]]).contiguous()
    assert torch.equal(thg.ball_max_sorted(sc.pts4, sc.blk_bbox, vals, 0.5, tile=tile,
                                           centers=ctr),
                       thg.ball_max_plain(sc.pts4, vals, 0.5, centers=ctr))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [4096, 16384, 30609, 70000])
@pytest.mark.parametrize("b", [1, 3, 18])
def test_fps_kernel_cluster_sizes(dev, rs, b, n, masked):
    """K1 at every cluster size it takes (1-16 blocks a cloud; a slice past
    shared memory on the scratch path) and through the wrapper (its own
    choice): index-exact against the plain version, with duplicated points
    and, masked, a wholly masked slice and an all-masked cloud."""
    from feat3dnet_tpu_torch import kernels
    from feat3dnet_tpu_torch.ops import fps as tfps

    xyz = rs.randn(b, n, 3).astype(np.float32) * 10.0
    xyz[:, n // 2:n // 2 + 64] = xyz[:, :64]                  # ties across slices
    mask = None
    if masked:
        m = rs.rand(b, n) > 0.3
        m[0, : n // 4] = False                                 # whole slices masked
        if b > 1:
            m[1] = False                                       # an all-masked cloud
        mask = torch.from_numpy(m).to(dev)
    x = torch.from_numpy(xyz).to(dev)
    npoint = 128
    want = farthest_point_sample_scan(x, npoint, mask)
    assert torch.equal(farthest_point_sample(x, npoint, mask), want)
    for cluster in (1, 2, 4, 8, 16):
        scratch = (torch.empty((b, n), device=dev)
                   if n > kernels.fps_max_smem_points(cluster) else None)
        out = torch.empty((b, npoint), dtype=torch.int32, device=dev)
        kernels.launch_fps(x, mask, scratch, npoint, cluster, out)
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"cluster {cluster}"
    assert tfps.fps_cluster_size(n) in (1, 2, 4, 8, 16)


def test_fused_detect_kernel_matches_plain(dev, rs):
    cfg = ModelConfig()
    c = (rs.randn(300, cfg.num_samples, 3) * 1.6).astype(np.float32)
    c[5] += 30.0                                   # empty ball -> nearest fallback
    c[7, 32:] = c[7, :32]                          # repeat-padded duplicates
    wt = [w.to(dev) for w in tfd.transpose_unfolded_detector(
        tfd.detector_weights_unfolded(init_variables(cfg, seed=2, bn_perturb=0.1), cfg))]
    x = torch.from_numpy(c).to(dev)
    ak, ok = tfd.fused_detect_clusters(wt, x, cfg, unfolded=True)
    ap, op = tfd.fused_detect_clusters_plain(wt, x, cfg, unfolded=True)
    torch.cuda.synchronize()
    assert ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item() <= 1e-5
    d = ok - op
    assert ((d + np.pi) % (2 * np.pi) - np.pi).abs().max().item() <= 1e-5


def _k3_case(rs, dev):
    cfg = ModelConfig()
    c = (rs.randn(300, cfg.num_samples, 3) * 1.6).astype(np.float32)
    c[5] += 30.0                                   # empty ball -> nearest fallback
    c[7, 32:] = c[7, :32]                          # duplicates -> first-min ties
    c[9, 32:] += 30.0                              # partial ball
    wt = [w.to(dev) for w in tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(cfg, seed=2, bn_perturb=0.1), cfg))]
    return cfg, wt, torch.from_numpy(tfd.pack_clusters_lanes(c)).to(dev)


def test_fused_describe_bf16_kernel_matches_plain(dev, rs):
    """bf16 activations: the products are exact on both sides, the f32 sums
    run in another order and may flip a bf16 rounding: descriptors within
    one bf16 step (2^-8) and cosine >= 0.9999, attention relative 1e-2."""
    cfg, wt, packed = _k3_case(rs, dev)
    n0 = tfd.fused_describe_clusters_t.mode_launches["bf16"]
    dk, ak = tfd.fused_describe_clusters_t(wt, packed, cfg, bf16_act=True)
    dp, ap = tfd.fused_describe_clusters_t_plain(wt, packed, cfg, bf16_act=True)
    torch.cuda.synchronize()
    assert tfd.fused_describe_clusters_t.mode_launches["bf16"] == n0 + 1
    assert (dk - dp).abs().max().item() <= 2.0 ** -8
    assert torch.nn.functional.cosine_similarity(dk, dp, dim=1).min().item() >= 0.9999
    assert ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item() <= 1e-2


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("batch,ns", [(1, 64), (3, 64), (257, 64), (300, 32)])
def test_fused_describe_block_shapes(dev, rs, mode, batch, ns):
    """K3 runs 2 clusters a block: a batch of 1 and odd batches (the last
    block's second cluster masked), and 32 samples, against the plain
    version at test_fused_describe_kernel_matches_plain's limits (f32) or
    test_fused_describe_bf16_kernel_matches_plain's (bf16), two runs
    bit-equal; with the weights packed once (packed=), as the server
    calls it, bit-equal to a call that packs them."""
    cfg = ModelConfig(num_samples=ns)
    c = (rs.randn(batch, ns, 3) * 1.6).astype(np.float32)
    c[0, ns // 2:] = c[0, 0]                       # repeats of slot 0 (a ball query's padding)
    if batch > 5:
        c[5] += 30.0                               # empty ball -> nearest fallback
    wt = [w.to(dev) for w in tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(cfg, seed=2, bn_perturb=0.1), cfg))]
    packed = torch.from_numpy(tfd.pack_clusters_lanes(c)).to(dev)
    kw = {"bf16_act": mode == "bf16"}
    pk = tfd._describe_kernel_weights(wt, cfg, dev, mode)
    dk, ak = tfd.fused_describe_clusters_t(wt, packed, cfg, packed=pk, **kw)
    d2, a2 = tfd.fused_describe_clusters_t(wt, packed, cfg, **kw)
    dp, ap = tfd.fused_describe_clusters_t_plain(wt, packed, cfg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dk, d2) and torch.equal(ak, a2)
    a_rel = ((ak - ap).abs() / ap.abs().clamp(min=1e-6)).max().item()
    if mode == "f32":
        assert (dk - dp).abs().max().item() <= 1e-4 and a_rel <= 1e-4
    else:
        assert (dk - dp).abs().max().item() <= 2.0 ** -8 and a_rel <= 1e-2
        assert torch.nn.functional.cosine_similarity(dk, dp, dim=1).min().item() >= 0.9999


@pytest.mark.parametrize("ablate", ["stream", "matmul", "matmul_2d"])
def test_fused_describe_ablate_kernel_matches_plain(dev, rs, ablate):
    """stream exact; matmul and matmul_2d (unnormalised sums) within 1e-5
    max|ref| of their plain versions, whose pooled convs take TF32 operands
    as the kernel's tiles do, and within ABLATE_F32_LIMIT of max|ref| of
    the same bodies in f32."""
    cfg, wt, packed = _k3_case(rs, dev)
    dk, ak = tfd.fused_describe_clusters_t(wt, packed, cfg, ablate=ablate)
    dp, ap = tfd.fused_describe_clusters_t_plain(wt, packed, cfg, ablate=ablate)
    torch.cuda.synchronize()
    if ablate == "stream":
        assert torch.equal(dk, dp) and torch.equal(ak, ap)
        return
    assert (dk - dp).abs().max().item() <= 1e-5 * dp.abs().max().item()
    assert (ak - ap).abs().max().item() <= 1e-5 * ap.abs().max().item()
    d0, a0 = tfd._describe_ablate_plain(wt, packed.reshape(cfg.num_samples, 8, -1), cfg, ablate,
                                        tf32=False)
    limit = tfd.ABLATE_F32_LIMIT
    assert (dk - d0).abs().max().item() <= limit * d0.abs().max().item()
    assert (ak - a0).abs().max().item() <= limit * a0.abs().max().item()


@pytest.mark.parametrize("mode", ["folded", "bf16_operands"])
def test_fused_detect_modes_match_plain(dev, rs, mode):
    """folded: attention relative 1e-5, orientation 1e-5 rad. bf16_operands:
    both within 1e-4 on >= 99.9 % of centres (a flipped bf16 rounding moves
    an activation by 2^-8; the kernel read 6e-7 against its plain version at
    the extraction shapes), and the f32 kernel must fail that limit against
    the plain bf16_operands version, so the check can tell a kernel that
    skips the rounding."""
    cfg = ModelConfig()
    c = (rs.randn(300, cfg.num_samples, 3) * 1.6).astype(np.float32)
    c[5] += 30.0
    c[7, 32:] = c[7, :32]
    v = init_variables(cfg, seed=2, bn_perturb=0.1)
    if mode == "folded":
        wt, kw, tol = tfd.transpose_folded_weights(tfd.folded_weights(v, cfg)), {}, 1e-5
    else:
        wt = tfd.transpose_unfolded_detector(tfd.detector_weights_unfolded(v, cfg))
        kw, tol = dict(unfolded=True, bf16_operands=True), 1e-4
    wt = [w.to(dev) for w in wt]
    x = torch.from_numpy(c).to(dev)
    n0 = tfd.fused_detect_clusters.mode_launches[mode]
    ak, ok = tfd.fused_detect_clusters(wt, x, cfg, **kw)
    ap, op = tfd.fused_detect_clusters_plain(wt, x, cfg, **kw)
    torch.cuda.synchronize()
    assert tfd.fused_detect_clusters.mode_launches[mode] == n0 + 1

    def within(a, o):
        a_rel = (a - ap).abs() / ap.abs().clamp(min=1e-6)
        o_err = ((o - op + np.pi) % (2 * np.pi) - np.pi).abs()
        return ((a_rel <= tol) & (o_err <= tol)).float().mean().item()

    if mode == "folded":
        assert within(ak, ok) == 1.0
    else:
        assert within(ak, ok) >= 0.999
        af, of = tfd.fused_detect_clusters(wt, x, cfg, unfolded=True)
        assert within(af, of) < 0.999


def _k6_weights(cfg, mode, dev):
    v = init_variables(cfg, seed=2, bn_perturb=0.1)
    if mode == "folded":
        wt, kw = tfd.transpose_folded_weights(tfd.folded_weights(v, cfg)), {}
    else:
        wt = tfd.transpose_unfolded_detector(tfd.detector_weights_unfolded(v, cfg))
        kw = dict(unfolded=True, bf16_operands=mode == "bf16_operands")
    return [w.to(dev) for w in wt], kw


def _k6_held(mode, got, want):
    """f32 modes: attention relative and orientation within 1e-5 on every
    centre; bf16_operands: >= 99.9 % of centres within 1e-4."""
    (ak, ok), (ap, op) = got, want
    tol = 1e-4 if mode == "bf16_operands" else 1e-5
    a_rel = (ak - ap).abs() / ap.abs().clamp(min=1e-6)
    o_err = ((ok - op + np.pi) % (2 * np.pi) - np.pi).abs()
    share = ((a_rel <= tol) & (o_err <= tol)).float().mean().item() if ak.numel() else 1.0
    assert share >= (0.999 if mode == "bf16_operands" else 1.0), share


@pytest.mark.parametrize("mode", ["unfolded", "folded", "bf16_operands"])
@pytest.mark.parametrize("batch", [0, 1, 3, 15, 16, 17, 33, 129, 300])
def test_fused_detect_block_shapes(dev, rs, mode, batch):
    """K6 runs 2 clusters a block, then its post convs and heads 16 clusters
    a block: batches that are not a multiple of either, and batch 0, give
    the plain version's outputs at the mode's limit, and two runs give the
    same bits."""
    cfg = ModelConfig()
    c = (rs.randn(max(batch, 10), cfg.num_samples, 3) * 1.6).astype(np.float32)
    c[5] += 30.0                                   # empty ball -> nearest fallback
    c[7, 32:] = c[7, :32]                          # repeat-padded duplicates
    c[9, 32:] += 30.0                              # partial ball
    x = torch.from_numpy(c[:batch].copy()).to(dev)
    wt, kw = _k6_weights(cfg, mode, dev)
    got = tfd.fused_detect_clusters(wt, x, cfg, **kw)
    again = tfd.fused_detect_clusters(wt, x, cfg, **kw)
    want = tfd.fused_detect_clusters_plain(wt, x, cfg, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (batch,) and got[1].shape == (batch,)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _k6_held(mode, got, want)


@pytest.mark.parametrize("mode", ["unfolded", "folded", "bf16_operands"])
def test_fused_detect_outputs_do_not_depend_on_the_batch(dev, rs, mode):
    """A cluster's outputs are the same bits wherever it sits in the batch
    and on whichever stream K6 runs (its pooled vectors pass through a
    stream-ordered scratch buffer between its two kernels): a batch of 300
    against its first 37 and its last 263 clusters, on a side stream."""
    cfg = ModelConfig()
    c = (rs.randn(300, cfg.num_samples, 3) * 1.6).astype(np.float32)
    c[5] += 30.0
    c[7, 32:] = c[7, :32]
    x = torch.from_numpy(c).to(dev)
    wt, kw = _k6_weights(cfg, mode, dev)
    whole = tfd.fused_detect_clusters(wt, x, cfg, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        head = tfd.fused_detect_clusters(wt, x[:37].contiguous(), cfg, **kw)
        tail = tfd.fused_detect_clusters(wt, x[37:].contiguous(), cfg, **kw)
    torch.cuda.synchronize()
    for i in range(2):
        assert torch.equal(torch.cat([head[i], tail[i]]), whole[i])


@pytest.mark.parametrize("mode", ["unfolded", "folded", "bf16_operands"])
def test_fused_detect_few_samples(dev, rs, mode):
    """num_samples 16 < 64: the pad slots take no part."""
    cfg = ModelConfig(num_samples=16)
    c = (rs.randn(131, 16, 3) * 1.6).astype(np.float32)
    c[5] += 30.0
    c[7, 8:] = c[7, :8]
    x = torch.from_numpy(c).to(dev)
    wt, kw = _k6_weights(cfg, mode, dev)
    got = tfd.fused_detect_clusters(wt, x, cfg, **kw)
    want = tfd.fused_detect_clusters_plain(wt, x, cfg, **kw)
    torch.cuda.synchronize()
    _k6_held(mode, got, want)


def _tower_case(rs, dev, plan_kind, g_total, gp, ns=16):
    if plan_kind == "single":
        widths = (16,)
        plan = tft.detector_plan(1)
    elif plan_kind == "detector":
        widths = (8, 16, 32)
        plan = tft.detector_plan(3)
    elif plan_kind == "detector_paper":
        widths = (64, 128, 256)
        plan = tft.detector_plan(3)
    elif plan_kind == "descriptor_paper":
        widths = (32, 64, 128)
        plan = tft.descriptor_plan(2, 1)
    else:
        widths = (8, 16, 24, 16)
        plan = tft.descriptor_plan(2, 2)
    x = rs.randn(ns, gp, 3).astype(np.float32)
    x[ns // 2:, :g_total // 2] = x[0:1, :g_total // 2]      # repeat-pad ties
    flat = []
    for ci, co in tft.plan_conv_widths(plan, widths, 3):
        flat += [rs.randn(ci, co) * 0.4, rs.randn(co) * 0.1, 1 + 0.2 * rs.randn(co),
                 0.1 * rs.randn(co)]
    flat = [torch.from_numpy(np.asarray(f, np.float32)).to(dev) for f in flat]
    return torch.from_numpy(x).to(dev), plan, widths, flat


def _close(got, want, rtol, atol_rel=None, atol=0.0):
    if atol_rel is not None:
        atol = atol_rel * max(want.abs().max().item(), 1e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("plan_kind,g_total,gp,ns", [
    ("detector", 96, 96, 16), ("detector", 80, 96, 16), ("descriptor", 80, 96, 16),
    ("detector_paper", 40, 48, 64), ("descriptor_paper", 40, 48, 64), ("single", 40, 48, 13)])
@pytest.mark.parametrize("cot", [torch.float32, torch.bfloat16])
def test_train_passes_match_plain(dev, rs, plan_kind, g_total, gp, ns, cot):
    """Two cases are at the paper widths with 64 slots: the tensor-core
    tiles unpadded, and the descriptor's poolcat conv 128 -> 128, whose
    input carries the broadcast half at the padded row stride. The last is
    one conv on the 3-wide input: the top conv's pool taken on the CUDA
    cores, with 51 pad slots."""
    x, plan, widths, flat = _tower_case(rs, dev, plan_kind, g_total, gp, ns)
    ns, n = x.shape[0], len(widths)
    count = float(ns * g_total)
    folded, means, isigs = [], [], []
    for j in range(n):
        w, b, g, be = flat[4 * j:4 * j + 4]
        st_k = tft.stats_pass(x, plan, folded, w, b, g_total)
        st_p = tft.stats_pass.plain(x, plan, folded, w, b, g_total)
        _close(st_k[0] / count, st_p[0] / count, 1e-5, atol=1e-6)
        _close(st_k[1] / count, st_p[1] / count, 1e-5, atol=1e-6)
        mean, var, a, c, isig = tft._finalize_stats(st_p, count, g, be, 1e-3)
        folded.append((w, b, a, c))
        means.append(mean)
        isigs.append(isig)
    pk, pp = tft.final_pass(x, plan, folded), tft.final_pass.plain(x, plan, folded)
    assert (pk[:g_total] - pp[:g_total]).abs().max().item() <= 1e-4
    dpool = torch.from_numpy(rs.randn(gp, widths[-1]).astype(np.float32)).to(dev)
    dpool[g_total:] = 0.0
    bk = tft.bwd_top_pass(x, plan, folded, means[-1], isigs[-1], dpool)
    bp = tft.bwd_top_pass.plain(x, plan, folded, means[-1], isigs[-1], dpool)
    _close(bk, bp, 5e-3, atol_rel=5e-4)
    src, bst = dpool, bp
    for j in range(n - 1, -1, -1):
        args = (x, plan, folded[:j + 1], means[j], isigs[j], src, bst[0] / count,
                bst[1] / count, flat[4 * j + 2] * isigs[j], means[j - 1] if j else None,
                isigs[j - 1] if j else None, g_total, cot)
        dw_k, db_k, out_k, bst_k = tft.bwd_pass(*args)
        dw_p, db_p, out_p, bst_p = tft.bwd_pass.plain(*args)
        again = tft.bwd_pass(*args)
        assert torch.equal(again[0], dw_k) and torch.equal(again[2], out_k)
        _close(dw_k, dw_p, 5e-3, atol_rel=5e-4)
        _close(db_k, db_p, 0.0, atol=1e-3)
        if j > 0:
            assert out_k.dtype == cot
            # the cotangent type's rounding: one step of it either way
            _close(out_k, out_p, 8e-3 if cot == torch.bfloat16 else 5e-3, atol=5e-5)
            _close(bst_k, bst_p, 5e-3, atol_rel=5e-4)
            src, bst = out_p, bst_p
        else:
            _close(out_k, out_p, 5e-3, atol=5e-5)
            assert not out_k[:, g_total:].any()


def test_train_tower_autograd_matches_cpu(dev, rs):
    """tower_prepool_fused on the card (K7-K10 inside the autograd Function)
    against the same function on the CPU (the plain passes)."""
    x, plan, widths, flat = _tower_case(rs, dev, "descriptor", 80, 96)
    lw = torch.from_numpy(rs.randn(80, widths[-1]).astype(np.float32))
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = x.detach().to(d, copy=True).requires_grad_(True)
        fs = [f.detach().to(d, copy=True).requires_grad_(True) for f in flat]
        pooled, (means, _) = tft.tower_prepool_fused(xs, fs, plan, widths, 16, 80, 1e-3,
                                                     torch.float32)
        (pooled[:80] * lw.to(d)).sum().backward()
        grads.append([xs.grad.cpu()] + [f.grad.cpu() for f in fs] + [means[-1].cpu()])
    _close(grads[0][0], grads[1][0], 5e-3, atol=5e-5)
    for i, (a, b) in enumerate(zip(grads[0][1:-1], grads[1][1:-1])):
        if i % 4 == 1:
            _close(a, b, 0.0, atol=1e-3)
        else:
            _close(a, b, 5e-3, atol_rel=5e-4)
    _close(grads[0][-1], grads[1][-1], 1e-5, atol=1e-6)


def _union_on_card(rs, dev, sizes, bucket, block):
    """Clouds padded to one bucket, their layouts built in one union on the
    card (build_sorted_cloud_batch), overlapping in space."""
    xyz = np.zeros((len(sizes), bucket, 3), np.float32)
    for i, n in enumerate(sizes):
        xyz[i, :n] = ((rs.rand(n, 3) - 0.5) * 20.0).astype(np.float32)
    valid = np.arange(bucket)[None, :] < np.asarray(sizes)[:, None]
    return thg.build_sorted_cloud_batch(torch.from_numpy(xyz).to(dev),
                                        torch.from_numpy(valid).to(dev), cell_size=2.0,
                                        block_size=block)


@pytest.mark.parametrize("block,tile", [(64, 128), (256, 256)])
def test_sorted_ball_query_kernel_segment_matches_plain(dev, rs, block, tile):
    """K4 on a union of three clouds with segment=: index-exact against the
    plain version (same-cloud pairs only) and each cloud's rows equal to
    K4 on that cloud alone."""
    bucket = 4096
    sc = _union_on_card(rs, dev, (3000, 900, 4096), bucket, block)
    ctr = sc.pts4[:, :3].contiguous()
    tk, ck = thg.sorted_ball_query(sc.pts4, sc.blk_bbox, ctr, 2.0, 64, tile=tile,
                                   segment=bucket)
    tp, cp = thg.sorted_ball_query_plain(sc.pts4, ctr, 2.0, 64, segment=bucket)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and torch.equal(tk, tp)
    nb = sc.blk_bbox.shape[0] // 3
    for i in range(3):
        rows = slice(i * bucket, (i + 1) * bucket)
        ta, ca = thg.sorted_ball_query(sc.pts4[rows], sc.blk_bbox[i * nb:(i + 1) * nb],
                                       ctr[rows], 2.0, 64, tile=tile)
        assert torch.equal(tk[rows], ta) and torch.equal(ck[rows], ca)


@pytest.mark.parametrize("tile", [128, 512])
def test_ball_max_kernel_segment_matches_plain(dev, rs, tile):
    """K5 with segment=: exact against the plain version and each cloud's
    maxima equal to K5 on that cloud alone (values tied across clouds)."""
    bucket = 4096
    sc = _union_on_card(rs, dev, (2500, 4096, 1200), bucket, 64)
    vals = torch.from_numpy(rs.rand(3 * bucket).astype(np.float32)).to(dev)
    vals[::bucket] = 0.999                                   # ties across the clouds
    got = thg.ball_max_sorted(sc.pts4, sc.blk_bbox, vals, 0.5, tile=tile, segment=bucket)
    want = thg.ball_max_plain(sc.pts4, vals, 0.5, segment=bucket)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    nb = sc.blk_bbox.shape[0] // 3
    for i in range(3):
        rows = slice(i * bucket, (i + 1) * bucket)
        alone = thg.ball_max_sorted(sc.pts4[rows], sc.blk_bbox[i * nb:(i + 1) * nb],
                                    vals[rows], 0.5, tile=tile)
        assert torch.equal(got[rows], alone)


@pytest.mark.parametrize("fused", [False, True])
def test_extract_batch_and_many_match_extract(dev, rs, fused):
    """extract_batch and extract_many (batch 1 and 2, an odd tail) on the
    card give each cloud extract's result bit for bit, also with a cloud
    of bucket 4 096 among clouds of 8 192 at the default keypoint_chunk
    (extract_batch pads it to 8 192; its detector chunks stay 4 096)."""
    from feat3dnet_tpu_torch.config import InferenceConfig
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet

    cfg = ModelConfig()
    pipe = InferencePipeline(Feat3DNet(cfg), init_variables(cfg, seed=0, bn_perturb=0.1), cfg,
                             InferenceConfig(use_fused_detector=fused), device=dev)
    clouds = [((rs.rand(n, 3) - 0.5) * np.float32(40.0)).astype(np.float32)
              for n in (6000, 7500, 5000, 3000)]
    want = [pipe.extract(c) for c in clouds]
    for got in (pipe.extract_batch(clouds), pipe.extract_many(clouds),
                pipe.extract_many(clouds, batch_size=2)):
        for g, w in zip(got, want):
            assert g.num_keypoints == w.num_keypoints > 0
            for f in ("keypoints", "attention", "features"):
                assert np.array_equal(getattr(g, f), getattr(w, f)), f



@pytest.mark.parametrize("route", ["fused", "autograd"])
def test_world_of_one_nccl_is_the_plain_step(dev, rs, tmp_path, route):
    """A data-parallel step over a one-rank nccl group on the card (K7-K10
    with their all-reduces between the launches on the fused route) equals
    the plain step bit for bit: a sum over one rank is the identity."""
    import torch.distributed as dist

    from feat3dnet_tpu_torch.config import TrainConfig
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.parallel import make_fused_dp_train_step
    from feat3dnet_tpu_torch.train.trainer import init_state, make_fused_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(fused_towers=route == "fused")
    a = rs.randn(2, 4096, 3).astype(np.float32) * 6.0
    stacked = torch.from_numpy(np.concatenate([a, a + 0.01 * rs.randn(*a.shape),
                                               a + 0.2 * rs.randn(*a.shape)]
                                              ).astype(np.float32)).to(dev)

    def run(group):
        model = Feat3DNet(cfg, bn_group=group)
        state = init_state(model, TrainConfig(), cfg, variables=init_variables(cfg, seed=0),
                           device=dev)
        make = (make_fused_train_step if group is None else
                lambda *a, **k: make_fused_dp_train_step(*a, group, **k))
        step = make(model, cfg.margin, cfg.attention, augmentations=("RotateSmall", "Jitter"),
                    aug_seed=1)
        tft.stats_pass.launches = tft.bwd_pass.launches = 0
        for _ in range(2):
            state, metrics = step(state, stacked)
        torch.cuda.synchronize()
        if route == "fused":
            assert tft.stats_pass.launches > 0 and tft.bwd_pass.launches > 0
        return ([p.grad.clone() for p in model.parameters()],
                [p.detach().clone() for p in model.parameters()],
                [b.clone() for b in model.buffers()], metrics)

    want = run(None)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        got = run(dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    def flat(metrics):
        return [x for k in sorted(metrics) for x in (
            [metrics[k][f] for f in sorted(metrics[k])] if isinstance(metrics[k], dict)
            else [metrics[k]])]

    for g, w in zip(got[:3] + (flat(got[3]),), want[:3] + (flat(want[3]),)):
        assert len(g) == len(w) and all(torch.equal(x, y) for x, y in zip(g, w))


@pytest.mark.parametrize("route", ["hashed", "fused", "dense"])
def test_mesh_of_one_card_twice_matches_extract(dev, rs, route):
    """InferencePipeline(mesh=(cuda:0, cuda:0)) extract on a vendored KITTI
    cloud (bucket 32 768: two detector chunks a shard) equals extract bit
    for bit, with K4, K5 (and K6, K3 on the fused route) launched per shard."""
    from feat3dnet_tpu_torch.config import InferenceConfig
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet

    cfg = ModelConfig()
    icfg = InferenceConfig(use_hashed_grouping=route != "dense",
                           use_fused_detector=route == "fused")
    model = Feat3DNet(cfg)
    pipe = InferencePipeline(model, init_variables(cfg, seed=0, bn_perturb=0.1), cfg, icfg,
                             device=dev)
    meshed = InferencePipeline(model, None, cfg, icfg, mesh=(dev, dev))
    cloud = load_point_cloud(example_cloud_path("kitti_00_001554.bin"))
    want = pipe.extract(cloud)
    tfd.fused_detect_clusters.launches = thg.sorted_ball_query.launches = 0
    got = meshed.extract(cloud)
    if route != "dense":
        assert thg.sorted_ball_query.launches == 2
    if route == "fused":
        assert tfd.fused_detect_clusters.launches == 2
    assert got.num_keypoints == want.num_keypoints > 0
    for f in ("keypoints", "attention", "features"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("route", ["fused", "autograd"])
def test_chained_step_is_sync_free_and_equals_fused_calls(dev, rs, route):
    """The chained step (k = 3, from an int16 upload) runs under sync debug
    mode "error" and equals 3 fused calls bit for bit: params, BN buffers,
    metrics; on the fused route K7 launches 3 times one step's count."""
    from feat3dnet_tpu_torch.config import TrainConfig
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.train.trainer import (init_state, make_chained_train_step,
                                                   make_fused_train_step, stack_chunk,
                                                   stack_triplet)

    cfg = ModelConfig(fused_towers=route == "fused")
    triplets = []
    for _ in range(3):
        a = rs.randn(2, 4096, 3).astype(np.float32) * 6.0
        triplets.append((a, a + 0.01 * rs.randn(*a.shape).astype(np.float32),
                         a + 0.2 * rs.randn(*a.shape).astype(np.float32)))
    states = [init_state(Feat3DNet(cfg), TrainConfig(), cfg,
                         variables=init_variables(cfg, seed=0), device=dev) for _ in range(2)]
    aug = dict(augmentations=("RotateSmall", "Jitter"), aug_seed=1)
    single = make_fused_train_step(states[1].model, cfg.margin, cfg.attention, **aug)
    tft.stats_pass.launches = 0
    for t in triplets:
        _, last = single(states[1], stack_triplet(t, dev, quant=True))
    one = tft.stats_pass.launches
    chunk = stack_chunk(triplets, dev, quant=True)
    chained = make_chained_train_step(states[0].model, cfg.margin, cfg.attention, **aug)
    tft.stats_pass.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = chained(states[0], chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tft.stats_pass.launches == one and (route == "autograd") == (one == 0)
    m0, m1 = states[0].model, states[1].model
    assert all(torch.equal(x, y) for x, y in zip(m0.parameters(), m1.parameters()))
    assert all(torch.equal(x, y) for x, y in zip(m0.buffers(), m1.buffers()))
    assert torch.equal(metrics["loss"][-1], last["loss"])
    assert torch.equal(metrics["hist_det_cnt"]["counts"][-1], last["hist_det_cnt"]["counts"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_modes_equal_plain_on_the_card(dev, rs, dtype):
    """remat_towers and the trainer's remat on the card's autograd route:
    the loss, every gradient and the BN buffers after a step equal the
    plain step's bit for bit (the recompute repeats the same kernels)."""
    from feat3dnet_tpu_torch.config import TrainConfig
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.train.trainer import init_state, make_fused_train_step

    a = rs.randn(2, 4096, 3).astype(np.float32) * 6.0
    stacked = torch.from_numpy(np.concatenate([a, a + 0.01 * rs.randn(*a.shape),
                                               a + 0.2 * rs.randn(*a.shape)]
                                              ).astype(np.float32)).to(dev)
    out = []
    for towers, remat in ((False, False), (True, False), (False, True)):
        cfg = ModelConfig(compute_dtype=dtype, remat_towers=towers)
        state = init_state(Feat3DNet(cfg), TrainConfig(), cfg,
                           variables=init_variables(cfg, seed=0), device=dev)
        _, metrics = make_fused_train_step(state.model, cfg.margin, cfg.attention,
                                           remat=remat)(state, stacked)
        out.append((metrics["loss"], [p.grad for p in state.model.parameters()],
                    list(state.model.buffers())))
    for loss, grads, buffers in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(x, y) for x, y in zip(grads, out[0][1]))
        assert all(torch.equal(x, y) for x, y in zip(buffers, out[0][2]))


@pytest.mark.parametrize("n,m,c", [(16384, 4096, 256), (4096, 1024, 512), (1024, 256, 512),
                                   (256, 64, 1024), (1000, 3, 7), (300, 2050, 33)])
def test_three_interp_kernel_matches_plain(dev, rs, n, m, c):
    """K11 against its plain twin: indices exact; weights and sums within
    1e-6 relative (the kernel repeats the twin's arithmetic, each operation
    rounded to nearest, so they should agree bit for bit; the bound allows
    a last-place difference in a torch op's rounding). Known points among
    the unknown (zero distances, as at every FP level), duplicates (ties to
    the lower index) and m past a tile of 1 024."""
    from feat3dnet_tpu_torch.ops.interpolate import (three_interpolate,
                                                      three_interpolate_plain)

    unknown = rs.randn(2, n, 3).astype(np.float32) * 5.0
    known = np.ascontiguousarray(unknown[:, rs.permutation(n)[:m]]) if m <= n else \
        rs.randn(2, m, 3).astype(np.float32) * 5.0
    if m > 3:
        known[:, 2] = known[:, 1]
    args = [torch.from_numpy(a).to(dev) for a in
            (unknown, known, rs.randn(2, m, c).astype(np.float32))]
    before = three_interpolate.launches
    (ok, ik, wk), (op, ip, wp) = three_interpolate(*args), three_interpolate_plain(*args)
    torch.cuda.synchronize()
    assert three_interpolate.launches == before + 1
    assert torch.equal(ik, ip)
    torch.testing.assert_close(wk, wp, rtol=1e-6, atol=0)
    torch.testing.assert_close(ok, op, rtol=1e-6, atol=1e-6 * float(op.abs().max()))


def _pointnet2(dev, seed):
    from feat3dnet_tpu_torch.config import PointNet2Config
    from feat3dnet_tpu_torch.models.pointnet2 import PointNet2MSG
    from portbench.reference import pointnet2 as R

    cfg = PointNet2Config()
    rcfg = {"npoints": list(cfg.npoints), "radii": cfg.radii, "nsamples": cfg.nsamples,
            "sa_mlps": cfg.sa_mlps, "fp_mlps": cfg.fp_mlps, "cls_fc": cfg.cls_fc,
            "bn_epsilon": cfg.bn_epsilon}
    w = R.make_weights(rcfg, seed, dev)
    m = PointNet2MSG(cfg).to(dev)
    m.load_state_dict(w, strict=True)
    return m.eval(), w, rcfg


def test_pointnet2_at_16384_points_matches_the_reference(dev, rs):
    """One KITTI frame sampled to 16 384 points at the published widths,
    seeded weights: logits within 1e-4 of the reference's largest |logit|
    and FP1's output within 1e-4 relative L2 at every point (the tier-1
    test's tolerances and reasons, tests/test_torch_pointnet2.py); K1, K2
    and K11 launched."""
    from feat3dnet_tpu_torch.ops.interpolate import three_interpolate
    from portbench.reference import pointnet2 as R

    m, w, rcfg = _pointnet2(dev, 2 ** 31 + 28)
    cloud = load_point_cloud(example_cloud_path("kitti_00_001554.bin"))[:, :3]
    xyz = torch.from_numpy(cloud[rs.choice(len(cloud), 16384, replace=False)][None]).to(dev)
    k1, k2, k11 = (farthest_point_sample.launches, ball_query_fused.launches,
                   three_interpolate.launches)
    out = m(xyz)
    assert (farthest_point_sample.launches - k1, ball_query_fused.launches - k2,
            three_interpolate.launches - k11) == (4, 8, 4)
    logits, feats = R.forward(w, rcfg, xyz)
    assert float((out.logits - logits).abs().max() / logits.abs().max()) <= 1e-4
    rel = (out.features - feats).norm(dim=-1) / feats.norm(dim=-1).clamp(min=1e-30)
    assert float(rel.max()) <= 1e-4


def test_segment_many_matches_a_loop_of_segment_on_the_card(dev, rs):
    """Indices equal; logits within 1e-5 of the largest: cuBLAS picks its
    GEMM kernels by shape, so a unit of 3 frames and one of 1 may sum in
    another order."""
    from feat3dnet_tpu_torch.inference import SegmentationPipeline

    pipe = SegmentationPipeline(_pointnet2(dev, 5)[0], device=dev)
    cloud = load_point_cloud(example_cloud_path("kitti_00_004534.bin"))[:, :3]
    clouds = [cloud, cloud[:12000], cloud[::-1].copy()]
    many = pipe.segment_many(clouds, np.random.default_rng(3), batch_size=3)
    rng = np.random.default_rng(3)
    for a, c in zip(many, clouds):
        b = pipe.segment(c, rng)
        assert np.array_equal(a.indices, b.indices)
        assert np.abs(a.logits - b.logits).max() <= 1e-5 * np.abs(b.logits).max()


def test_segmentation_step_graphs_match_the_eager_forward(dev, rs):
    """The pipeline's per-step CUDA graphs against the model run eagerly on
    the same points: the same kernels on the same shapes, so logits and
    FP1's features within 1e-6 of the largest (cuBLAS may pick another
    algorithm under capture); each pass counts K1 x4, K2 x8 and K11 x4,
    captured or replayed; a weight changed in place is seen by the next
    unit (the graphs are made anew)."""
    from feat3dnet_tpu_torch.inference import SegmentationPipeline
    from feat3dnet_tpu_torch.ops.interpolate import three_interpolate

    def counts():
        return (farthest_point_sample.launches, ball_query_fused.launches,
                three_interpolate.launches)

    model = _pointnet2(dev, 6)[0]
    pipe = SegmentationPipeline(model, device=dev)
    cloud = load_point_cloud(example_cloud_path("kitti_00_001554.bin"))[:, :3]
    xyz = torch.from_numpy(np.stack([cloud[rs.choice(len(cloud), 16384, replace=False)]
                                     for _ in range(2)])).to(dev)
    for _ in range(2):
        # a capture (an eager pass, then the replay), then a replay alone
        for want_counts in ((8, 16, 8), (4, 8, 4)):
            before = counts()
            got, got_feats = pipe.forward_sampled(xyz)
            assert tuple(a - b for a, b in zip(counts(), before)) == want_counts
        want = model(xyz)
        assert float((got - want.logits).abs().max()) <= 1e-6 * float(want.logits.abs().max())
        assert float((got_feats - want.features).abs().max()) <= \
            1e-6 * float(want.features.abs().max())
        with torch.no_grad():
            model.logit.bias.add_(1.0)


def test_segmentation_graphs_read_the_new_fold_after_a_weight_swap(dev, rs):
    """Weights swapped between calls (load_state_dict): the pipeline
    captures its step graphs again, the eager pass before the capture folds
    every ConvBN anew (once a layer a load, none on a replay), each pass
    counts one folded GEMM a layer, and the graphs' logits equal an eager
    run of the model on the new weights (the same folded layers: within
    the 1e-6 the step-graph test allows for cuBLAS's choice under capture)."""
    from feat3dnet_tpu_torch.inference import SegmentationPipeline
    from feat3dnet_tpu_torch.models.layers import ConvBN
    from portbench.reference import pointnet2 as R

    model, _, rcfg = _pointnet2(dev, 7)
    n_layers = sum(isinstance(m, ConvBN) for m in model.modules())
    pipe = SegmentationPipeline(model, device=dev)
    cloud = load_point_cloud(example_cloud_path("kitti_00_004534.bin"))[:, :3]
    xyz = torch.from_numpy(cloud[rs.choice(len(cloud), 16384, replace=False)][None]).to(dev)
    last = None
    for seed in (7, 8, 9):
        model.load_state_dict(R.make_weights(rcfg, seed, dev), strict=True)
        for want_calls, want_refreshes in ((2 * n_layers, n_layers), (n_layers, 0)):
            calls, refreshes = ConvBN.folded_calls, ConvBN.fold_refreshes
            got = pipe.forward_sampled(xyz)[0]
            assert (ConvBN.folded_calls - calls, ConvBN.fold_refreshes - refreshes) == \
                (want_calls, want_refreshes)
        want = model(xyz).logits
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
        assert last is None or not torch.equal(got, last)
        last = got


def test_convbn_fold_missing_under_capture_raises(dev):
    """A ConvBN whose fold was not made before a CUDA graph capture raises
    inside it; once run eagerly, it captures and its replay equals the
    eager call (within the 1e-6 the step-graph test allows for cuBLAS's
    choice under capture)."""
    from feat3dnet_tpu_torch.models.layers import ConvBN

    torch.manual_seed(0)
    layer = ConvBN(64, 128).to(dev).eval()
    with torch.no_grad():
        layer.bn.mean.normal_()
        layer.bn.var.uniform_(0.5, 2.0)
    x = torch.randn(4096, 64, device=dev)
    torch.relu(x @ x.t())                    # cuBLAS set up outside any capture
    torch.cuda.synchronize()
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                layer(x)
        want = layer(x)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = layer(x)
    g.replay()
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= 1e-6 * float(want.abs().max())
    with torch.no_grad():
        ref = layer.bn(layer.conv2d(x))
    assert float((want - torch.relu(ref)).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_default_route_folds_once_and_batches_bit_equal(dev, rs):
    """The default route (the model's towers) at the paper's widths: its 9
    ConvBNs folded on the first call and not again while the weights stand,
    every call running folded GEMMs; extract_batch and extract_many give
    each cloud extract's result bit for bit (each call keeps its own GEMM
    shapes)."""
    from feat3dnet_tpu_torch.config import InferenceConfig
    from feat3dnet_tpu_torch.inference import InferencePipeline
    from feat3dnet_tpu_torch.models import Feat3DNet
    from feat3dnet_tpu_torch.models.layers import ConvBN

    cfg = ModelConfig()
    pipe = InferencePipeline(Feat3DNet(cfg), init_variables(cfg, seed=1, bn_perturb=0.1), cfg,
                             InferenceConfig(use_fused_detector=False), device=dev)
    clouds = [((rs.rand(n, 3) - 0.5) * np.float32(40.0)).astype(np.float32)
              for n in (7000, 5200, 3100)]
    refreshes = ConvBN.fold_refreshes
    want = [pipe.extract(c) for c in clouds]
    assert ConvBN.fold_refreshes - refreshes == 9
    calls = ConvBN.folded_calls
    for got in (pipe.extract_batch(clouds), pipe.extract_many(clouds, batch_size=2)):
        for g, w in zip(got, want):
            assert g.num_keypoints == w.num_keypoints > 0
            for f in ("keypoints", "attention", "features"):
                assert np.array_equal(getattr(g, f), getattr(w, f)), f
    assert ConvBN.fold_refreshes - refreshes == 9 and ConvBN.folded_calls > calls
