"""PointNet++ MSG (models/pointnet2.py) and its path on the CPU.

At 512 points a cloud with npoint (128, 32, 16, 8) and the published
widths (config.PointNet2Config), on the benchmark's seeded weights:

* the model against the plain reference (portbench/reference/pointnet2.py):
  logits within LOGIT_TOL of the reference's largest |logit| and FP1's
  features within FEAT_TOL relative L2 at every point. Every discrete
  step (FPS, ball query, 3-NN) works on the same coordinates in the same
  order, so the gap is f32 rounding alone: GEMMs summed in another order
  over up to 1 536 terms and BN written as (x - mean) * (rsqrt(var + eps)
  * scale) + bias where the reference divides by sqrt(var + eps); that
  reads ~3e-6, and 1e-4 leaves 30x room while each planted fault below
  (the smallest, BN's eps 1e-3 for 1e-5, ~1e-3) lies above it;
* K11's plain twin (ops/interpolate.py) against the reference's 3-NN:
  indices exact, weights and the weighted sum within 1e-6 relative (the
  reference normalises with torch.sum, the twin with ((r0 + r1) + r2), a
  rounding apart);
* `SegmentationPipeline.segment_many` equal to a loop of `segment`
  calls on the same generator, and its spans;
* `InferencePipeline.extract_many`, on the stream loop it now shares,
  equal to a loop of `extract`;
* BatchNorm's eval forward, the plain formula on the running statistics
  whatever they are set to;
* three faults that must each fail the comparison: the interpolation
  weighted by squared distances (the TF PointNet++ variant), BN's eps 1e-3
  (TF's default) for 1e-5, and the FP skip concatenation swapped.
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from feat3dnet_tpu_torch.config import (InferenceConfig, ModelConfig, PointNet2Config)
from feat3dnet_tpu_torch.inference import InferencePipeline, SegmentationPipeline
from feat3dnet_tpu_torch.inference.segmentation import cloud_seed, sample_rows
from feat3dnet_tpu_torch.models import Feat3DNet, PointNet2MSG
from feat3dnet_tpu_torch.models import pointnet2 as P
from feat3dnet_tpu_torch.models.layers import ConvBN
from feat3dnet_tpu_torch.ops import interpolate
from feat3dnet_tpu_torch.utils import init_variables
from portbench.reference import pointnet2 as R

torch.set_num_threads(2)

CFG = PointNet2Config(num_points=512, npoints=(128, 32, 16, 8))
LOGIT_TOL = 1e-4
FEAT_TOL = 1e-4


def ref_cfg(cfg: PointNet2Config) -> dict:
    return {"npoints": list(cfg.npoints), "radii": cfg.radii, "nsamples": cfg.nsamples,
            "sa_mlps": cfg.sa_mlps, "fp_mlps": cfg.fp_mlps, "cls_fc": cfg.cls_fc,
            "bn_epsilon": cfg.bn_epsilon}


def model(seed: int, cfg: PointNet2Config = CFG) -> PointNet2MSG:
    m = PointNet2MSG(cfg)
    m.load_state_dict(R.make_weights(ref_cfg(CFG), seed, "cpu"), strict=True)
    return m.eval()


def frames(count: int, n: int = 512, seed: int = 0):
    """Street-like clouds: a few metres across, flat in z."""
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal((n + 37 * i, 3)) * np.array([4.0, 4.0, 0.6])).astype(np.float32)
            for i in range(count)]


def gaps(m: PointNet2MSG, seed: int, xyz: torch.Tensor):
    out = m(xyz)
    logits, feats = R.forward(R.make_weights(ref_cfg(CFG), seed, "cpu"), ref_cfg(CFG), xyz)
    logit_gap = float((out.logits - logits).abs().max() / logits.abs().max())
    feat_gap = float(((out.features - feats).norm(dim=-1)
                      / feats.norm(dim=-1).clamp(min=1e-30)).max())
    return logit_gap, feat_gap


def clouds_tensor(count: int = 2, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.stack([f[:CFG.num_points] for f in frames(count, seed=seed)]))


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 12])
def test_model_matches_reference(seed):
    logit_gap, feat_gap = gaps(model(seed), seed, clouds_tensor(seed=seed % 5))
    assert logit_gap <= LOGIT_TOL and feat_gap <= FEAT_TOL, (logit_gap, feat_gap)


def test_logits_vary_and_stay_finite():
    """The seeded weights give logits that differ from point to point."""
    out = model(3)(clouds_tensor())
    assert torch.isfinite(out.logits).all()
    assert float(out.logits.std()) > 1e-3 * float(out.logits.abs().max())


@pytest.mark.parametrize("n,m,c", [(512, 128, 96), (128, 32, 256), (33, 3, 5)])
def test_k11_plain_twin_matches_reference_three_nn(n, m, c):
    g = torch.Generator().manual_seed(n + m)
    unknown = torch.randn(2, n, 3, generator=g) * 2.0
    known = torch.cat([unknown[:, :m - 1], torch.randn(2, 1, 3, generator=g)], dim=1)
    known[1, 1] = known[1, 0]                      # a tie: the lower index first
    feats = torch.randn(2, m, c, generator=g)
    out, idx, w = interpolate.three_interpolate_plain(unknown, known, feats)
    for b in range(2):
        d2, ridx = R.three_nn(unknown[b], known[b])
        assert torch.equal(idx[b].long(), ridx)
        rw = R.interp_weights(d2)
        torch.testing.assert_close(w[b], rw, rtol=1e-6, atol=0)
        want = (feats[b][ridx] * rw[..., None]).sum(dim=1)
        torch.testing.assert_close(out[b], want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert idx.dtype == torch.int32 and bool((idx[1, :, 0] != 1).all())


def test_k11_wrapper_counts_nothing_on_the_cpu_and_refuses_other_devices():
    x = torch.randn(1, 8, 3)
    before = interpolate.three_interpolate.launches
    out, _, _ = interpolate.three_interpolate(x, x[:, :4].contiguous(), torch.randn(1, 4, 2))
    assert out.shape == (1, 8, 2) and interpolate.three_interpolate.launches == before
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        interpolate.three_interpolate(torch.empty(1, 8, 3, device=meta),
                                      torch.empty(1, 4, 3, device=meta),
                                      torch.empty(1, 4, 2, device=meta))


def test_convbn_bias_option():
    assert ConvBN(4, 8).conv2d.bias is not None
    layer = ConvBN(4, 8, use_bias=False)
    assert layer.conv2d.bias is None and "conv2d.bias" not in layer.state_dict()
    assert layer(torch.randn(5, 4)).shape == (5, 8)


def test_eval_bn_follows_its_statistics():
    """BatchNorm's eval forward is (x - mean) * (rsqrt(var + eps) * scale) +
    bias on the statistics as they stand after load_state_dict, an in-place
    update and a move; with autograd on, gradients reach `scale`."""
    from feat3dnet_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(4, 1e-5)
    x = torch.randn(6, 4)

    def plain():
        return (x - bn.mean) * (torch.rsqrt(bn.var + 1e-5) * bn.scale) + bn.bias

    with torch.no_grad():
        assert torch.equal(bn(x), plain())
        bn.load_state_dict({**bn.state_dict(), "var": torch.full((4,), 4.0)})
        assert torch.equal(bn(x), plain())
        bn.scale.mul_(3.0)
        assert torch.equal(bn(x), plain())
        bn.to(torch.float64)
        x = x.double()
        assert torch.equal(bn(x), plain())
    bn.to(torch.float32)
    x = x.float()
    bn(x).sum().backward()
    assert bn.scale.grad is not None and bool((bn.scale.grad != 0).any())


@pytest.mark.parametrize("n", [700, 512, 300])
def test_sample_rows(n):
    seed, cpu = cloud_seed(np.random.default_rng(4)), torch.device("cpu")
    rows = sample_rows(n, 512, seed, cpu)
    assert rows.shape == (512,) and rows.dtype == torch.int64 and int(rows.max()) < n
    if n >= 512:
        assert len(torch.unique(rows)) == 512
    else:
        assert set(range(n)) <= set(rows.tolist())
    assert torch.equal(rows, sample_rows(n, 512, seed, cpu))
    assert 0 <= cloud_seed(np.random.RandomState(4)) < 2 ** 63


@pytest.mark.parametrize("batch_size,depth,workers", [(1, 2, 1), (3, 1, 2)])
def test_segment_many_equals_a_loop_of_segment(batch_size, depth, workers):
    pipe = SegmentationPipeline(model(9), device="cpu")
    clouds = frames(4, n=480, seed=2)
    many = pipe.segment_many(clouds, np.random.default_rng(5), depth=depth,
                             prep_workers=workers, batch_size=batch_size)
    rng = np.random.default_rng(5)
    loop = [pipe.segment(c, rng) for c in clouds]
    assert len(many) == len(loop) == 4
    for a, b in zip(many, loop):
        assert np.array_equal(a.indices, b.indices)
        assert a.logits.dtype == np.float32 and np.array_equal(a.logits, b.logits)


@pytest.mark.parametrize("first_here", [False, True])
@pytest.mark.parametrize("depth,workers", [(1, 1), (2, 1), (3, 2)])
def test_run_units_keeps_order_and_depth(depth, workers, first_here):
    """The stream loop returns every unit's results in order, never holds
    more than `depth` units queued, and with first_here preps the first
    unit in the calling thread."""
    import threading

    from feat3dnet_tpu_torch.inference.stream import run_units

    main, queued, most, prep_threads = threading.get_ident(), [0], [0], {}

    def prep(i, unit):
        prep_threads[i] = threading.get_ident()
        return unit * 10

    def enqueue(i, prepped):
        queued[0] += 1
        most[0] = max(most[0], queued[0])
        return [prepped, prepped + 1]

    def finish(pending):
        queued[0] -= 1
        return pending

    out = run_units(iter(range(7)), prep, enqueue, finish, depth, workers, "f3d.test.wait",
                    first_here=first_here)
    assert out == [v for u in range(7) for v in (10 * u, 10 * u + 1)]
    assert most[0] == depth and queued[0] == 0
    assert (prep_threads[0] == main) == first_here
    assert all(t != main for i, t in prep_threads.items() if i > 0)


def test_forward_sampled_is_the_models_forward_on_the_cpu():
    m = model(11)
    pipe = SegmentationPipeline(m, device="cpu")
    xyz = torch.from_numpy(np.stack([f[:512] for f in frames(2, n=512, seed=6)]))
    logits, feats = pipe.forward_sampled(xyz)
    want = m(xyz)
    assert torch.equal(logits, want.logits) and torch.equal(feats, want.features)
    assert feats.shape == (2, 512, CFG.fp_mlps[0][-1])


def test_segment_matches_the_model_on_the_sampled_points():
    m = model(10)
    cloud = frames(1, n=600, seed=3)[0]
    res = SegmentationPipeline(m, device="cpu").segment(cloud, np.random.default_rng(0))
    want = m(torch.from_numpy(cloud[res.indices][None])).logits[0].numpy()
    assert np.array_equal(res.logits, want)


def _spans(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("f3d."):
            name, _, uid = e.name().partition("#")
            out.append((name, uid))
    return out


def test_segment_many_spans():
    pipe = SegmentationPipeline(model(9), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.segment_many(frames(2, seed=4), np.random.default_rng(1), batch_size=1)
    spans = _spans(prof)
    names = [n for n, _ in spans]
    stages = [f"f3d.seg.sa{k}" for k in range(1, 5)] + [f"f3d.seg.fp{k}" for k in range(1, 5)]
    for name in stages + ["f3d.seg.head", "f3d.seg.to_host", "f3d.seg.wait_prep"]:
        assert names.count(name) == 2, name
    assert names.count("f3d.seg.many") == 1
    for unit in ("enqueue", "finish"):
        assert len({u for n, u in spans if n == f"f3d.seg.{unit}"}) == 2
    assert names.count("f3d.k11.interp") == 8 and names.count("f3d.k1.fps") == 8


INFER = dict(keypoint_chunk=256, max_keypoints=32, nms_radius=1.0, use_hashed_grouping=True)
SMALL = dict(num_clusters=-1, num_samples=8, feature_dim=16, base_scale=2.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))


@pytest.mark.parametrize("fused,batch_size,workers", [(True, 2, 1), (False, 1, 2)])
def test_extract_many_equals_a_loop_of_extract(fused, batch_size, workers):
    cfg = ModelConfig(**SMALL)
    pipe = InferencePipeline(Feat3DNet(cfg), init_variables(cfg, seed=3, bn_perturb=0.1), cfg,
                             InferenceConfig(use_fused_detector=fused, **INFER), device="cpu")
    rs = np.random.RandomState(0)
    clouds = [((rs.rand(500 + 100 * i, 3) - 0.5) * 12.0).astype(np.float32) for i in range(3)]
    many = pipe.extract_many(clouds, rng=np.random.RandomState(2), depth=2,
                             prep_workers=workers, batch_size=batch_size)
    rng = np.random.RandomState(2)
    loop = [pipe.extract(c, rng=rng) for c in clouds]
    for a, b in zip(many, loop):
        assert a.num_keypoints == b.num_keypoints > 0
        for f in ("keypoints", "features", "attention"):
            assert np.array_equal(getattr(a, f), getattr(b, f))


def _squared_weights(dist2):
    recip = 1.0 / (dist2 + 1e-8)
    return recip / ((recip[..., 0] + recip[..., 1]) + recip[..., 2])[..., None]


def _swapped_fp(self, unknown, known, unknown_feats, known_feats):
    h = interpolate.three_interpolate(unknown, known, known_feats)[0]
    if unknown_feats is not None:
        h = torch.cat([unknown_feats, h], dim=-1)
    return P._run(self.mlp, h)


@pytest.mark.parametrize("fault", ["squared_distance_weights", "bn_eps_1e-3", "skip_swapped"])
def test_planted_fault_fails_the_comparison(fault, monkeypatch):
    seed = 2 ** 31 + 7
    cfg = CFG
    if fault == "squared_distance_weights":
        monkeypatch.setattr(interpolate, "_weights", _squared_weights)
    elif fault == "bn_eps_1e-3":
        cfg = PointNet2Config(num_points=512, npoints=(128, 32, 16, 8), bn_epsilon=1e-3)
    else:
        monkeypatch.setattr(P.FeaturePropagation, "forward", _swapped_fp)
    logit_gap, feat_gap = gaps(model(seed, cfg), seed, clouds_tensor())
    assert logit_gap > LOGIT_TOL or feat_gap > FEAT_TOL, (logit_gap, feat_gap)
