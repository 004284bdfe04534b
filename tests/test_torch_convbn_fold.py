"""Eval ConvBN as one GEMM (models/layers.py): with autograd off, in eval
and in f32, BN is folded into the Dense's kernel and bias (`fold_bn`) and
the ReLU rides the product (`torch._addmm_activation`).

* The folded layer against the layers run one by one (Dense, BN, the
  activation), with and without the Dense's bias and the ReLU, within f32
  rounding: folding re-associates one product, (x W) mul against x (W
  mul), so the two differ by a few ulps of the largest term; the bound is
  1e-5 of the largest |output|. The fold is made anew after
  load_state_dict, an in-place update of BN's scale and a move to float64,
  and only then (`ConvBN.fold_refreshes`). Training, autograd-on eval and
  a bf16 compute dtype (which rounds the product before BN) stay bit-equal
  to the layers one by one, BN's running statistics too, and count no
  folded call (`ConvBN.folded_calls`).
* The models on the CPU: the default extraction route folds 3DFeat-Net's
  9 ConvBNs once for a weight load and counts one folded GEMM a layer a
  tower pass; PointNet++'s segmentation folds each of its ConvBNs once a
  load, and its output stays within f32 rounding of autograd-on eval.
"""
import copy

import numpy as np
import pytest
import torch

from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, PointNet2Config
from feat3dnet_tpu_torch.inference import InferencePipeline, SegmentationPipeline
from feat3dnet_tpu_torch.models import Feat3DNet, PointNet2MSG
from feat3dnet_tpu_torch.models.layers import ConvBN
from feat3dnet_tpu_torch.utils import init_variables
from portbench.reference import pointnet2 as R

torch.set_num_threads(2)

TOL = 1e-5


def _layer(use_bias, act, dtype=torch.float32, seed=0):
    torch.manual_seed(seed)
    layer = ConvBN(6, 9, activation=act, dtype=dtype, use_bias=use_bias)
    with torch.no_grad():
        layer.bn.scale.normal_()
        layer.bn.bias.normal_()
        layer.bn.mean.normal_()
        layer.bn.var.uniform_(0.3, 3.0)
    return layer


def _one_by_one(layer, x, training=False):
    """Dense, BN, then the activation: the path the fold replaces."""
    y = layer.bn(layer.conv2d(x), training)
    return y if layer.activation is None else layer.activation(y)


def _counts():
    return ConvBN.folded_calls, ConvBN.fold_refreshes


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("act", [torch.relu, None], ids=["relu", "no_act"])
@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
def test_folded_eval_convbn(use_bias, act):
    layer = _layer(use_bias, act)
    x = torch.randn(3, 5, 7, 6)
    calls, refreshes = _counts()

    def folded(inp):
        with torch.no_grad():
            return layer(inp)

    def check(inp):
        got = folded(inp)
        with torch.no_grad():
            want = _one_by_one(layer, inp)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _close(got, want)
        if act is not None:
            assert bool((got >= 0).all())

    check(x)
    check(x[:, :2])                  # another shape: the same fold
    assert _counts() == (calls + 2, refreshes + 1)
    state = {k: v + 0.25 if k.endswith("mean") else v for k, v in layer.state_dict().items()}
    layer.load_state_dict(state)
    check(x)
    with torch.no_grad():
        layer.bn.scale.mul_(1.5)
    check(x)
    layer.to(torch.float64)
    check(x.double())
    check(x.double())
    assert _counts() == (calls + 6, refreshes + 4)

    # training, autograd-on eval and bf16 run the layers one by one
    layer.to(torch.float32)
    twin = copy.deepcopy(layer)
    calls, refreshes = _counts()
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            got = layer(x, training=True)
            want = _one_by_one(twin, x, training=True)
        assert torch.equal(got, want)
        assert torch.equal(layer.bn.mean, twin.bn.mean) and torch.equal(layer.bn.var, twin.bn.var)
    got = layer(x)
    assert got.requires_grad and torch.equal(got, _one_by_one(layer, x))
    got.sum().backward()
    assert layer.bn.scale.grad is not None and layer.conv2d.weight.grad is not None
    low = _layer(use_bias, act, dtype=torch.bfloat16)
    with torch.no_grad():
        got = low(x)
        assert got.dtype == torch.bfloat16 and torch.equal(got, _one_by_one(low, x))
    assert _counts() == (calls, refreshes)


def test_no_bn_layer_is_not_folded():
    layer = ConvBN(6, 9, use_bn=False)
    x = torch.randn(4, 6)
    calls, refreshes = _counts()
    with torch.no_grad():
        assert torch.equal(layer(x), torch.relu(layer.conv2d(x)))
    assert _counts() == (calls, refreshes)


SMALL = dict(num_clusters=-1, num_samples=8, feature_dim=16, base_scale=2.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))


@pytest.mark.parametrize("widths", ["paper", "small"])
def test_default_route_folds_once_a_load(widths):
    """The default route (`use_fused_detector` off) folds each ConvBN once
    for its weights (9 at the paper's widths) and runs every tower layer
    folded: the same count on every call with unchanged weights."""
    cfg = ModelConfig() if widths == "paper" else ModelConfig(**SMALL)
    net = Feat3DNet(cfg)
    n_layers = sum(isinstance(m, ConvBN) for m in net.modules())
    assert widths != "paper" or n_layers == 9
    icfg = InferenceConfig(keypoint_chunk=256, max_keypoints=64, nms_radius=1.0)
    pipe = InferencePipeline(net, init_variables(cfg, seed=3, bn_perturb=0.1), cfg, icfg,
                             device="cpu")
    rs = np.random.RandomState(0)
    cloud = ((rs.rand(1200, 3) - 0.5) * 12.0).astype(np.float32)
    per_call = []
    for i in range(3):
        calls, refreshes = _counts()
        pipe.extract(cloud)
        per_call.append(ConvBN.folded_calls - calls)
        assert ConvBN.fold_refreshes - refreshes == (n_layers if i == 0 else 0)
    assert per_call[0] == per_call[1] == per_call[2] >= n_layers


def _pointnet2(seed):
    cfg = PointNet2Config(num_points=512, npoints=(128, 32, 16, 8))
    rcfg = {"npoints": list(cfg.npoints), "radii": cfg.radii, "nsamples": cfg.nsamples,
            "sa_mlps": cfg.sa_mlps, "fp_mlps": cfg.fp_mlps, "cls_fc": cfg.cls_fc,
            "bn_epsilon": cfg.bn_epsilon}
    m = PointNet2MSG(cfg)
    m.load_state_dict(R.make_weights(rcfg, seed, "cpu"), strict=True)
    return m.eval(), rcfg


def _unfolded(m, xyz):
    """The model's steps with autograd on: every ConvBN layer by layer
    (its forward runs under no_grad, so it folds)."""
    state = m.start(xyz)
    for _, step in m.steps():
        step(state)
    return state["logits"].detach(), state["feats"][0].detach()


def test_segmentation_folds_once_a_load():
    """PointNet++ through the segmentation pipeline: each ConvBN folded
    once a weight load and run folded once a pass; logits and FP1's
    features within f32 rounding of the layers one by one; a new load
    folds every layer again."""
    m, rcfg = _pointnet2(21)
    n_layers = sum(isinstance(x, ConvBN) for x in m.modules())
    pipe = SegmentationPipeline(m, device="cpu")
    rs = np.random.default_rng(4)
    xyz = torch.from_numpy((rs.standard_normal((2, 512, 3)) * [4.0, 4.0, 0.6])
                           .astype(np.float32))
    for i in range(2):
        calls, refreshes = _counts()
        logits, feats = pipe.forward_sampled(xyz)
        assert _counts() == (calls + n_layers, refreshes + (n_layers if i == 0 else 0))
    want_logits, want_feats = _unfolded(m, xyz)
    assert not torch.equal(feats, want_feats)
    assert _close(logits, want_logits) and _close(feats, want_feats)
    m.load_state_dict(R.make_weights(rcfg, 22, "cpu"), strict=True)
    refreshes = ConvBN.fold_refreshes
    logits2, _ = pipe.forward_sampled(xyz)
    assert ConvBN.fold_refreshes - refreshes == n_layers
    assert _close(logits2, _unfolded(m, xyz)[0]) and not torch.equal(logits2, logits)
