"""Kernel K3's arithmetic (csrc/fused_describe.cu), emulated in torch on the
CPU: its outputs must equal, bit for bit, K3's plain version with every
product summed as one fmaf chain in k order (the previous kernel and the
card's plain version sum so), in f32 and in bf16_act.

What is emulated, per cluster of ns slots: the plain version's elementwise
steps (membership, the input scaled by 1/r, the bf16 roundings, softplus,
the orientation's normalisation, the rotation, the L2 norm), which the
kernel keeps from the previous design; every per-slot and single-row
product as a k-order fmaf chain (f3d::slot_layer, column_chains); and the
detector's top conv and the descriptor's mid conv as
csrc/tower_pool.cuh:pooled_conv takes them: the tensor-core product (1xTF32
in f32, the bf16 mma model in bf16_act; also with every addend of each mma
truncated at alignment, the worst case tower_rel allows for), the slack
from the row and column norms, the candidate rows (the mid conv's values
are signed: no clamp at 0, rows outside the ball never candidates; its
input's right half is the same in every row of a cluster, so its slack
leaves that half's operand rounding out), each re-summed as a chain, the
pool their largest (tests/tf32_emulation.py).

Inputs: the paper widths; 253 ball-query clusters of a vendored Oxford
cloud plus one with every slot tied, one empty ball and one partial ball;
seeded weights (perturbed BN statistics) and the trained ckpt/4480
weights; and the same at 32 samples. The W fragments the wrapper lays out
for the two pooled convs are checked against the PTX fragment layout.
"""
import functools
import os

import numpy as np
import pytest
import torch

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
from feat3dnet_tpu_torch.ops import fused_describe as tfd
from feat3dnet_tpu_torch.ops import hash_grid as thg
from feat3dnet_tpu_torch.utils import init_variables, load_variables_npz
from tests.tf32_emulation import chain_matmul, pooled_conv, round_bf16, tf32_rna

torch.set_num_threads(2)

B = 256
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz")
PRODUCT = {"f32": "tf32x1", "bf16": "bf16"}        # K3's pooled products per mode


def _identity(t):
    return t


def k3_forward(weights_t, clusters, cfg, bf16=False, product=None):
    """K3's forward on (nb, ns, 3) clusters and transposed folded weights:
    every product an fmaf chain in k order, the elementwise steps as the
    plain version takes them. product (a key of tests/tf32_emulation.py's
    PRODUCTS): the two pooled convs picked from that tensor-core product
    and re-summed (pooled_conv), as the kernel takes them; None: summed
    whole and max-pooled. Returns (desc (nb, D), att (nb,), {"top": ...,
    "mid": ...}: each pooled conv's (pool, candidates or None))."""
    act = round_bf16 if bf16 else _identity
    n_det, n_det2, n_desc = len(cfg.detector_mlp), len(cfg.detector_mlp2), len(cfg.descriptor_mlp)
    ws = iter(weights_t)

    def next_w():
        k, b = next(ws), next(ws)
        return act(k.t()), b                          # (Cin, Cout), (Cout, 1)

    def dense(h, w, b, relu=True):
        v = chain_matmul(h, w[:h.shape[1]]) + b[:, 0]
        return act(torch.relu(v) if relu else v)

    def pooled(h, w, b, relu):
        """(pool (nb, C), candidates): picked and re-summed, or summed whole.
        The mid conv's input [h | pool] has its right half the same in every
        row of a cluster (the kernel's kShared slack)."""
        if product is not None:
            pool, _, cand, _ = pooled_conv(h, w, (None, b, None, None, None), mask, dup, product,
                                           relu=relu, shared_from=None if relu else w.shape[0] // 2)
            return pool, cand
        v = dense(h, w, b, relu).reshape(nb, ns, -1)
        if relu:
            return (v * mask[..., None]).amax(dim=1), None
        return torch.where(mask[..., None], v, torch.tensor(-1.0e30)).amax(dim=1), None

    x = clusters.to(torch.float32)
    nb, ns = x.shape[:2]
    r = torch.tensor(cfg.base_scale, dtype=torch.float32)
    inv_r = 1.0 / r
    d2 = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
    d2 = d2 + x[..., 2] * x[..., 2]
    in_ball = d2 < r * r
    empty = ~in_ball.any(dim=1, keepdim=True)
    slots = torch.arange(ns).expand_as(d2)
    first = torch.where(d2 <= d2.min(dim=1, keepdim=True).values, slots, ns)
    mask = in_ball | (empty & (slots == first.min(dim=1, keepdim=True).values))
    dup = (x.view(torch.int32) == x[:, :1].view(torch.int32)).all(dim=-1)
    dup[:, 0] = False                                  # repeats of slot 0 (the kernel's flags)
    xs = x * inv_r
    zero = torch.zeros((nb * ns, 1))

    h = torch.cat([act(xs).reshape(-1, 3), zero], dim=1)          # (x, y, z, 0)
    for _ in range(n_det - 1):
        h = dense(h, *next_w())
    pools = {}
    pools["top"] = g_top = pooled(h, *next_w(), relu=True)
    g = g_top[0]
    for _ in range(n_det2):
        g = dense(g, *next_w())
    wa, ba = next_w()
    a = chain_matmul(g, wa) + ba[:, 0]
    att = torch.logaddexp(a[:, 0], torch.zeros(()))
    wo, bo = next_w()
    o = chain_matmul(g, wo) + bo[:, 0]
    o = o * torch.rsqrt(torch.clamp((o * o).sum(dim=1, keepdim=True), min=1e-8))
    c, s = o[:, 0:1], o[:, 1:2]
    xr = xs[..., 0] * c - xs[..., 1] * s
    yr = xs[..., 0] * s + xs[..., 1] * c
    h = act(torch.stack([xr, yr, xs[..., 2]], dim=-1)).reshape(-1, 3)
    h = torch.cat([h, zero], dim=1)
    for _ in range(n_desc):
        h = dense(h, *next_w())
    dpool = (h.reshape(nb, ns, -1) * mask[..., None]).amax(dim=1)
    cat = torch.cat([h, dpool[:, None, :].expand(nb, ns, -1).reshape(nb * ns, -1)], dim=1)
    pools["mid"] = m = pooled(cat, *next_w(), relu=False)
    wp, bp = next_w()
    out = chain_matmul(m[0], wp) + bp[:, 0]
    out = out * torch.rsqrt(torch.clamp((out * out).sum(dim=1, keepdim=True), min=1e-8))
    return out, att, pools


def _clusters():
    """What the server and the fused extraction feed K3: origin-centred
    ball-query clusters (repeat-padded) of a vendored Oxford cloud, with a
    cluster of 64 tied slots, an empty ball and a partial ball."""
    cloud = load_point_cloud(example_cloud_path("oxford_270.bin"))[:, :3]
    sc = thg.build_sorted_cloud_host(cloud, cell_size=2.0, block_size=256)
    ctr = torch.from_numpy(sc.pts4[:64 * B:64, :3].copy())
    grouped, _, _ = thg.ball_query_grouped_sorted(sc.to("cpu"), ctr, 2.0, 64)
    c = (grouped - ctr[:, None, :]).numpy()
    c[5] = c[5, 3]                                 # every slot tied
    c[6] += 30.0                                   # empty ball -> nearest fallback
    c[9, 32:] += 30.0                              # partial ball
    return c


@functools.lru_cache(maxsize=None)
def _case(kind, ns):
    cfg = ModelConfig(num_samples=ns)
    v = init_variables(cfg, seed=2, bn_perturb=0.1) if kind == "seeded" else load_variables_npz(NPZ)
    wt = tfd.transpose_folded_weights(tfd.folded_weights(v, cfg))
    return cfg, wt, torch.from_numpy(np.ascontiguousarray(_clusters()[:, :ns]))


@functools.lru_cache(maxsize=None)
def _forward(kind, ns, mode, product=None):
    cfg, wt, c = _case(kind, ns)
    return k3_forward(wt, c, cfg, bf16=mode == "bf16", product=product)


@pytest.mark.parametrize("kind", ["seeded", "trained"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("aligned", [False, True], ids=["", "aligned"])
def test_emulated_k3_equals_the_chain_forward(kind, mode, aligned):
    """Both pooled convs' pools and K3's outputs from the picked and
    re-summed candidates equal those of the k-order chains bit for bit, also
    with every mma addend truncated at alignment; every cluster and channel
    of the mid conv has a candidate (its -1e30 fill never reaches the
    output); few rows per cluster and channel are summed again."""
    product = PRODUCT[mode] + ("_aligned" if aligned else "")
    d_c, a_c, pools_c = _forward(kind, 64, mode)
    d_t, a_t, pools_t = _forward(kind, 64, mode, product)
    for conv in ("top", "mid"):
        assert torch.equal(pools_t[conv][0], pools_c[conv][0]), conv
    assert torch.equal(d_t, d_c) and torch.equal(a_t, a_c)
    cand = pools_t["mid"][1]
    assert cand.any(dim=1).all()
    per = {conv: pools_t[conv][1].sum(dim=1).float().mean().item() for conv in pools_t}
    print(f"{kind} {mode} {product}: candidates per cluster and channel {per}")
    assert max(per.values()) <= 4.0


@pytest.mark.parametrize("kind", ["seeded", "trained"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_emulated_k3_at_32_samples(kind, mode):
    """ns = 32 < 64 (the kernel pads the cluster with unmasked slots)."""
    d_c, a_c, _ = _forward(kind, 32, mode)
    d_t, a_t, _ = _forward(kind, 32, mode, PRODUCT[mode])
    assert torch.equal(d_t, d_c) and torch.equal(a_t, a_c)


@pytest.mark.parametrize("kind", ["seeded", "trained"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_chain_forward_is_the_plain_version(kind, mode):
    """The emulation's reference is K3's plain version, summed in k order:
    within phase 1's limits of it in f32 (max |d| 1e-4, cosine 0.99999,
    attention relative 1e-4), within phase 13's in bf16_act (99.9 % of
    descriptors within 2^-8, cosine 0.9999, attention relative 1e-2)."""
    cfg, wt, c = _case(kind, 64)
    d_c, a_c, _ = _forward(kind, 64, mode)
    d_p, a_p = tfd.fused_describe_clusters_t_plain(
        wt, torch.from_numpy(tfd.pack_clusters_lanes(c.numpy())), cfg, bf16_act=mode == "bf16")
    dmax = (d_c - d_p).abs().amax(dim=1)
    cos = torch.nn.functional.cosine_similarity(d_c, d_p, dim=1).min().item()
    a_rel = ((a_c - a_p).abs() / a_p.abs().clamp(min=1e-6)).max().item()
    if mode == "f32":
        assert dmax.max().item() <= 1e-4 and cos >= 0.99999 and a_rel <= 1e-4
    else:
        assert (dmax <= 2.0 ** -8).float().mean().item() >= 0.999
        assert cos >= 0.9999 and a_rel <= 1e-2


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_k3_fragments_follow_the_mma_layout(mode):
    """The wrapper's W fragments of the two pooled convs, read as mma.sync's
    B fragments: lane 4 g + t of block (kb, nb) holds B(k0 + t, n0 + g) and
    B(k0 + t + 4, n0 + g) rounded to TF32 (m16n8k8, f32), or the bf16 pairs
    B(k0 + 2t + {0, 1}, n0 + g) and B(k0 + 2t + {8, 9}, n0 + g) (m16n8k16,
    bf16_act), 8 bytes a lane; the offsets point at them and at the column
    norms (rounded up; the mid conv's followed by those of its rows below
    cin / 2); every other layer has none, and the decomposition bodies get
    the f32 mode's buffers (they run its TF32 tiles)."""
    cfg = ModelConfig()
    wt = tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(cfg, seed=3, bn_perturb=0.1), cfg))
    flat, table, extra = tfd._describe_kernel_weights(wt, cfg, "cpu", mode)
    n_det, n_det2, n_desc = len(cfg.detector_mlp), len(cfg.detector_mlp2), len(cfg.descriptor_mlp)
    pooled = (n_det - 1, n_det + n_det2 + 2 + n_desc)
    assert extra.shape == (table.shape[0], 2) and extra.dtype == torch.int32
    assert [li for li in range(table.shape[0]) if (extra[li] >= 0).any()] == list(pooled)
    assert (extra[list(pooled)] >= 0).all()
    kk = 8 if mode == "f32" else 16
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for li in pooled:
        cin, cout, w_off = table[li, :3].tolist()
        w = flat[w_off:w_off + cin * cout].reshape(cin, cout)
        norms = w.norm(dim=0)
        if li == pooled[1]:                 # the mid conv: also its rows below cin / 2
            norms = torch.cat([norms, w[:cin // 2].norm(dim=0)])
        wnorm = flat[extra[li, 1]:extra[li, 1] + norms.numel()]
        torch.testing.assert_close(wnorm, norms * 1.0001, rtol=1e-6, atol=0)
        off = extra[li, 0].item()
        for kb in range(cin // kk):
            for nb in range(cout // 8):
                k0, n = kb * kk, nb * 8 + g
                base = off + (kb * (cout // 8) + nb) * 32 * 2           # 2 floats a lane
                got = flat[base:base + 64]
                if mode == "bf16":
                    got = got.view(torch.bfloat16).reshape(32, 4).float()
                    want = torch.stack([w[k0 + 2 * t, n], w[k0 + 2 * t + 1, n],
                                        w[k0 + 2 * t + 8, n], w[k0 + 2 * t + 9, n]], dim=1)
                    assert torch.equal(got, round_bf16(want))
                else:
                    want = torch.stack([tf32_rna(w[k0 + t, n]), tf32_rna(w[k0 + t + 4, n])], dim=1)
                    assert torch.equal(got.reshape(32, 2), want)
    # the buffer and table ahead of the fragments are _kernel_weights'
    f, tab = tfd._kernel_weights(wt, cfg, "cpu", bf16=mode == "bf16")
    assert torch.equal(table, tab) and torch.equal(flat[:f.numel()], f)
    if mode == "f32":
        for body in ("stream", "matmul", "matmul_2d"):
            got = tfd._describe_kernel_weights(wt, cfg, "cpu", body)
            assert all(torch.equal(a, b) for a, b in zip(got, (flat, table, extra)))
