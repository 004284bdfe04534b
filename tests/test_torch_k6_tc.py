"""Kernel K6's arithmetic (csrc/fused_detect.cu), emulated in torch on the
CPU, against K6's plain version and the JAX detector-only kernel, at the
tolerances the kernel is held to on the card: attention relative 1e-5 and
orientation 1e-5 rad in the unfolded and folded modes; bf16_operands
>= 99.9 % of centres within 1e-4 of its plain version, while the f32
arithmetic fails that limit.

What is emulated, per cluster of 64 slots:
- the input scaled (v / r unfolded, v * (1/r) folded; rounded to bf16 in
  bf16_operands) and the membership mask, as the plain version;
- conv 0 on the CUDA cores: an fmaf chain over (x, y, z, 0) in k order;
- f32 modes: the per-slot convs below the top one on the CUDA cores, an
  fmaf chain in k order per output (f3d::slot_layer); the top conv on the
  tensor cores in 1xTF32 onto one running accumulator, each mma rounded
  toward zero (tests/tf32_emulation.py; its candidates also under the
  worst case, each addend truncated at alignment), then the bias and the
  BN replay; the rows whose value can be the
  cluster's largest within the slack (from the row and column norms) are
  summed again as a chain, and the pool is the largest of those;
- bf16_operands: the same, its top conv's product on exact bf16 products,
  each 16-deep mma rounded toward zero, and every output rounded to bf16;
- the post convs and heads: a k-order fmaf chain per cluster and output;
- logaddexp(a, 0) and the rsqrt(max(|o|^2, 1e-8)) normalisation.
Why the f32 modes keep the k-order chains: on the trained weights a few
clusters have an orientation vector of norm ~0.02-0.05, whose angle moves
by more than 1e-5 rad when any conv's sums change order
(test_tensor_cores_below_the_top_conv_would_move_orientations); the card's
plain version (cuBLAS f32) and the previous K6 sum in that order and agree
to 2.4e-7 rad. Inputs: the paper widths, 256 clusters with an empty ball,
repeat-padded duplicates and a partial ball: Gaussian clusters with seeded
weights (perturbed BN statistics), and a vendored cloud's ball-query
clusters with the trained ckpt/4480 weights. On the trained case the
orientation is also held to JAX's within the spread of JAX's own sum
orders. The W fragments the wrapper lays out for the card are checked
against the PTX fragment layout.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feat3dnet_tpu.config import ModelConfig as JaxModelConfig
from feat3dnet_tpu.ops import fused_describe as jfd
from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.data.io import example_cloud_path, load_point_cloud
from feat3dnet_tpu_torch.ops import fused_describe as tfd
from feat3dnet_tpu_torch.ops import hash_grid as thg
from feat3dnet_tpu_torch.utils import init_variables, load_variables_npz
from tests.tf32_emulation import (PRODUCTS, bf16_matmul, bias_bn, chain_matmul, pooled_conv,
                                  round_toward_zero, tf32_rna)

torch.set_num_threads(2)

B = 256
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "feat3dnet_tpu_torch", "assets", "ckpt4480_variables.npz")


F32_PRODUCT = "tf32x1"      # K6's product in the f32 modes


def emulate_k6(weights_t, clusters, cfg, unfolded, bf16=False, tc_below_top=False,
               product=None):
    """(attention, orientation, the top conv's (input, kernel, mask)) of K6,
    emulated; tc_below_top: the per-slot convs below the top one on the
    tensor cores too (what the kernel does not do); product: the top
    conv's (PRODUCTS; K6's default for the mode)."""
    product = product or ("bf16" if bf16 else F32_PRODUCT)
    rnd = tfd._round_bf16 if bf16 else (lambda t: t)
    convs, heads = tfd._detector_layers(weights_t, cfg, unfolded)
    n_det = len(cfg.detector_mlp)
    x = clusters.float()
    nb, ns = x.shape[:2]
    r = torch.tensor(cfg.base_scale, dtype=torch.float32)
    d2 = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
    d2 = d2 + x[..., 2] * x[..., 2]
    in_ball = d2 < (r * r).item()
    empty = ~in_ball.any(dim=1, keepdim=True)
    slots = torch.arange(ns).expand_as(d2)
    first = torch.where(d2 <= d2.min(dim=1, keepdim=True).values, slots, ns)
    first = first.min(dim=1, keepdim=True).values
    mask = in_ball | (empty & (slots == first))
    xs = rnd(x / r if unfolded else x * (1.0 / r))
    dup = (xs == xs[:, :1]).all(dim=-1)                 # repeats slot 0 (a ball query's padding)
    dup[:, 0] = False
    h = xs.reshape(-1, 3)
    h = torch.cat([h, torch.zeros_like(h[:, :1])], dim=1)      # (x, y, z, 0)
    for li, layer in enumerate(convs[:n_det]):
        k, b, mu, mul, beta = layer
        w = rnd(k.t())[:h.shape[1]]
        if li == n_det - 1:
            top = (h, w, layer, mask, dup)
            g = pooled_conv(h, w, layer, mask, dup, product)[0]
            break
        if li > 0 and tc_below_top:
            acc = PRODUCTS["bf16" if bf16 else "tf32x3"](h, w)
        else:
            acc = chain_matmul(h, w)
        h = rnd(torch.relu(bias_bn(acc, b, mu, mul, beta)))
    for k, b, mu, mul, beta in convs[n_det:]:
        g = rnd(torch.relu(bias_bn(chain_matmul(g, rnd(k.t())), b, mu, mul, beta)))
    a, o = (chain_matmul(g, rnd(k.t())) + b[:, 0] for k, b in heads)
    a = a[:, 0]
    att = torch.clamp(a, min=0.0) + torch.log1p(torch.exp(-a.abs()))
    inv = 1.0 / torch.sqrt(torch.clamp(o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1], min=1e-8))
    return att, torch.atan2(o[:, 1] * inv, o[:, 0] * inv), top


def _special(c):
    c[5] += 30.0                                   # empty ball -> nearest fallback
    c[7, 32:] = c[7, :32]                          # repeat-padded duplicates
    c[9, 32:] += 30.0                              # partial ball
    return c


def _gaussian_clusters():
    return _special((np.random.RandomState(11).randn(B, 64, 3) * 1.6).astype(np.float32))


def _cloud_clusters():
    """What the extraction feeds K6: the origin-centred K4 clusters of B
    Morton-sorted centres of a vendored Oxford cloud (every 64th)."""
    cloud = load_point_cloud(example_cloud_path("oxford_270.bin"))[:, :3]
    sc = thg.build_sorted_cloud_host(cloud, cell_size=2.0, block_size=256)
    ctr = torch.from_numpy(sc.pts4[:64 * B:64, :3].copy())
    grouped, _, _ = thg.ball_query_grouped_sorted(sc.to("cpu"), ctr, 2.0, 64)
    return _special((grouped - ctr[:, None, :]).numpy())


MODES = {"unfolded": dict(unfolded=True), "folded": dict(unfolded=False),
         "bf16_operands": dict(unfolded=True, bf16=True)}


@functools.lru_cache(maxsize=None)
def _case(kind):
    """Seeded weights (perturbed BN statistics) on Gaussian clusters; the
    trained weights on a vendored cloud's clusters."""
    cfg = ModelConfig()
    if kind == "seeded":
        return cfg, init_variables(cfg, seed=2, bn_perturb=0.1), _gaussian_clusters()
    return cfg, load_variables_npz(NPZ), _cloud_clusters()


def _weights(cfg, v, unfolded):
    return (tfd.transpose_unfolded_detector(tfd.detector_weights_unfolded(v, cfg)) if unfolded
            else tfd.transpose_folded_weights(tfd.folded_weights(v, cfg)))


@functools.lru_cache(maxsize=None)
def _emulated(kind, mode, tc_below_top=False):
    cfg, v, c = _case(kind)
    kw = MODES[mode]
    return emulate_k6(_weights(cfg, v, kw["unfolded"]), torch.from_numpy(c), cfg,
                      tc_below_top=tc_below_top, **kw)


@functools.lru_cache(maxsize=None)
def _plain(kind, mode):
    cfg, v, c = _case(kind)
    kw = MODES[mode]
    return tfd.fused_detect_clusters_plain(_weights(cfg, v, kw["unfolded"]), torch.from_numpy(c),
                                           cfg, unfolded=kw["unfolded"],
                                           bf16_operands=kw.get("bf16", False))


@functools.lru_cache(maxsize=None)
def _chain_orientation(kind, mode):
    """The plain version's orientation with every product a k-order fmaf
    chain: the order the card's plain version (cuBLAS f32) sums in."""
    saved = torch.matmul
    try:
        torch.matmul = lambda a, b: chain_matmul(a.reshape(-1, a.shape[-1]), b).reshape(
            *a.shape[:-1], b.shape[-1])
        _plain.cache_clear()
        return _plain(kind, mode)[1]
    finally:
        torch.matmul = saved
        _plain.cache_clear()


def _angle(d):
    """|d| as an angle, wrapped to [0, pi]."""
    return ((d + np.pi) % (2 * np.pi) - np.pi).abs()


def _errors(att, ori, att_ref, ori_ref):
    rel = (att - att_ref).abs() / att_ref.abs().clamp(min=1e-6)
    return rel, _angle(ori - ori_ref)


def _hold(kind, mode, att_ref, ori_ref):
    """The emulated K6 within 1e-5 (attention relative, orientation rad) of
    the reference. On the trained case the CPU references' own f32 sums
    hold a few orientations only to ~3e-5 rad (the plain version at chunk 1
    and at chunk 8192 differ by 1.3e-5), so there the orientation is held
    to the plain version summed in k order, as the card's plain version
    sums."""
    att, ori, _ = _emulated(kind, mode)
    if kind == "trained":
        ori_ref = _chain_orientation(kind, mode)
    rel, o_err = _errors(att, ori, att_ref, ori_ref)
    assert rel.max().item() <= 1e-5 and o_err.max().item() <= 1e-5, (
        rel.max().item(), o_err.max().item())


@pytest.mark.parametrize("kind", ["seeded", "trained"])
@pytest.mark.parametrize("mode", ["unfolded", "folded"])
def test_emulated_k6_matches_plain(kind, mode):
    _hold(kind, mode, *_plain(kind, mode))


@pytest.mark.parametrize("kind", ["seeded", "trained"])
@pytest.mark.parametrize("mode", ["unfolded", "folded"])
def test_emulated_k6_matches_jax(kind, mode):
    """Against fused_detect_clusters_2d in Pallas interpret mode."""
    _, v, c = _case(kind)
    jcfg, unfolded = JaxModelConfig(), MODES[mode]["unfolded"]
    jw = jfd.detector_weights_unfolded(v, jcfg) if unfolded else jfd.folded_weights(v, jcfg)
    ja, jo = jfd.fused_detect_clusters_2d(jw, jnp.asarray(c), jcfg, tile=B, unfolded=unfolded)
    _hold(kind, mode, torch.from_numpy(np.array(ja)), torch.from_numpy(np.array(jo)))


def _jax_orientation_chunked(v, c, unfolded, kc):
    """JAX's detector tower (`_detector_heads_2d`, the algebra of its
    detector kernel) on clusters c, outside Pallas, with every product
    summed over K in chunks of kc (None: one dot), in f32: one of JAX's own
    sum orders. Returns the orientation angle."""
    jcfg = JaxModelConfig()
    w = jfd.detector_weights_unfolded(v, jcfg) if unfolded else jfd.folded_weights(v, jcfg)
    n_layers = len(jcfg.detector_mlp) + len(jcfg.detector_mlp2)
    it = iter([jnp.asarray(x) for x in w[:(5 * n_layers + 4) if unfolded else 2 * (n_layers + 2)]])

    def mm(a, k):
        step = a.shape[1] if kc is None else kc
        acc = jnp.dot(a[:, :step], k[:step], precision=jax.lax.Precision.HIGHEST)
        for c0 in range(step, a.shape[1], step):
            acc = acc + jnp.dot(a[:, c0:c0 + step], k[c0:c0 + step],
                                precision=jax.lax.Precision.HIGHEST)
        return acc

    b, ns = c.shape[:2]
    pts = jnp.transpose(jnp.asarray(c), (1, 0, 2)).reshape(-1, 3)       # slot-major rows
    r = jnp.float32(jcfg.base_scale)
    mask = jfd._membership_mask_2d(pts, b, ns, r * r)
    _, ori = jfd._detector_heads_2d(pts / r if unfolded else pts * (1.0 / r), mask,
                                    lambda: (next(it), next(it)), mm, jcfg, b, jnp.float32,
                                    next_bn=(lambda: (next(it), next(it), next(it)))
                                    if unfolded else None)
    return torch.from_numpy(np.arctan2(np.array(ori[:, 1]), np.array(ori[:, 0])))


@pytest.mark.parametrize("mode", ["unfolded", "folded"])
def test_trained_orientation_within_jax_sum_orders(mode):
    """The emulated K6's orientation on the trained case against JAX's, at
    a tolerance taken from JAX itself: JAX's detector summed in eight
    orders (each product over K whole or in chunks of 64 ... 1) spreads by
    up to 8.9e-5 rad on these clusters, and its tiles do not change its
    sums. The port's orientation must lie within that spread (margin 1x)
    of JAX's kernel (`fused_detect_clusters_2d` in Pallas interpret mode)
    and of every one of those orders, and the spread must stay under 1e-4
    rad. (The 1e-5 limit holds against the port's plain version summed in
    k order, test_emulated_k6_matches_plain.)"""
    _, v, c = _case("trained")
    unfolded = MODES[mode]["unfolded"]
    orders = [_jax_orientation_chunked(v, c, unfolded, kc) for kc in (None, 64, 32, 16, 8, 4, 2, 1)]
    spread = max(_angle(a - b).max().item() for a in orders for b in orders)
    jcfg = JaxModelConfig()
    jw = jfd.detector_weights_unfolded(v, jcfg) if unfolded else jfd.folded_weights(v, jcfg)
    _, jo = jfd.fused_detect_clusters_2d(jw, jnp.asarray(c), jcfg, tile=B, unfolded=unfolded)
    ori = _emulated("trained", mode)[1]
    far = [_angle(ori - ref).max().item() for ref in [torch.from_numpy(np.array(jo))] + orders]
    print(f"{mode}: JAX's spread {spread:.3e} rad, the port to JAX's kernel {far[0]:.3e}, "
          f"to each order up to {max(far[1:]):.3e}")
    assert 0.0 < spread <= 1e-4
    assert max(far) <= 1.0 * spread


@pytest.mark.parametrize("kind", ["seeded", "trained"])
@pytest.mark.parametrize("mode,product", [("unfolded", "tf32x1"), ("folded", "tf32x1"),
                                          ("unfolded", "tf32x1_aligned"),
                                          ("bf16_operands", "bf16"),
                                          ("bf16_operands", "bf16_aligned")])
def test_top_pool_candidates_give_the_chain_pool(kind, mode, product):
    """The top conv's pool from the tensor-core values and the slack: on
    the first 16 clusters every row's u~ lies within half its slack of the
    k-order chain's value, and the pool equals the chain's pool bit for
    bit, also with every addend of each mma truncated at alignment (the
    worst case tower_rel allows for); over all clusters few rows per
    cluster and channel are summed again (1xTF32 reads fewer bits, so its
    slack admits more)."""
    h, w, layer, mask, dup = _emulated(kind, mode)[2]
    pool, u_t, cand, slack = pooled_conv(h, w, layer, mask, dup, product)
    _, b, mu, mul, beta = layer
    few = slice(0, 16 * 64)
    u_c = bias_bn(chain_matmul(h[few], w), b, mu, mul, beta).reshape(16, 64, -1)
    assert ((u_t[:16] - u_c).abs() <= slack[:16] / 2).all()
    v = torch.relu(u_c)
    if mode == "bf16_operands":
        v = tfd._round_bf16(v)
    assert torch.equal(pool[:16], (v * mask[:16, :, None]).amax(dim=1))
    per = cand.sum(dim=1).float().mean().item()
    print(f"{kind} {mode} {product}: {per:.3f} candidates per cluster and channel")
    assert per <= (4.0 if product.startswith("tf32x1") else 1.5)


def test_emulated_k6_bf16_operands():
    """bf16_operands: >= 99.9 % of centres within 1e-4 of the plain bf16
    version (seeded case; the trained case against the plain version summed
    in k order), while the f32 arithmetic fails that limit."""
    for kind in ("seeded", "trained"):
        att_p, ori_p = _plain(kind, "bf16_operands")
        if kind == "trained":
            ori_p = _chain_orientation(kind, "bf16_operands")

        def within(att, ori):
            rel, o_err = _errors(att, ori, att_p, ori_p)
            return ((rel <= 1e-4) & (o_err <= 1e-4)).float().mean().item()

        assert within(*_emulated(kind, "bf16_operands")[:2]) >= 0.999, kind
        assert within(*_emulated(kind, "unfolded")[:2]) < 0.999, kind


@pytest.mark.parametrize("mode", ["folded", "bf16_operands"])
def test_tensor_cores_below_the_top_conv_would_move_orientations(mode):
    """Why the per-slot convs below the top one stay on the CUDA cores: on
    the tensor cores they move some trained orientations away from the
    k-order chains that the card's plain version sums, by more than 1e-5
    rad (f32), or take more than 0.1 % of the centres past 1e-4 (bf16: a
    flipped bf16 rounding below the pool)."""
    att, ori, _ = _emulated("trained", mode)
    att_tc, ori_tc, _ = _emulated("trained", mode, tc_below_top=True)
    rel, err = _errors(att_tc, ori_tc, att, ori)
    if mode == "bf16_operands":
        assert ((rel > 1e-4) | (err > 1e-4)).float().mean().item() > 1e-3
    else:
        assert err.max().item() > 1e-5


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
def test_k6_fragments_follow_the_mma_layout(bf16):
    """The wrapper's W fragments, read as mma.sync's B fragments: lane
    4 g + t of block (kb, nb) holds B(k0 + t, n0 + g) and B(k0 + t + 4, n0 +
    g) rounded to TF32 (m16n8k8), or the bf16 pairs B(k0 + 2t + {0, 1}, n0 +
    g) and B(k0 + 2t + {8, 9}, n0 + g) (m16n8k16), 8 bytes a lane, for the
    top per-slot conv, the one on the tensor cores; the offsets point at
    them and at its column norms (rounded up)."""
    cfg = ModelConfig(detector_mlp=(32, 64, 128))
    wt = tfd.transpose_unfolded_detector(
        tfd.detector_weights_unfolded(init_variables(cfg, seed=3, bn_perturb=0.1), cfg))
    flat, table, extra = tfd._detect_kernel_weights(wt, cfg, "cpu", True, bf16=bf16)
    assert extra.shape == (table.shape[0], 2)
    assert (extra[:2] == -1).all() and (extra[3:] == -1).all() and (extra[2] >= 0).all()
    cin, cout, w_off = table[2, :3].tolist()
    w = flat[w_off:w_off + cin * cout].reshape(cin, cout)
    wnorm = flat[extra[2, 1]:extra[2, 1] + cout]
    torch.testing.assert_close(wnorm, w.norm(dim=0) * 1.0001, rtol=1e-6, atol=0)
    kk = 16 if bf16 else 8
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    off = extra[2, 0].item()
    for kb in range(cin // kk):
        for nb in range(cout // 8):
            k0, n = kb * kk, nb * 8 + g
            base = off + (kb * (cout // 8) + nb) * 32 * 2           # 2 floats a lane
            got = flat[base:base + 64]
            if bf16:
                got = got.view(torch.bfloat16).reshape(32, 4).float()
                want = torch.stack([w[k0 + 2 * t, n], w[k0 + 2 * t + 1, n],
                                    w[k0 + 2 * t + 8, n], w[k0 + 2 * t + 9, n]], dim=1)
                assert torch.equal(got, tfd._round_bf16(want))
            else:
                want = torch.stack([tf32_rna(w[k0 + t, n]), tf32_rna(w[k0 + t + 4, n])], dim=1)
                assert torch.equal(got.reshape(32, 2), want)
    # the rounding the wrapper makes is the one the emulation models
    v = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    assert torch.equal(tfd._tf32_rna(v), tf32_rna(v))


@pytest.mark.parametrize("block_sums", [True, False])
def test_bf16_mma_model_rounds_toward_zero(block_sums):
    """The bf16 product's model: exact products, each 16-deep mma rounded
    toward zero, into block sums added rounding to nearest or onto the
    running accumulator."""
    a = torch.full((1, 32), 1.0 + 2.0 ** -7)
    b = torch.full((32, 1), 1.0 + 2.0 ** -7)
    p = 16 * (1.0 + 2.0 ** -7) ** 2
    blk = round_toward_zero(torch.tensor([[p]], dtype=torch.float64))
    want = blk + blk if block_sums else round_toward_zero(blk.double() + p)
    assert torch.equal(bf16_matmul(a, b, block_sums=block_sums), want)
