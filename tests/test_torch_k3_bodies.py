"""K3's decomposition bodies 'matmul' and 'matmul_2d' (csrc/fused_describe.cu,
the modes of `_ablate_kernel_t` and `_ablate_kernel_2d`), emulated in torch
on the CPU against their plain version, before a card runs them.

The kernel runs a body on the f32 forward's code: the per-slot convs below
the pooled ones as k-order fmaf chains (f3d::slot_layer), the two pooled
convs (the detector's top conv, the descriptor's mid conv) on 1xTF32
mma.sync tiles with each pool summed straight from the accumulators
(sum_pool_layer: a lane's eight rows, then shuffles over the tile's row
groups), the descriptor's pool summed in slot order, and the single-row
layers as k-order chains. Its plain version (`_describe_ablate_plain`)
rounds both operands of the two pooled convs to TF32 and sums in f32.

* The kernel's sum order: emulated at the paper widths on 256 ball-query
  clusters of a vendored Oxford cloud (tests/test_torch_k3_tc.py's), with
  seeded and trained weights, the tensor cores' accumulation modelled as
  tests/tf32_emulation.py does (also with every addend truncated at
  alignment): within 1e-5 of max|ref| of the plain version, the limit the
  card holds the kernel to (measured 1.6e-7 - 4.0e-6).
* The rounding's placement: the plain version against an independent
  float64 evaluation that rounds the same operands to TF32, within 1e-5 of
  max|ref|, on inputs for which every value before a pooled conv is exact
  in f32 (coordinates and the first convs on a 2^-8 grid), so both round
  the same numbers and only the placement can differ; the all-f32 version
  is not within that limit, so the check sees a missing rounding.
"""
import numpy as np
import pytest
import torch

from feat3dnet_tpu_torch.config import ModelConfig
from feat3dnet_tpu_torch.ops import fused_describe as tfd
from feat3dnet_tpu_torch.utils import init_variables
from tests.test_torch_k3_tc import _case
from tests.tf32_emulation import PRODUCTS, chain_matmul, tile_row_sums

torch.set_num_threads(2)

BODIES = ("matmul", "matmul_2d")


def k3_body(weights_t, clusters, cfg, mode, product):
    """K3's body `mode` on (nb, ns, 3) clusters and transposed folded
    weights, as the kernel sums it: the pooled convs' products from
    `product` (a key of PRODUCTS), every other product an fmaf chain in k
    order. Returns (desc (nb, D) unnormalised, att (nb,))."""
    n_det, n_det2, n_desc = len(cfg.detector_mlp), len(cfg.detector_mlp2), len(cfg.descriptor_mlp)
    ws = iter(weights_t)

    def next_w():
        k, b = next(ws), next(ws)
        return k.t(), b                               # (Cin, Cout), (Cout, 1)

    def dense(h, w, b):
        return chain_matmul(h, w[:h.shape[1]]) + b[:, 0]

    def sum_pool(h, w, b):
        return tile_row_sums(PRODUCTS[product](h, w) + b[:, 0], keep)

    x = clusters.to(torch.float32)
    nb, ns = x.shape[:2]
    slots = torch.arange(64)
    keep = (slots < ns if mode == "matmul" else slots == 0).expand(nb, 64)
    xin = torch.zeros((nb, 64, 4))                    # the padded slots' coordinates are 0
    xin[:, :ns, :3] = x
    h = xin.reshape(-1, 4)
    for _ in range(n_det - 1):
        h = dense(h, *next_w())
    g = sum_pool(h, *next_w())
    for _ in range(n_det2):
        g = dense(g, *next_w())
    wa, ba = next_w()
    wo, bo = next_w()
    att = dense(g, wa, ba)[:, 0] + dense(g, wo, bo)[:, 0] * 1e-30
    h = xin.reshape(-1, 4)
    for _ in range(n_desc):
        h = dense(h, *next_w())
    d = h.reshape(nb, 64, -1)
    if mode == "matmul":
        p = torch.zeros((nb, d.shape[2]))
        for s in range(64):                           # slot order, the padded slots' weight 0
            p = p + d[:, s] * keep[:, s, None].float()
        cat = torch.cat([d, p[:, None].expand_as(d)], dim=2)
    else:
        cat = torch.cat([d, d], dim=2)
    m = sum_pool(cat.reshape(nb * 64, -1), *next_w())
    return dense(m, *next_w()), att


def _share(got, want):
    """max |got - want| over max |want|, for each of (desc, att)."""
    return tuple((g - w).abs().max().item() / w.abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["seeded", "trained"])
@pytest.mark.parametrize("mode", BODIES)
@pytest.mark.parametrize("product", ["tf32x1", "tf32x1_aligned"])
def test_emulated_body_is_the_plain_version(kind, mode, product):
    cfg, wt, c = _case(kind, 64)
    got = k3_body(wt, c, cfg, mode, product)
    x = torch.from_numpy(tfd.pack_clusters_lanes(c.numpy()))
    want = tfd.fused_describe_clusters_t_plain(wt, x, cfg, ablate=mode)
    share = _share(got, want)
    print(f"{kind} {mode} {product}: desc, att {share[0]:.3e}, {share[1]:.3e} of max|ref|")
    assert max(share) <= 1e-5


# coordinates and the first convs' weights and biases on this grid: every
# value before a pooled conv is then exact in f32 (below 2^24 of its steps)
GRID = 2.0 ** -8
EXACT = dict(num_samples=16, base_scale=1.0, detector_mlp=(32, 64), detector_mlp2=(32,),
             descriptor_mlp=(32,), feature_dim=16)


def _on_grid(t):
    return torch.round(t / GRID) * GRID


def _tf32_f64(a):
    """float64 -> f32 -> TF32 (round to nearest, ties away from zero, as
    cvt.rna.tf32.f32) -> float64, in numpy."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1FFF).view(np.float32).astype(np.float64)


def f64_body(weights_t, clusters, cfg, mode):
    """The body in float64 (numpy), both operands of the two pooled convs
    rounded to TF32."""
    n_det, n_det2, n_desc = len(cfg.detector_mlp), len(cfg.detector_mlp2), len(cfg.descriptor_mlp)
    ws = [w.numpy().astype(np.float64) for w in weights_t]
    layers = iter(zip(ws[::2], ws[1::2]))                       # (Cout, Cin), (Cout, 1)

    def dense(h, tf32=False):
        k, b = next(layers)
        k = k[:, :h.shape[-1]]
        return (_tf32_f64(h) @ _tf32_f64(k).T if tf32 else h @ k.T) + b[:, 0]

    x = clusters.astype(np.float64)                             # (nb, ns, 3)
    h = x
    for i in range(n_det):
        h = dense(h, tf32=i == n_det - 1)
    g = h[:, 0] if mode == "matmul_2d" else h.sum(axis=1)
    for _ in range(n_det2):
        g = dense(g)
    att = dense(g)[:, 0] + dense(g)[:, 0] * 1e-30
    d = x
    for _ in range(n_desc):
        d = dense(d)
    if mode == "matmul_2d":
        m = dense(np.concatenate([d[:, 0], d[:, 0]], axis=-1), tf32=True)
    else:
        pool = np.broadcast_to(d.sum(axis=1, keepdims=True), d.shape)
        m = dense(np.concatenate([d, pool], axis=-1), tf32=True).sum(axis=1)
    return dense(m), att


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", BODIES)
def test_plain_body_rounds_the_pooled_operands(seed, mode):
    cfg = ModelConfig(**EXACT)
    rs = np.random.RandomState(seed)
    wt = tfd.transpose_folded_weights(
        tfd.folded_weights(init_variables(cfg, seed=seed, bn_perturb=0.1), cfg))
    first = (0, 2 * (len(cfg.detector_mlp) + len(cfg.detector_mlp2) + 2))
    for li in first:
        wt[li], wt[li + 1] = _on_grid(wt[li]), _on_grid(wt[li + 1])
    c = _on_grid(torch.from_numpy(rs.randn(200, cfg.num_samples, 3).astype(np.float32) * 0.8))
    x = torch.from_numpy(tfd.pack_clusters_lanes(c.numpy()))
    want = f64_body(wt, c.numpy(), cfg, mode)
    want = tuple(torch.from_numpy(w) for w in want)
    share = _share(tfd.fused_describe_clusters_t_plain(wt, x, cfg, ablate=mode), want)
    f32 = _share(tfd._describe_ablate_plain(wt, x.reshape(cfg.num_samples, 8, -1), cfg, mode,
                                            tf32=False), want)
    print(f"seed {seed} {mode}: TF32 plain {share}, f32 plain {f32} of max|ref|")
    assert max(share) <= 1e-5
    assert max(f32) > 1e-4
    assert max(f32) <= tfd.ABLATE_F32_LIMIT
