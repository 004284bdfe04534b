"""Emulation in torch, on the CPU, of the tensor-core products of the
port's kernels (csrc/tc_mma.cuh), for tests that hold that arithmetic
against the plain versions and the JAX reference before a card does.

3xTF32 (mma.sync m16n8k8): each operand v becomes hi = tf32(v)
(cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10 mantissa
bits) and lo = tf32(v - hi); each 8-deep block of the product sums lo·hi,
then hi·lo, then hi·hi into fresh f32 accumulators (lo·lo is dropped), and
the block sums are added to the running sums with __fadd_rn (K7-K10), or
all go onto one running accumulator (K6's top conv). A product of two
TF32 values is exact in f32; an mma's eight are summed in float64 onto its
accumulator and the result rounded toward zero to f32 (the tensor cores
truncate in alignment: the pessimistic model).

bf16 (mma.sync m16n8k16): a product of two bf16 values is exact in f32;
an mma's sixteen are summed in float64 onto its accumulator and rounded
toward zero to f32.

aligned=True (K6's products, whose slack must hold the worst case): each
mma aligns its addends, the accumulator and its products, to the largest
of them and truncates each toward zero at 2^-23 of that one before it sums
them, then truncates the sum toward zero to f32.

The pooled convs of K6 and K3 (csrc/tower_pool.cuh): `chain_matmul` sums
each output as one fmaf chain in k order; `pooled_conv` picks a pool's
candidate rows from a tensor-core product and the slack (`tower_rel`,
`pool_slack`) and re-sums them as chains. K3's decomposition bodies sum a
pool straight from the product's warp tiles (`tile_row_sums`).
"""
import functools

import numpy as np
import torch


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bit pattern: add half of the 13 dropped
    bits' weight to the magnitude, then clear them."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def round_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, block_sums: bool = True) -> torch.Tensor:
    """a (R, K) @ b (K, N) in f32 as tc_tile sums it: with block sums (the
    recompute of K7-K10), or (block_sums=False, K6's top conv) every mma
    onto the one running accumulator."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        blk = torch.zeros_like(acc) if block_sums else acc
        for p, q in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            blk = round_toward_zero(blk.double() + p[:, k].double() @ q[k].double())
        acc = acc + blk if block_sums else blk
    return acc


def aligned_mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc (R, N) + a (R, k) @ b (k, N) as one mma, its addends truncated at
    alignment (the module's aligned model); the products exact, in rows of
    512 at a time."""
    out = torch.empty_like(acc)
    for r0 in range(0, acc.shape[0], 512):
        r = slice(r0, r0 + 512)
        terms = torch.cat([acc[r].double()[:, None], a[r].double()[:, :, None] * b.double()],
                          dim=1)                                      # (rows, 1 + k, N)
        _, e = torch.frexp(terms.abs().amax(dim=1, keepdim=True))
        ulp = torch.ldexp(torch.ones(e.shape, dtype=torch.float64), e - 24)   # 2^-23 of it
        out[r] = round_toward_zero((torch.trunc(terms / ulp) * ulp).sum(dim=1))
    return out


def tf32x1_matmul(a: torch.Tensor, b: torch.Tensor, aligned: bool = False) -> torch.Tensor:
    """a (R, K) @ b (K, N) as K6's 1xTF32 product sums it: both operands
    rounded to TF32 (A's bits plus half a TF32 ulp, truncated by the tensor
    cores: ties away from zero, as B's cvt.rna), every mma onto the one
    running accumulator."""
    a_h, b_h = tf32_rna(a.contiguous()), tf32_rna(b.contiguous())
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        acc = (aligned_mma(acc, a_h[:, k], b_h[k]) if aligned else
               round_toward_zero(acc.double() + a_h[:, k].double() @ b_h[k].double()))
    return acc


def bf16_matmul(a: torch.Tensor, b: torch.Tensor, block_sums: bool = True,
                aligned: bool = False) -> torch.Tensor:
    """a (R, K) @ b (K, N), both bf16 values in f32, as tc_tile_bf16 sums
    it: exact products, each 16-deep mma rounded toward zero, into fresh
    block sums added rounding to nearest, or (block_sums=False) onto the one
    running accumulator (aligned: K6's top conv)."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        k = slice(k0, k0 + 16)
        if aligned and not block_sums:
            acc = aligned_mma(acc, a[:, k], b[k])
            continue
        prod = a[:, k].double() @ b[k].double()
        acc = (acc + round_toward_zero(prod) if block_sums
               else round_toward_zero(acc.double() + prod))
    return acc


def _fma(a, b, c):
    """fmaf: one rounding of a * b + c (the product is exact in float64)."""
    return (a * b + c.double()).float()


def chain_matmul(a, b):
    """a (R, K) @ b (K, N) as one fmaf chain in k order per output."""
    a, b = a.double(), b.double()
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k in range(a.shape[1]):
        acc = _fma(a[:, k:k + 1], b[k], acc)
    return acc


def round_bf16(t):
    """To the nearest bf16 (ties to even), as f32."""
    return t.to(torch.bfloat16).float()


# a pooled conv's product on the tensor cores, as tc_mma.cuh sums it (and
# *_aligned: each addend truncated at alignment, the worst case the slack
# must hold); tf32x3 for products below the pooled ones (K6's test)
PRODUCTS = {"tf32x1": tf32x1_matmul,
            "tf32x1_aligned": functools.partial(tf32x1_matmul, aligned=True),
            "tf32x3": lambda a, b: tf32x3_matmul(a, b, block_sums=False),
            "bf16": lambda a, b: bf16_matmul(a, b, block_sums=False),
            "bf16_aligned": lambda a, b: bf16_matmul(a, b, block_sums=False, aligned=True)}


def bias_bn(acc, b, mu, mul, beta):
    """Dense bias, then the replayed BN where mu is given; vectors (C, 1)."""
    v = acc + b[:, 0]
    return v if mu is None else (v - mu[:, 0]) * mul[:, 0] + beta[:, 0]


def tower_rel(product, cin):
    """csrc/tower_pool.cuh:tower_rel."""
    chain = 5.97e-8 * cin
    if product.startswith("bf16"):
        return 2.0 * (chain + 1.1921e-7 * (cin // 16) * 18 + 1e-7)
    return 2.0 * (chain + 1.1921e-7 * (cin // 8) * 10 + 9.8e-4)


def tower_rel_sums(product, cin):
    """csrc/tower_pool.cuh:tower_rel_sums (tower_rel without the operands'
    term)."""
    chain = 5.97e-8 * cin
    if product.startswith("bf16"):
        return 2.0 * (chain + 1.1921e-7 * (cin // 16) * 18)
    return 2.0 * (chain + 1.1921e-7 * (cin // 8) * 10)


def tower_rel_operands(product):
    """csrc/tower_pool.cuh:tower_rel_operands."""
    return 2e-7 if product.startswith("bf16") else 1.96e-3


def pool_slack(b, mu, mul, beta, rel, hnorm, wnorm):
    """csrc/tower_pool.cuh's slack (slack_coefs), (rows, C) for row norms
    hnorm."""
    s = hnorm[:, None] * wnorm + b[:, 0].abs()
    if mu is None:
        return rel * s + 1e-30
    return rel * (mul[:, 0].abs() * (s + mu[:, 0].abs()) + beta[:, 0].abs()) + 1e-30


def pooled_conv(h, w, layer, mask, dup, product, relu=True, shared_from=None):
    """A pooled conv's max pool as csrc/tower_pool.cuh:pooled_conv takes it,
    from its input h (nb * ns, cin) and kernel w (cin, C), with layer (k,
    b, mu, mul, beta) giving the bias and BN (mu None: none) and mask, dup
    (nb, ns): u~ the values of the tensor-core product (before the ReLU),
    s the slack; the candidates, the masked rows with u~ + s >= L, L the
    cluster's largest u~ - s over its masked rows (relu: at least 0), that
    do not repeat slot 0 (dup); the pool, the largest of the candidates'
    values summed as k-order chains (relu: ReLU, then bf16 in the bf16
    products; else bf16 in the bf16 products, and -1e30 where a cluster has
    no candidate). shared_from (no ReLU; K3's mid conv): the input columns
    from there on are the same in every row of a cluster, and the slack
    leaves their operands' rounding out (kShared). Returns (pool (nb, C),
    u~, candidates, s), (nb, ns, C)."""
    _, b, mu, mul, beta = layer
    nb, ns = mask.shape
    bf16 = product.startswith("bf16")
    cin = w.shape[0]
    u_t = bias_bn(PRODUCTS[product](h, w), b, mu, mul, beta).reshape(nb, ns, -1)
    hnorm, wnorm = h.norm(dim=1) * 1.0001, w.norm(dim=0) * 1.0001
    if shared_from is None:
        slack = pool_slack(b, mu, mul, beta, tower_rel(product, cin), hnorm, wnorm)
    else:
        assert not relu and mu is None
        k = shared_from
        slack = (pool_slack(b, mu, mul, beta, tower_rel_sums(product, cin), hnorm, wnorm)
                 + tower_rel_operands(product) * (h[:, :k].norm(dim=1)[:, None] * 1.0001)
                 * (w[:k].norm(dim=0) * 1.0001))
    slack = slack.reshape(nb, ns, -1)
    m = mask[..., None]
    lo = torch.where(m, u_t - slack, torch.tensor(-np.inf)).amax(dim=1, keepdim=True)
    if relu:
        lo = torch.clamp(lo, min=0.0)
    cand = m & ~dup[..., None] & (u_t + slack >= lo)
    ci, si, ni = cand.nonzero(as_tuple=True)
    hr, wc = h.reshape(nb, ns, -1)[ci, si].double(), w.t()[ni].double()
    y = torch.zeros(ci.shape[0])
    for k in range(h.shape[1]):
        y = (hr[:, k] * wc[:, k] + y.double()).float()
    u_c = y + b[ni, 0]
    if mu is not None:
        u_c = (u_c - mu[ni, 0]) * mul[ni, 0] + beta[ni, 0]
    v = torch.relu(u_c) if relu else u_c
    if bf16:
        v = round_bf16(v)
    out = torch.full((nb * w.shape[1],), 0.0 if relu else -1.0e30)
    pool = out.scatter_reduce(0, ci * w.shape[1] + ni, v, "amax", include_self=True)
    return pool.reshape(nb, -1), u_t, cand, slack


def tile_row_sums(v, keep):
    """The sum pool of csrc/fused_describe.cu:sum_pool_layer: v (nb * 64,
    C), the product plus the bias per row, summed over the rows whose keep
    (nb, 64) is set, in the order of a warp tile's m16n8 accumulators. Lane
    (g, t) holds rows 16 i + 8 r + g of the cluster: it sums its eight (i,
    then r), then shuffles add lanes g ^ 1, g ^ 2, g ^ 4. Returns (nb, C)."""
    nb = keep.shape[0]
    v = torch.where(keep.reshape(-1, 1), v, torch.zeros(())).reshape(nb, 4, 2, 8, -1)
    s = torch.zeros((nb, 8, v.shape[-1]))
    for i in range(4):
        for r in range(2):
            s = s + v[:, i, r]
    g = torch.arange(8)
    for bit in (1, 2, 4):
        s = s + s[:, g ^ bit]
    return s[:, 0]
