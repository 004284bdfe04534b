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
"""
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
