// Products on the tensor cores with mma.sync, shared by the training
// passes K7-K10 (fused_train.cu) and the detector-only tower K6
// (fused_detect.cu): m16n8k8 TF32 in the 3xTF32 split, which keeps f32
// accuracy; m16n8k8 TF32 on the f32 bits as they are (1xTF32); and
// m16n8k16 bf16 with f32 accumulators, exact for operands that are bf16
// values. A block of kTcThreads threads shares out the warp tiles of a
// product.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f3d {

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;

// ---- TF32 products: mma.sync m16n8k8, TF32
// operands in the 3xTF32 split (a = a_hi + a_lo, a_hi = tf32(a), a_lo =
// tf32(a - a_hi); a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi in f32), which
// keeps f32 accuracy. Fragments (PTX ISA), g = lane / 4, t = lane % 4:
// A 16x8 a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B 8x8
// b0 (t, g), b1 (t + 4, g); C 16x8 c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(__fsub_rn(v, __uint_as_float(hi))));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Three passes over the independent accumulators, the small terms first.
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[MT][NT][4], const uint32_t (&ah)[MT][4],
                                           const uint32_t (&al)[MT][4],
                                           const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q) mma_tf32(d[i][q], al[i], bh[q][0], bh[q][1]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q) mma_tf32(d[i][q], ah[i], bl[q][0], bl[q][1]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q) mma_tf32(d[i][q], ah[i], bh[q][0], bh[q][1]);
}

// D (M x N) = sum_{k < K} A(m, k) B(k, n) on the tensor cores, in warp tiles
// of (16 MT) x (8 NT) that the block's warps share out; tc_tile sums one. la(m, k) / lb(k, n)
// return the operand, 0 past M, N or K: ragged widths, pad slots and conv
// 0's 3-wide input go through the one path as zeros. st(m, n, d, p) takes
// each row's pair of outputs d = (D[m][n], D[m][n+1]) (m < 16 ceil(M / 16),
// n even) and p = lp(m, n), which is read before the tile's products so
// that a read-modify-write of device memory waits on no load.
// kBlockSums: each 8-deep block's products go into fresh accumulators that
// are added to the running sums with __fadd_rn. An mma may round its sum
// toward zero (the tensor cores truncate in alignment), and over a whole K
// that bias, always against the running sum's sign, shows in a mean over
// many rows (K7's statistics); block sums shrink it to the blocks' size.
template <bool kBlockSums, int MT, int NT, typename LA, typename LB>
__device__ __forceinline__ void tc_tile(int m0, int n0, int K, LA la, LB lb,
                                        float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + 16 * i + g;
      split_tf32(la(m, k0 + t), ah[i][0], al[i][0]);
      split_tf32(la(m + 8, k0 + t), ah[i][1], al[i][1]);
      split_tf32(la(m, k0 + t + 4), ah[i][2], al[i][2]);
      split_tf32(la(m + 8, k0 + t + 4), ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      split_tf32(lb(k0 + t, n0 + 8 * q + g), bh[q][0], bl[q][0]);
      split_tf32(lb(k0 + t + 4, n0 + 8 * q + g), bh[q][1], bl[q][1]);
    }
    if constexpr (kBlockSums) {
      float blk[MT][NT][4] = {};
      mma_3xtf32(blk, ah, al, bh, bl);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][q][e] = __fadd_rn(acc[i][q][e], blk[i][q][e]);
    } else {
      mma_3xtf32(acc, ah, al, bh, bl);
    }
  }
}

template <bool kBlockSums, int MT, int NT, typename LA, typename LB, typename LP, typename ST>
__device__ __forceinline__ void tc_product(int M, int N, int K, LA la, LB lb, LP lp, ST st) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles_n = (N + 8 * NT - 1) / (8 * NT);
  const int tiles = (M + 16 * MT - 1) / (16 * MT) * tiles_n;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += kTcWarps) {
    const int m0 = tile / tiles_n * 16 * MT, n0 = tile % tiles_n * 8 * NT;
    float2 prev[MT][NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        prev[i][q][0] = lp(m0 + 16 * i + g, n0 + 8 * q + 2 * t);
        prev[i][q][1] = lp(m0 + 16 * i + g + 8, n0 + 8 * q + 2 * t);
      }
    float acc[MT][NT][4];
    tc_tile<kBlockSums>(m0, n0, K, la, lb, acc);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int m = m0 + 16 * i + g, n = n0 + 8 * q + 2 * t;
        st(m, n, make_float2(acc[i][q][0], acc[i][q][1]), prev[i][q][0]);
        st(m + 8, n, make_float2(acc[i][q][2], acc[i][q][3]), prev[i][q][1]);
      }
  }
}

template <int kMT, int kNT>
struct WarpTile {
  static constexpr int MT = kMT, NT = kNT;
};

// f(WarpTile<MT, NT>{}) with the widest warp tile that still gives every
// warp a tile of an M x N product (the narrow products: conv 0's 3-wide dW
// and dx, 32-wide convs). The tile depends only on (M, N), so a product's
// summation order is fixed.
template <typename F>
__device__ __forceinline__ void with_warp_tile(int M, int N, F f) {
  auto tiles = [&](int mt, int nt) {
    return (M + 16 * mt - 1) / (16 * mt) * ((N + 8 * nt - 1) / (8 * nt));
  };
  if (tiles(2, 4) >= kTcWarps) f(WarpTile<2, 4>{});
  else if (tiles(1, 4) >= kTcWarps) f(WarpTile<1, 4>{});
  else if (tiles(1, 2) >= kTcWarps) f(WarpTile<1, 2>{});
  else f(WarpTile<1, 1>{});
}

// tc_product in with_warp_tile's tile.
template <bool kBlockSums = false, typename LA, typename LB, typename LP, typename ST>
__device__ __forceinline__ void tc_product_any(int M, int N, int K, LA la, LB lb, LP lp,
                                               ST st) {
  with_warp_tile(M, N, [&](auto w) {
    tc_product<kBlockSums, decltype(w)::MT, decltype(w)::NT>(M, N, K, la, lb, lp, st);
  });
}


// ---- bf16 products: mma.sync m16n8k16, bf16 operands, f32 accumulators.
// A product of two bf16 values is exact in f32; the accumulation may
// round toward zero, as in TF32 (kBlockSums as in tc_tile). Fragments, two
// bf16 in a 32-bit register, the lower k in the low half: A 16x16 a01 (g,
// 2t), a23 (g + 8, 2t), a45 (g, 2t + 8), a67 (g + 8, 2t + 8); B 16x8 b01
// (2t, g), b23 (2t + 8, g); C as m16n8k8's.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp tile of (16 MT) x (8 NT) over K (a multiple of 16): la2(m, k)
// returns the bf16 pair A(m, k), A(m, k + 1) (k even) as 32 bits; fb(k0, b)
// fills b[q] with B's fragment (b01, b23) of columns n0 + 8 q.
template <bool kBlockSums, int MT, int NT, typename LA2, typename FB>
__device__ __forceinline__ void tc_tile_bf16(int m0, int K, LA2 la2, FB fb,
                                             float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + 16 * i + g;
      a[i][0] = la2(m, k0 + 2 * t);
      a[i][1] = la2(m + 8, k0 + 2 * t);
      a[i][2] = la2(m, k0 + 2 * t + 8);
      a[i][3] = la2(m + 8, k0 + 2 * t + 8);
    }
    fb(k0, b);
    if constexpr (kBlockSums) {
      float blk[MT][NT][4] = {};
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < NT; ++q) mma_bf16(blk[i][q], a[i], b[q][0], b[q][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][q][e] = __fadd_rn(acc[i][q][e], blk[i][q][e]);
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < NT; ++q) mma_bf16(acc[i][q], a[i], b[q][0], b[q][1]);
    }
  }
}

// ---- 1xTF32 products: mma.sync m16n8k8 on TF32 operands, one running f32
// accumulator. For a product whose result only has to be within a known
// bound (K6's pool candidates).

// One warp tile of (16 MT) x (8 NT) over K (a multiple of 8), with A in
// shared memory (f32, row stride ld floats, 16-byte aligned rows): each
// 16 x 8 A fragment one ldmatrix.x4 (four 8 x 4 f32 blocks, rows
// m0 + 16 i + {0, 8}, columns k0 + {0, 4}), each element then pre(bits)
// (the tensor cores read 10 of its 23 mantissa bits); fb(k0, b) fills b[q]
// with B(k0 + t, n0 + 8 q + g) and B(k0 + t + 4, n0 + 8 q + g) as TF32.
template <int MT, int NT, typename PRE, typename FB>
__device__ __forceinline__ void tc_tile_tf32(const float* a_smem, int ld, int m0, int K, PRE pre,
                                             FB fb, float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  // ldmatrix: lanes 8 j .. 8 j + 7 give the rows of block j
  const float* base = a_smem + (m0 + (j & 1) * 8 + (lane & 7)) * ld + (j >> 1) * 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t addr =
          static_cast<uint32_t>(__cvta_generic_to_shared(base + 16 * i * ld + k0));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                   : "=r"(a[i][0]), "=r"(a[i][1]), "=r"(a[i][2]), "=r"(a[i][3])
                   : "r"(addr));
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] = pre(a[i][e]);
    }
    fb(k0, b);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < NT; ++q) mma_tf32(acc[i][q], a[i], b[q][0], b[q][1]);
  }
}

}  // namespace f3d
