// The cluster towers' max-pooled per-slot convs on the tensor cores,
// shared by K6 (fused_detect.cu: the detector's top conv) and K3
// (fused_describe.cu: the detector's top conv and the descriptor's mid
// conv), with the pieces both kernels build around them: kC = 2 clusters a
// block of 8 warps (kRows = 128 slot rows), the layer table, a channel's
// bias / BN / ReLU epilogue, the membership mask and the k-order chains of
// the single-row layers.
//
// Why a pooled conv is summed twice. The kernels' outputs must equal those
// of the previous FFMA designs, whose sums ran in k order, one fmaf chain
// per output, as the plain versions' cuBLAS f32 GEMMs do on this card: on
// the trained weights some clusters have an orientation vector of norm
// ~0.02-0.05, and summing any conv in another order moves their angle by
// 1e-5-1e-4 rad (tests/test_torch_k6_tc.py), past K6's limit, and K3
// rotates its descriptor's input by that angle. So the tensor cores only
// decide which sums to do: pooled_conv runs the product on mma.sync
// (1xTF32 through ldmatrix in f32, bf16 m16n8k16 on bf16 operands), never
// stores it, and marks per tile and channel the rows whose value can be the
// pool's maximum within a slack that bounds the two sums' difference (from
// the row and column norms: slack_coefs, tower_rel); after the product a
// thread per channel sums its marked rows as k-order fmaf chains (pool_sum)
// and the pool is the largest. The value of a max pool is the value of one
// row, so it equals the chain's pool bit for bit. Rows repeating slot 0 of
// their cluster (a ball query's padding) are never marked: their sums are
// slot 0's. K3's decomposition bodies, whose pools are sums, take the same
// 1xTF32 warp tiles' products (tf32_tile_product) and sum them in their
// epilogue.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"
#include "slot_layer.cuh"
#include "tc_mma.cuh"

namespace f3d {
namespace tower {

constexpr int kThreads = kTcThreads;
constexpr int kWarps = kTcWarps;
constexpr int kSlots = kTowerSlots;  // slots per cluster, padded (ns <= 64)
constexpr int kMaxC = 256;           // widest conv
constexpr int kC = 2;                // clusters per block
constexpr int kMT = 4;               // a pooled conv's warp tile: kMT m16 tiles by 8 / kMT n8 tiles
constexpr int kRows = kC * kSlots;

// One layer's offsets into the flat weight buffer: W (cin, cout), bias, the
// replayed BN's mean, mul and bias, the W fragments for the tensor cores
// and the column 2-norms; -1 = none.
struct Layer { int cin, cout, w, b, mu, mul, beta, frag, wnorm; };

// Ball membership of one cluster's 64 slots, for the warp whose lane is
// `lane`: d2 < r2, and an empty ball keeps the FIRST slot at the minimum
// distance (the reference ball query's tie order). Writes mask[0..63] as
// 0/1.
__device__ __forceinline__ void membership(const float* d2s, float r2, float* mask, int lane) {
  const float da = d2s[lane], db = d2s[lane + 32];
  const bool ia = da < r2, ib = db < r2;
  const int count = __popc(__ballot_sync(0xffffffffu, ia)) +
                    __popc(__ballot_sync(0xffffffffu, ib));
  float dmin = fminf(da, db);
  for (int off = 16; off > 0; off >>= 1)
    dmin = fminf(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
  const unsigned lo = __ballot_sync(0xffffffffu, da <= dmin);
  const unsigned hi = __ballot_sync(0xffffffffu, db <= dmin);
  const int first = lo ? __ffs(lo) - 1 : 32 + __ffs(hi) - 1;
  mask[lane] = (ia || (count == 0 && first == lane)) ? 1.f : 0.f;
  mask[lane + 32] = (ib || (count == 0 && first == lane + 32)) ? 1.f : 0.f;
}

// A channel's epilogue: Dense bias, the replayed BN where the layer has
// one, ReLU, then the bf16 rounding in the bf16 mode.
struct Chan {
  float b, mu, mul, beta;
};

__device__ __forceinline__ Chan chan(const Layer& L, const float* __restrict__ wts, int c) {
  const bool bn = L.mu >= 0;
  return Chan{__ldg(wts + L.b + c), bn ? __ldg(wts + L.mu + c) : 0.f,
              bn ? __ldg(wts + L.mul + c) : 0.f, bn ? __ldg(wts + L.beta + c) : 0.f};
}

// Bias and BN, before the ReLU.
__device__ __forceinline__ float bn_pre(float acc, const Chan& ch, bool bn) {
  const float v = acc + ch.b;
  return bn ? __fadd_rn(__fmul_rn(__fsub_rn(v, ch.mu), ch.mul), ch.beta) : v;
}

template <bool kBf16>
__device__ __forceinline__ float bn_relu(float acc, const Chan& ch, bool bn) {
  const float v = fmaxf(bn_pre(acc, ch, bn), 0.f);
  return kBf16 ? round_bf16(v) : v;
}

// A pooled conv's value of a row from its sum: bias, BN, then ReLU and the
// bf16 rounding (kRelu), or the bf16 rounding alone.
template <bool kBf16, bool kRelu>
__device__ __forceinline__ float pool_value(float acc, const Chan& ch, bool bn) {
  if constexpr (kRelu) return bn_relu<kBf16>(acc, ch, bn);
  const float v = bn_pre(acc, ch, bn);
  return kBf16 ? round_bf16(v) : v;
}

// acc[c] += sum_k x[c * kMaxC + k] W[k * stride] (c < kN) over k < cin, one fmaf
// chain in k order per c; W's column read 32 deep ahead of its products
// (the chain waits on no load but the first of each slice).
template <int kN>
__device__ __forceinline__ void column_chains(const float* x, const float* __restrict__ W,
                                              int stride, int cin, float (&acc)[kN]) {
  int k0 = 0;
  for (; k0 + 32 <= cin; k0 += 32) {
    float w[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) w[q] = __ldg(W + (k0 + q) * stride);
#pragma unroll
    for (int q = 0; q < 32; ++q)
#pragma unroll
      for (int c = 0; c < kN; ++c) acc[c] = fmaf(x[c * kMaxC + k0 + q], w[q], acc[c]);
  }
  for (; k0 < cin; ++k0) {
    const float wv = __ldg(W + k0 * stride);
#pragma unroll
    for (int c = 0; c < kN; ++c) acc[c] = fmaf(x[c * kMaxC + k0], wv, acc[c]);
  }
}

// The slack of a pooled conv's pre-ReLU value of row m and channel c, a
// bound on |u~ - u| for u~ from the tensor cores and u from an fmaf chain
// in k order: rel times sum_k |h_mk W_kc| <= |h_m|_2 |W_c|_2 (the row and
// column norms, rounded up), scaled by BN's mul, plus the bias and BN
// terms for their own roundings; rel (tower_rel) is twice the sum of the
// error terms. The bound holds for values of either sign. As a |h_m|_2 +
// b: slack_coefs gives channel c's (a, b).
__device__ __forceinline__ float2 slack_coefs(const Chan& ch, bool bn, float rel, float wnorm) {
  const float mul = bn ? fabsf(ch.mul) : 1.f;
  return make_float2(rel * mul * wnorm,
                     rel * (mul * (fabsf(ch.b) + fabsf(ch.mu)) + fabsf(ch.beta)) + 1e-30f);
}

// rel for a product over K = cin terms, relative to S = sum_k |h_k W_kc|:
// the chain's K roundings (K 2^-24); the tensor cores' sums: an mma of kk
// products aligns its kk + 1 addends (the accumulator too) to the largest
// before it sums them, truncating each by up to 2^-23 of the largest
// (<= S), then truncates the sum the same way: K / kk mmas of kk + 2
// truncations; 1xTF32 (kk 8): also each operand rounded to TF32, within
// 2^-11 of its value (a product within 2^-10 + 2^-22); bf16 (kk 16): exact
// products. Twice the sum.
__device__ __forceinline__ float tower_rel(bool bf16, int cin) {
  const float chain = 5.97e-8f * cin;
  if (bf16) return 2.f * (chain + 1.1921e-7f * (cin / 16) * 18 + 1e-7f);
  return 2.f * (chain + 1.1921e-7f * (cin / 8) * 10 + 9.8e-4f);
}

// tower_rel's terms apart, for a conv whose input columns from some k on
// are the same in every row of a cluster (kShared below): the sums' (the
// chain's and the mma's roundings, relative to all of S) and the
// operands' (the TF32 roundings, relative to S over the other columns
// only: over the shared ones the rounded products, and so their error, are
// the same in every row, and cancel between rows).
__device__ __forceinline__ float tower_rel_sums(bool bf16, int cin) {
  const float chain = 5.97e-8f * cin;
  return bf16 ? 2.f * (chain + 1.1921e-7f * (cin / 16) * 18)
              : 2.f * (chain + 1.1921e-7f * (cin / 8) * 10);
}

__device__ __forceinline__ float tower_rel_operands(bool bf16) { return bf16 ? 2e-7f : 1.96e-3f; }

// hnorm[row] = the 2-norm of row `row` of in (row stride ld, cin wide) for
// the block's kRows rows, rounded up (f32 sums of K squares: within K 2^-24
// of the exact norm), kThreads / kRows threads a row; hnorm_l[row] that of
// the row's columns below k_shared (pooled_conv's kShared). The caller
// syncs. K3's: K6 keeps its own inline copy of the full norm, since a call
// here changes K6's register allocation.
__device__ __forceinline__ void row_norms(const float* in, int ld, int cin, int k_shared,
                                          float* hnorm, float* hnorm_l, int tid) {
  constexpr int kParts = kThreads / kRows;
  const int row = tid / kParts, part = tid % kParts;
  float ss[2] = {0.f, 0.f};
  for (int k = part; k < cin; k += kParts) {
    const float v = in[row * ld + k];
    ss[k >= k_shared] = fmaf(v, v, ss[k >= k_shared]);
  }
#pragma unroll
  for (int off = 1; off < kParts; off <<= 1)
#pragma unroll
    for (int j = 0; j < 2; ++j) ss[j] += __shfl_xor_sync(0xffffffffu, ss[j], off);
  if (part == 0) {
    hnorm[row] = sqrtf(ss[0] + ss[1]) * 1.0001f;
    hnorm_l[row] = sqrtf(ss[0]) * 1.0001f;
  }
}

// A pooled conv's pool of channel n in every cluster of the block, as the
// fmaf chain in k order gives it, over the candidate rows that rows[c]
// marks (bit m: slot m of cluster c; the block's row c * 64 + m of `in`),
// up to kR rows a pass: W's column n (stride cout) is read once a pass, by
// the warp's lanes on consecutive channels, coalesced, 32 deep at a time
// (cin % 32 == 0). kRelu: the pool of bn_relu's values, pooled[c] = 0
// where cluster c has no candidate (all below 0: ReLU); else the pool of
// bias + BN (bf16-rounded in the bf16 mode), -1e30 where it has none (a
// cluster always has one: its masked rows are never empty).
template <bool kBf16, bool kRelu = true>
__device__ __forceinline__ void pool_sum(const Layer& L, const float* __restrict__ wts,
                                         const float* in, int in_ld, int n,
                                         unsigned long long (&rows)[kC], float (&pooled)[kC]) {
  constexpr int kR = 8;
  const float* W = wts + L.w + n;
  const int cin = L.cin, cout = L.cout;
  const Chan ch = chan(L, wts, n);
  const bool bn = L.mu >= 0;
#pragma unroll
  for (int c = 0; c < kC; ++c) pooled[c] = kRelu ? 0.f : -1.0e30f;
  for (;;) {
    int r[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      r[j] = -1;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (r[j] < 0 && rows[c]) {
          r[j] = c * kSlots + __ffsll(rows[c]) - 1;
          rows[c] &= rows[c] - 1;
        }
    }
    if (r[0] < 0) break;
    const float* h[kR];
    float y[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      h[j] = in + (r[j] < 0 ? r[0] : r[j]) * in_ld;
      y[j] = 0.f;
    }
    for (int k0 = 0; k0 < cin; k0 += 32) {
      float w[32];   // a 32-deep slice of the column, loaded before its products
#pragma unroll
      for (int q = 0; q < 32; ++q) w[q] = __ldg(W + (k0 + q) * cout);
#pragma unroll
      for (int k = 0; k < 32; k += 4)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          // rows past this thread's candidates read nothing (fewer bank conflicts)
          const float4 a = r[j] >= 0 ? *reinterpret_cast<const float4*>(h[j] + k0 + k)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          y[j] = fmaf(a.x, w[k], y[j]);
          y[j] = fmaf(a.y, w[k + 1], y[j]);
          y[j] = fmaf(a.z, w[k + 2], y[j]);
          y[j] = fmaf(a.w, w[k + 3], y[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (r[j] >= 0 && r[j] / kSlots == c)
          pooled[c] = fmaxf(pooled[c], pool_value<kBf16, kRelu>(y[j], ch, bn));
  }
}

// One warp tile of a pooled conv's product on pooled_conv's 1xTF32 tiles,
// for K3's decomposition bodies: rows m0 .. m0 + 16 kMT - 1 of `in` (row
// stride in_ld; 64 rows, one cluster) by columns n0 .. n0 + 8 NT - 1 of
// L's W (its TF32 fragments at L.frag), into acc in m16n8's C layout.
// pooled_conv keeps its own copy of these lines: calling this from it
// changes K3's and K6's register allocation.
template <int NT>
__device__ __forceinline__ void tf32_tile_product(const Layer& L, const float* __restrict__ wts,
                                                  const float* in, int in_ld, int m0, int n0,
                                                  float (&acc)[kMT][NT][4]) {
  const int lane = threadIdx.x & 31;
  const int cin = L.cin, nb_n = L.cout / 8;
  // B: one 8-byte fragment per lane per mma (8 x 8 block), the blocks k
  // major; the next k step's loaded while this one's products run
  const uint2* F = reinterpret_cast<const uint2*>(wts + L.frag) + (n0 / 8) * 32 + lane;
  uint2 nxt[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) nxt[q] = __ldg(F + q * 32);
  const auto fb = [&](int k0, uint32_t (&b)[NT][2]) {
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      b[q][0] = nxt[q].x;
      b[q][1] = nxt[q].y;
    }
    if (k0 + 8 < cin)
#pragma unroll
      for (int q = 0; q < NT; ++q)
        nxt[q] = __ldg(F + (static_cast<size_t>(k0 / 8 + 1) * nb_n + q) * 32);
  };
  // + half a TF32 ulp: the tensor cores' truncation then rounds
  tc_tile_tf32<kMT, NT>(in, in_ld, m0, cin, [](uint32_t v) { return v + 0x1000u; }, fb, acc);
}

// The pooled per-slot conv L over the block's kC * 64 rows (in, row stride
// in_ld) on the tensor cores, and its masked max-pool as the fmaf chain in
// k order gives it, into pooled[cluster * kMaxC + n] (hnorm[row]: the input
// row's 2-norm, rounded up; kRelu as pool_sum). The product only picks the
// candidates: per tile and channel, with s the row's slack and L the
// tile's largest u~ - s over the masked rows (kRelu: at least 0), the
// masked rows with u~ + s >= L that do not repeat slot 0 of their cluster
// (dup: a repeat has the same value), marked in rowmask[(cluster * kMaxC +
// n) * 2 + slot / 32] (zeroed before). After the product a thread per
// channel sums its candidates as chains (pool_sum). phase (the time
// split's stages): 0 stops after the products and their bias and BN, 1
// after the marks (their count added to *count), 2 runs everything. Ends
// synced.
// kShared (no ReLU; K3's mid conv, fed [h | pool]): the input columns from
// cin / 2 on are the same in every row of a cluster, so the slack leaves
// out the rounding of their operands, an error that is the same in every
// row (tower_rel_operands): u~ = u + E + d with |d| <= s and E the same for
// every row of the tile, so the row of the largest u still has u~ + s >=
// L. hnorm_l[row] is the norm of the row's columns below cin / 2, and the
// layer's column norms are followed by those of its rows below cin / 2.
template <bool kBf16, bool kRelu = true, bool kShared = false>
__device__ __forceinline__ void pooled_conv(const Layer& L, const float* __restrict__ wts,
                                            const float* in, int in_ld, const float* mask,
                                            const int* dup, const float* hnorm, float* pooled,
                                            unsigned* rowmask, int* count, int phase,
                                            const float* hnorm_l = nullptr) {
  static_assert(!(kShared && kRelu), "a shared-column slack needs the pool without ReLU");
  const bool pool_on = phase > 0;
  constexpr int NT = 8 / kMT;
  constexpr int kTilesM = kRows / (16 * kMT);
  constexpr int kK = kBf16 ? 16 : 8;            // k per mma step
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cin = L.cin, cout = L.cout, nb_n = cout / 8;
  const bool bn = L.mu >= 0;
  const float rel = kShared ? tower_rel_sums(kBf16, cin) : tower_rel(kBf16, cin);
  const int tiles = kTilesM * (cout / (8 * NT));
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += kWarps) {
    const int m0 = tile % kTilesM * 16 * kMT, n0 = tile / kTilesM * 8 * NT;
    float acc[kMT][NT][4];
    // B: one 8-byte fragment per lane per mma (kK x 8 block), the blocks k
    // major; the next k step's loaded while this one's products run
    const uint2* F = reinterpret_cast<const uint2*>(wts + L.frag) + (n0 / 8) * 32 + lane;
    uint2 nxt[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) nxt[q] = __ldg(F + q * 32);
    const auto fb = [&](int k0, uint32_t (&b)[NT][2]) {
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        b[q][0] = nxt[q].x;
        b[q][1] = nxt[q].y;
      }
      if (k0 + kK < cin)
#pragma unroll
        for (int q = 0; q < NT; ++q)
          nxt[q] = __ldg(F + (static_cast<size_t>(k0 / kK + 1) * nb_n + q) * 32);
    };
    if constexpr (kBf16)
      tc_tile_bf16<false, kMT, NT>(
          m0, cin,
          [&](int m, int k) {   // bf16 values stored as f32: the pair converts exactly
            const float2 v = *reinterpret_cast<const float2*>(in + m * in_ld + k);
            const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
            return *reinterpret_cast<const uint32_t*>(&p);
          },
          fb, acc);
    else   // + half a TF32 ulp: the tensor cores' truncation then rounds
      tc_tile_tf32<kMT, NT>(in, in_ld, m0, cin, [](uint32_t v) { return v + 0x1000u; }, fb,
                            acc);
    // epilogue: column 2 q + e is channel n0 + 8 q + 2 t + e, its rows
    // m0 + 16 i + 8 r + g, all of one cluster
    float hn[kMT][2], hn_l[kMT][2];
    bool in_ball[kMT][2], fresh[kMT][2];   // masked; masked and no repeat
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + 16 * i + 8 * r + g;
        hn[i][r] = hnorm[m];
        if constexpr (kShared) hn_l[i][r] = hnorm_l[m];
        in_ball[i][r] = mask[m] > 0.5f;
        fresh[i][r] = in_ball[i][r] && !dup[m];
      }
    unsigned bits = 0;   // this lane's candidates: bit ((q * 2 + e) * kMT + i) * 2 + r
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * q + 2 * t + e;
        const Chan ch = chan(L, wts, n);
        const float2 sc = slack_coefs(ch, bn, rel, __ldg(wts + L.wnorm + n));
        float op_l = 0.f;   // kShared: the operands' term, over the columns below cin / 2
        if constexpr (kShared)
          op_l = tower_rel_operands(kBf16) * (bn ? fabsf(ch.mul) : 1.f) *
                 __ldg(wts + L.wnorm + cout + n);
        float lo = -INFINITY, hi[kMT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float u = bn_pre(acc[i][q][2 * r + e], ch, bn);
            float sl = fmaf(sc.x, hn[i][r], sc.y);
            if constexpr (kShared) sl = fmaf(op_l, hn_l[i][r], sl);
            hi[i][r] = u + sl;
            if (in_ball[i][r]) lo = fmaxf(lo, u - sl);
          }
        if (!pool_on) continue;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          lo = fmaxf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        if constexpr (kRelu) lo = fmaxf(lo, 0.f);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (fresh[i][r] && hi[i][r] >= lo) bits |= 1u << (((q * 2 + e) * kMT + i) * 2 + r);
          }
      }
    if (!pool_on) continue;
    for (; bits; bits &= bits - 1) {
      const int j = __ffs(bits) - 1;
      const int r = j & 1, i = (j >> 1) % kMT, qe = (j >> 1) / kMT;
      const int m = m0 + 16 * i + 8 * r + g, n = n0 + 8 * (qe >> 1) + 2 * t + (qe & 1);
      atomicOr(rowmask + (m / kSlots * kMaxC + n) * 2 + m % kSlots / 32, 1u << (m % 32));
    }
  }
  __syncthreads();
  if (phase == 1) {
    int marked = 0;
    for (int i = threadIdx.x; i < 2 * kC * kMaxC; i += kThreads) marked += __popc(rowmask[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) marked += __shfl_xor_sync(0xffffffffu, marked, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(count, marked);
    __syncthreads();
    return;
  }
  if (phase < 2) return;
  for (int n = threadIdx.x; n < cout; n += kThreads) {
    unsigned long long rows[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      rows[c] = rowmask[(c * kMaxC + n) * 2] |
                static_cast<unsigned long long>(rowmask[(c * kMaxC + n) * 2 + 1]) << 32;
    float best[kC];
    pool_sum<kBf16, kRelu>(L, wts, in, in_ld, n, rows, best);
#pragma unroll
    for (int c = 0; c < kC; ++c) pooled[c * kMaxC + n] = best[c];
  }
  __syncthreads();
}

}  // namespace tower
}  // namespace f3d
