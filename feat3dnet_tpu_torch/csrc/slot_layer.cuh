// The per-slot layer of the cluster towers, shared by K3 (fused_describe.cu)
// and K6 (fused_detect.cu), with the bf16 rounding of their reduced-precision
// modes.
//
// Layout: a block of kTowerThreads threads runs one cluster's layer (the
// kernels call it once per cluster of the block); the kTowerSlots (padded)
// slots' activations in shared memory, row r = slot r. A per-slot layer is
// a register-tiled product: each warp owns 8 slots and each lane Cout/32
// channels, in groups of kV consecutive
// channels 32 * kV apart, so a k step costs one float4 broadcast read of a
// slot's activations per 4 k and one coalesced vector read of W per group:
// 8 x Cout/32 FMAs per k on 8 + Cout/32 values. Cout is a template so the
// sums sit in registers.
//
// An epilogue functor turns a channel's sum into the value stored and
// pooled: `chan(c)` loads what the channel needs once per layer, `apply(acc,
// chan)` adds the bias, replays BN, applies ReLU and rounds, as the kernel
// and its mode ask.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace f3d {

constexpr int kTowerThreads = 256;
constexpr int kTowerSlots = 64;     // slots per cluster, padded (ns <= 64)

// How a per-slot layer reduces its rows into pooled[Cout]: not at all; max
// of mask * v (v >= 0 after ReLU, mask 0/1: exact); max over the rows whose
// mask is set (-1e30 where none is); or the sum of mask * v.
enum PoolMode { kNoPool = 0, kPoolRelu = 1, kPoolMaskedNeg = 2, kPoolSum = 3 };

// Round to the nearest bf16, ties to even, and back to f32: what JAX's
// astype(bfloat16) and torch's .to(torch.bfloat16) do. A product of two
// such values has at most 16 significant bits, so the f32 FMAs that follow
// multiply exactly and only the order of their sums departs from the
// reference. RNE is monotone: rounding commutes with ReLU and with max.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V consecutive floats from global memory (V = 1, 2 or 4; aligned).
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* out) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = __ldg(p);
  }
}

__device__ __forceinline__ float lane_of(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

// Dense bias, then ReLU if asked, then the bf16 rounding if kRound.
template <bool kRound>
struct BiasAct {
  using Chan = float;
  const float* bias;
  bool relu;
  __device__ __forceinline__ Chan chan(int c) const { return bias[c]; }
  __device__ __forceinline__ float apply(float acc, Chan b) const {
    float v = acc + b;
    if (relu) v = fmaxf(v, 0.f);
    return kRound ? round_bf16(v) : v;
  }
};

// One per-slot layer: out[r][c] = epi(sum_k in[r][k] * W[k][c]) for the 64
// (padded) slots, W stored (Cin, Cout) and 16-byte aligned, Cin % 4 == 0.
// Optional store (row stride out_stride) and optional pool into
// pooled[kCout] (red: 8 x kCout scratch). Ends with a block barrier.
template <int kCout, class Epi>
__device__ __forceinline__ void slot_layer(
    const float* __restrict__ in, int cin, int in_stride, const float* __restrict__ W,
    const Epi& epi, float* __restrict__ out, int out_stride, int pool, const float* mask,
    float* red, float* pooled) {
  constexpr int kWarps = kTowerThreads / 32;
  constexpr int kTM = kTowerSlots / kWarps;     // slots per warp (8)
  constexpr int kTN = kCout / 32;               // channels per lane
  constexpr int kV = kTN < 4 ? kTN : 4;         // channels per vector read
  constexpr int kG = kTN / kV;                  // vector groups per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * kTM;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < cin; k += 4) {
    float4 a[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      a[i] = *reinterpret_cast<const float4*>(in + (r0 + i) * in_stride + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float w[kTN];
#pragma unroll
      for (int g = 0; g < kG; ++g)
        load_vec<kV>(W + (k + q) * kCout + g * 32 * kV + lane * kV, w + g * kV);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av = lane_of(a[i], q);
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
      }
    }
  }

  typename Epi::Chan ch[kTN];
  float pm[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    ch[j] = epi.chan((j / kV) * 32 * kV + lane * kV + j % kV);
    pm[j] = pool == kPoolMaskedNeg ? -1.0e30f : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float m = mask[r0 + i];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = (j / kV) * 32 * kV + lane * kV + j % kV;
      const float v = epi.apply(acc[i][j], ch[j]);
      if (out) out[(r0 + i) * out_stride + c] = v;
      if (pool == kPoolRelu) pm[j] = fmaxf(pm[j], v * m);
      else if (pool == kPoolMaskedNeg && m > 0.5f) pm[j] = fmaxf(pm[j], v);
      else if (pool == kPoolSum) pm[j] += v * m;                 // m in {0, 1}: exact
    }
  }
  if (pool != kNoPool) {
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      red[warp * kCout + (j / kV) * 32 * kV + lane * kV + j % kV] = pm[j];
    __syncthreads();
    for (int c = threadIdx.x; c < kCout; c += kTowerThreads) {
      float p = red[c];
#pragma unroll
      for (int q = 1; q < kWarps; ++q)
        p = pool == kPoolSum ? p + red[q * kCout + c] : fmaxf(p, red[q * kCout + c]);
      pooled[c] = p;
    }
  }
  __syncthreads();
}

template <class Epi>
__device__ void slot_layer_any(int cout, const float* in, int cin, int in_stride,
                               const float* W, const Epi& epi, float* out, int out_stride,
                               int pool, const float* mask, float* red, float* pooled) {
  switch (cout) {
    case 32: slot_layer<32>(in, cin, in_stride, W, epi, out, out_stride, pool, mask, red, pooled); break;
    case 64: slot_layer<64>(in, cin, in_stride, W, epi, out, out_stride, pool, mask, red, pooled); break;
    case 128: slot_layer<128>(in, cin, in_stride, W, epi, out, out_stride, pool, mask, red, pooled); break;
    default: slot_layer<256>(in, cin, in_stride, W, epi, out, out_stride, pool, mask, red, pooled); break;
  }
}

}  // namespace f3d
