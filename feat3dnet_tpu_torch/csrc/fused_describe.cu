// Whole eval forward for origin-centred clusters (K3).
//
// Replaces: feat3dnet_tpu/ops/fused_describe.py:_kernel_t (behind
// fused_describe_clusters_t). _kernel_2d and _kernel compute the same thing
// in other TPU layouts, so this one kernel stands for all three. Per
// cluster, with eval BN folded into the weights:
//   membership d2 = x*x + y*y + z*z < r^2 (no FMA); an empty cluster keeps
//   the first slot at the minimum d2 -> detector convs (ReLU) per slot ->
//   masked max pool -> detector post convs (ReLU) -> attention
//   logaddexp(x, 0) and the normalised (c, s) orientation -> rotate
//   x' = x c - y s, y' = x s + y c -> descriptor convs (ReLU) per slot ->
//   masked pool -> [pointwise | pooled] -> mid conv (no ReLU), masked with
//   -1e30 and pooled -> post conv -> L2 normalisation.
//
// What bounds it on this card: arithmetic. At the paper widths a cluster of
// 64 slots costs about 3.9 M multiply-adds (the 128->256 detector conv is
// two thirds of it) against 768 B of input and 132 B of output; the folded
// weights are about 106 k floats (425 KB), more than a block's shared
// memory, and are read by every cluster from L2.
//
// What the design does about it: one block of 256 threads per cluster. The
// activations of all 64 slots stay in shared memory (two ping-pong buffers
// of 64 x 128 floats at the paper widths); the widest layer of each tower
// is never stored, its outputs go straight into the masked max pool. A
// per-slot layer is a register-tiled product: each warp owns 8 slots, each
// lane Cout/32 channels, so a thread keeps up to 8 x 8 sums in registers and
// does 16 FMAs per value it loads. Activations come as float4 broadcasts
// from shared memory; weights (stored (Cin, Cout), 16-byte aligned) as
// coalesced vector reads that all 8 warps share through L1. Plain f32 FMA
// on the CUDA cores; tensor-core (wgmma) tiles over many clusters per block
// are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 64;          // slots per cluster, padded (ns <= 64)
constexpr int kVec = 256;           // widest pooled / single-row vector
constexpr int kMaxLayers = 16;

struct Layer { int cin, cout, w, b; };  // offsets into the flat weight buffer
struct Tower {
  int n_det, n_det2, n_desc;
  int buf_width;                         // widest stored per-slot activation
  Layer l[kMaxLayers];
};

enum PoolMode { kNoPool = 0, kPoolRelu = 1, kPoolMaskedNeg = 2 };

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

// One per-slot layer: out[r][c] = act(sum_k in[r][k] * W[k][c] + b[c]) for
// the 64 (padded) slots. Each warp owns 8 slots and each lane kCout / 32
// channels, in groups of kV consecutive channels 32 * kV apart, so a k step
// costs one float4 broadcast read of a slot's activations per 4 k and one
// coalesced vector read of W per group: 8 x kCout/32 FMAs per k on 8 +
// kCout/32 values. kCout is a template so the sums sit in registers.
// Optional store (row stride out_stride) and optional masked max pool into
// pooled[kCout] (red: 8 x kCout scratch). Ends with a block barrier.
template <int kCout>
__device__ __forceinline__ void slot_layer(
    const float* __restrict__ in, int cin, int in_stride,
    const float* __restrict__ W, const float* __restrict__ bias, bool relu,
    float* __restrict__ out, int out_stride, int pool, const float* mask,
    float* red, float* pooled) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kTM = kSlots / kWarps;          // slots per warp (8)
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

  float bc[kTN], pm[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    bc[j] = bias[(j / kV) * 32 * kV + lane * kV + j % kV];
    pm[j] = pool == kPoolMaskedNeg ? -1.0e30f : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float m = mask[r0 + i];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = (j / kV) * 32 * kV + lane * kV + j % kV;
      float v = acc[i][j] + bc[j];
      if (relu) v = fmaxf(v, 0.f);
      if (out) out[(r0 + i) * out_stride + c] = v;
      if (pool == kPoolRelu) pm[j] = fmaxf(pm[j], v * m);        // v >= 0: exact
      else if (pool == kPoolMaskedNeg && m > 0.5f) pm[j] = fmaxf(pm[j], v);
    }
  }
  if (pool != kNoPool) {
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      red[warp * kCout + (j / kV) * 32 * kV + lane * kV + j % kV] = pm[j];
    __syncthreads();
    for (int c = threadIdx.x; c < kCout; c += kThreads) {
      float p = red[c];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) p = fmaxf(p, red[q * kCout + c]);
      pooled[c] = p;
    }
  }
  __syncthreads();
}

__device__ void slot_layer_any(int cout, const float* in, int cin, int in_stride,
                               const float* W, const float* bias, bool relu,
                               float* out, int out_stride, int pool,
                               const float* mask, float* red, float* pooled) {
  switch (cout) {
    case 32: slot_layer<32>(in, cin, in_stride, W, bias, relu, out, out_stride, pool, mask, red, pooled); break;
    case 64: slot_layer<64>(in, cin, in_stride, W, bias, relu, out, out_stride, pool, mask, red, pooled); break;
    case 128: slot_layer<128>(in, cin, in_stride, W, bias, relu, out, out_stride, pool, mask, red, pooled); break;
    default: slot_layer<256>(in, cin, in_stride, W, bias, relu, out, out_stride, pool, mask, red, pooled); break;
  }
}

// One single-row layer (after a pool): out[c] = act(sum_k in[k] W[k][c] + b[c]).
__device__ void vec_layer(const float* in, const Layer& L, const float* wts,
                          bool relu, float* out) {
  for (int c = threadIdx.x; c < L.cout; c += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < L.cin; ++k) acc = fmaf(in[k], __ldg(wts + L.w + k * L.cout + c), acc);
    float v = acc + wts[L.b + c];
    out[c] = relu ? fmaxf(v, 0.f) : v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
fused_describe_kernel(const float* __restrict__ packed, int ns, int batch,
                      const float* __restrict__ wts, Tower tw, float r2,
                      float inv_r, float* __restrict__ desc,
                      float* __restrict__ att) {
  extern __shared__ float4 smem4[];
  float* xin = reinterpret_cast<float*>(smem4);  // kSlots x 4: x, y, z, 0
  float* mask = xin + kSlots * 4;                // kSlots
  float* d2s = mask + kSlots;                    // kSlots
  float* red = d2s + kSlots;                     // (kThreads / 32) x kVec
  float* v0 = red + (kThreads / 32) * kVec;      // kVec
  float* v1 = v0 + kVec;                         // kVec
  float* head = v1 + kVec;                       // 4: att, c, s, -
  float* buf[2] = {head + 4, head + 4 + kSlots * tw.buf_width};

  const int b = blockIdx.x;
  const int t = threadIdx.x;

  // ---- coordinates and membership --------------------------------------
  if (t < kSlots) {
    float x = 0.f, y = 0.f, z = 0.f, d2 = INFINITY;
    if (t < ns) {
      x = packed[static_cast<size_t>(8 * t + 0) * batch + b];
      y = packed[static_cast<size_t>(8 * t + 1) * batch + b];
      z = packed[static_cast<size_t>(8 * t + 2) * batch + b];
      d2 = f3d::sqdist3(x, y, z);
    }
    xin[4 * t + 0] = __fmul_rn(x, inv_r);
    xin[4 * t + 1] = __fmul_rn(y, inv_r);
    xin[4 * t + 2] = __fmul_rn(z, inv_r);
    xin[4 * t + 3] = 0.f;
    d2s[t] = d2;
  }
  __syncthreads();
  if (t < 32) {
    const float da = d2s[t], db = d2s[t + 32];
    const bool ia = da < r2, ib = db < r2;
    const int count = __popc(__ballot_sync(0xffffffffu, ia)) +
                      __popc(__ballot_sync(0xffffffffu, ib));
    float dmin = fminf(da, db);
    for (int off = 16; off > 0; off >>= 1)
      dmin = fminf(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
    // nearest fallback: the FIRST slot attaining the minimum distance
    const unsigned lo = __ballot_sync(0xffffffffu, da <= dmin);
    const unsigned hi = __ballot_sync(0xffffffffu, db <= dmin);
    const int first = lo ? __ffs(lo) - 1 : 32 + __ffs(hi) - 1;
    mask[t] = (ia || (count == 0 && first == t)) ? 1.f : 0.f;
    mask[t + 32] = (ib || (count == 0 && first == t + 32)) ? 1.f : 0.f;
  }
  __syncthreads();

  // ---- detector: per-slot convs, the last one pooled ---------------------
  int li = 0;
  const float* in = xin;
  int cin_stride = 4;
  int nb = 0;
  for (int i = 0; i < tw.n_det; ++i, ++li) {
    const Layer& L = tw.l[li];
    const bool last = i == tw.n_det - 1;
    float* out = last ? nullptr : buf[nb];
    slot_layer_any(L.cout, in, L.cin, cin_stride, wts + L.w, wts + L.b, true,
                   out, L.cout, last ? kPoolRelu : kNoPool, mask, red, v0);
    if (!last) { in = out; cin_stride = L.cout; nb ^= 1; }
  }
  float* g = v0;
  float* g2 = v1;
  for (int i = 0; i < tw.n_det2; ++i, ++li) {
    vec_layer(g, tw.l[li], wts, true, g2);
    float* tmp = g; g = g2; g2 = tmp;
  }
  vec_layer(g, tw.l[li++], wts, false, head);          // attention -> head[0]
  vec_layer(g, tw.l[li++], wts, false, head + 1);      // orientation -> head[1:3]
  if (t == 0) {
    const float a = head[0];
    head[0] = fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));  // logaddexp(a, 0)
    const float oc = head[1], os = head[2];
    const float inv = 1.f / sqrtf(fmaxf(__fadd_rn(__fmul_rn(oc, oc), __fmul_rn(os, os)), 1e-8f));
    head[1] = __fmul_rn(oc, inv);
    head[2] = __fmul_rn(os, inv);
  }
  __syncthreads();

  // ---- rotate into the canonical orientation ----------------------------
  if (t < kSlots) {
    const float c = head[1], s = head[2];
    const float x = xin[4 * t], y = xin[4 * t + 1];
    xin[4 * t] = __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s));
    xin[4 * t + 1] = __fadd_rn(__fmul_rn(x, s), __fmul_rn(y, c));
  }
  __syncthreads();

  // ---- descriptor: per-slot convs; the last stored into [h | pool] -------
  in = xin;
  cin_stride = 4;
  int c_last = 0;
  float* cat = nullptr;
  for (int i = 0; i < tw.n_desc; ++i, ++li) {
    const Layer& L = tw.l[li];
    const bool last = i == tw.n_desc - 1;
    float* out = buf[nb];
    const int stride = last ? 2 * L.cout : L.cout;
    slot_layer_any(L.cout, in, L.cin, cin_stride, wts + L.w, wts + L.b, true,
                   out, stride, last ? kPoolRelu : kNoPool, mask, red, v0);
    if (last) { cat = out; c_last = L.cout; }
    in = out; cin_stride = stride; nb ^= 1;
  }
  for (int e = t; e < kSlots * c_last; e += kThreads) {
    const int r = e / c_last, k = e - r * c_last;
    cat[r * 2 * c_last + c_last + k] = v0[k];
  }
  __syncthreads();

  // ---- mid conv (no ReLU), masked pool; post conv; L2 --------------------
  {
    const Layer& L = tw.l[li++];
    slot_layer_any(L.cout, cat, L.cin, 2 * c_last, wts + L.w, wts + L.b, false,
                   nullptr, 0, kPoolMaskedNeg, mask, red, v1);
  }
  const Layer& P = tw.l[li];
  vec_layer(v1, P, wts, false, v0);
  if (t < 32) {
    float sq = 0.f;
    for (int c = t; c < P.cout; c += 32) sq = fmaf(v0[c], v0[c], sq);
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float inv = 1.f / sqrtf(fmaxf(sq, 1e-8f));
    for (int c = t; c < P.cout; c += 32)
      desc[static_cast<size_t>(b) * P.cout + c] = v0[c] * inv;
    if (t == 0) att[b] = head[0];
  }
}

}  // namespace

// packed (ns*8, batch) f32; weights: flat f32 buffer; layers: host int32
// array of (cin, cout, w_offset, b_offset) per layer in the order detector
// convs, detector post convs, attention, orientation, descriptor convs,
// mid conv, post conv; desc (batch, D) f32; att (batch,) f32.
F3D_EXPORT int f3d_fused_describe(const float* packed, int ns, int batch,
                                  const float* weights, const int* layers,
                                  int n_det, int n_det2, int n_desc, float r2,
                                  float inv_r, float* desc, float* att,
                                  cudaStream_t stream) {
  Tower tw;
  const int n_layers = n_det + n_det2 + 2 + n_desc + 2;
  if (ns < 1 || ns > kSlots || n_layers > kMaxLayers || n_det < 1 || n_desc < 1)
    return cudaErrorInvalidValue;
  tw.n_det = n_det;
  tw.n_det2 = n_det2;
  tw.n_desc = n_desc;
  tw.buf_width = 0;
  for (int i = 0; i < n_layers; ++i) {
    tw.l[i] = Layer{layers[4 * i], layers[4 * i + 1], layers[4 * i + 2], layers[4 * i + 3]};
  }
  for (int i = 0; i < n_det - 1; ++i)
    tw.buf_width = tw.buf_width > tw.l[i].cout ? tw.buf_width : tw.l[i].cout;
  const int d0 = n_det + n_det2 + 2;
  for (int i = 0; i < n_desc; ++i) {
    const int w = i == n_desc - 1 ? 2 * tw.l[d0 + i].cout : tw.l[d0 + i].cout;
    tw.buf_width = tw.buf_width > w ? tw.buf_width : w;
  }
  if (batch == 0) return cudaSuccess;
  const size_t smem = sizeof(float) *
      (kSlots * 4 + 2 * kSlots + (kThreads / 32) * kVec + 2 * kVec + 4 +
       2 * static_cast<size_t>(kSlots) * tw.buf_width);
  cudaError_t err = cudaFuncSetAttribute(
      fused_describe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_describe_kernel<<<batch, kThreads, smem, stream>>>(
      packed, ns, batch, weights, tw, r2, inv_r, desc, att);
  return cudaGetLastError();
}
