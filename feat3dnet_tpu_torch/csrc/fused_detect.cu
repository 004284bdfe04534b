// Detector-only tower for origin-centred clusters, BN unfolded (K6).
//
// Replaces: feat3dnet_tpu/ops/fused_describe.py:_detect_kernel_2d (behind
// fused_detect_clusters_2d) and _detect_kernel_planes (behind
// fused_detect_planes_t), in their unfolded=True form: the same tower, the
// second fed from the merge kernel's lane-dense planes. This kernel takes
// the (M, ns, 3) offsets that K4 + _finish_grouped give.
// Contract (ops/fused_describe.py:fused_detect_clusters_plain), per cluster:
//   membership d2 = x*x + y*y + z*z < r^2 (no FMA); an empty cluster keeps
//   the first slot at the minimum d2 -> input v / r (IEEE division, as the
//   model path divides) -> per slot Dense, then eval BN replayed as
//   ((Wx + b) - mean) * mul + bn_bias, then ReLU, for each detector conv ->
//   masked max pool -> post convs the same way -> attention logaddexp(x, 0)
//   and the rsqrt(max(o.o, 1e-8))-normalised orientation (c, s).
// Output (M, 3): attention, c, s; the wrapper takes atan2(s, c).
//
// What bounds it on this card: arithmetic. At the paper widths a cluster
// of 64 slots costs about 2.6 M multiply-adds (3->64->128->256 per slot,
// the 128->256 conv is 80 % of it) against 768 B of input and 12 B of
// output; the extraction's attention pass runs it once per cloud point.
//
// What the design does about it: the layout of K3 (csrc/fused_describe.cu),
// which this kernel's detector half follows: one block of 256 threads per
// cluster, the 64 slots' activations in shared memory, the widest conv
// never stored but pooled as it is produced. A per-slot layer is a
// register-tiled product, each warp owning 8 slots and each lane Cout/32
// channels (up to 8 x 8 sums in registers, 16 FMAs per loaded value). The
// BN replay is rounded op by op (__fsub_rn, __fmul_rn, __fadd_rn), so the
// only departure from the model path is the order of the f32 sums.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 64;          // slots per cluster, padded (ns <= 64)
constexpr int kVec = 256;           // widest pooled / single-row vector
constexpr int kMaxLayers = 12;

struct Layer { int cin, cout, w, b, mu, mul, beta; };   // offsets; -1 = no BN
struct Tower {
  int n_det, n_det2;
  int buf_width;                       // widest stored per-slot activation
  Layer l[kMaxLayers];
};

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

// Dense + replayed BN + ReLU on one channel's pre-activation sum.
__device__ __forceinline__ float dense_bn_relu(float acc, const float* wts, const Layer& L,
                                               int c) {
  float v = acc + wts[L.b + c];
  if (L.mu >= 0)
    v = __fadd_rn(__fmul_rn(__fsub_rn(v, wts[L.mu + c]), wts[L.mul + c]), wts[L.beta + c]);
  return fmaxf(v, 0.f);
}

// One per-slot layer over the 64 (padded) slots: out[r][c] =
// relu(bn(sum_k in[r][k] W[k][c] + b[c])). Each warp owns 8 slots and each
// lane kCout / 32 channels in groups of kV consecutive channels 32 * kV
// apart. Either stores (row stride out_stride) or max-pools the masked
// rows into pooled[kCout] (red: 8 x kCout scratch). Ends with a barrier.
template <int kCout>
__device__ __forceinline__ void slot_layer(
    const float* __restrict__ in, int cin, int in_stride, const float* __restrict__ wts,
    const Layer& L, float* __restrict__ out, bool pool, const float* mask, float* red,
    float* pooled) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kTM = kSlots / kWarps;          // slots per warp (8)
  constexpr int kTN = kCout / 32;               // channels per lane
  constexpr int kV = kTN < 4 ? kTN : 4;         // channels per vector read
  constexpr int kG = kTN / kV;                  // vector groups per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * kTM;
  const float* W = wts + L.w;

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

  float pm[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) pm[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float m = mask[r0 + i];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = (j / kV) * 32 * kV + lane * kV + j % kV;
      const float v = dense_bn_relu(acc[i][j], wts, L, c);
      if (pool) pm[j] = fmaxf(pm[j], v * m);     // v >= 0 and m in {0, 1}: exact
      else out[(r0 + i) * L.cout + c] = v;
    }
  }
  if (pool) {
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

__device__ void slot_layer_any(const float* in, int in_stride, const float* wts,
                               const Layer& L, float* out, bool pool, const float* mask,
                               float* red, float* pooled) {
  switch (L.cout) {
    case 32: slot_layer<32>(in, L.cin, in_stride, wts, L, out, pool, mask, red, pooled); break;
    case 64: slot_layer<64>(in, L.cin, in_stride, wts, L, out, pool, mask, red, pooled); break;
    case 128: slot_layer<128>(in, L.cin, in_stride, wts, L, out, pool, mask, red, pooled); break;
    default: slot_layer<256>(in, L.cin, in_stride, wts, L, out, pool, mask, red, pooled); break;
  }
}

// One single-row layer after the pool: out[c] = act(bn(sum_k in[k] W[k][c] + b[c])).
__device__ void vec_layer(const float* in, const Layer& L, const float* wts, bool relu,
                          float* out) {
  for (int c = threadIdx.x; c < L.cout; c += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < L.cin; ++k) acc = fmaf(in[k], __ldg(wts + L.w + k * L.cout + c), acc);
    out[c] = relu ? dense_bn_relu(acc, wts, L, c) : acc + wts[L.b + c];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
fused_detect_kernel(const float* __restrict__ clusters, int ns,
                    const float* __restrict__ wts, Tower tw, float r, float r2,
                    float* __restrict__ out) {
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
      const float* p = clusters + (static_cast<size_t>(b) * ns + t) * 3;
      x = p[0]; y = p[1]; z = p[2];
      d2 = f3d::sqdist3(x, y, z);
    }
    xin[4 * t + 0] = __fdiv_rn(x, r);
    xin[4 * t + 1] = __fdiv_rn(y, r);
    xin[4 * t + 2] = __fdiv_rn(z, r);
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

  // ---- per-slot convs, the last one pooled ----------------------------------
  const float* in = xin;
  int in_stride = 4;
  int nb = 0;
  for (int i = 0; i < tw.n_det; ++i) {
    const Layer& L = tw.l[i];
    const bool last = i == tw.n_det - 1;
    slot_layer_any(in, in_stride, wts, L, last ? nullptr : buf[nb], last, mask, red, v0);
    if (!last) { in = buf[nb]; in_stride = L.cout; nb ^= 1; }
  }

  // ---- post convs and heads ---------------------------------------------------
  float* g = v0;
  float* g2 = v1;
  int li = tw.n_det;
  for (int i = 0; i < tw.n_det2; ++i, ++li) {
    vec_layer(g, tw.l[li], wts, true, g2);
    float* tmp = g; g = g2; g2 = tmp;
  }
  vec_layer(g, tw.l[li++], wts, false, head);          // attention -> head[0]
  vec_layer(g, tw.l[li], wts, false, head + 1);        // orientation -> head[1:3]
  if (t == 0) {
    const float a = head[0];
    const float oc = head[1], os = head[2];
    const float inv = 1.f / sqrtf(fmaxf(__fadd_rn(__fmul_rn(oc, oc), __fmul_rn(os, os)), 1e-8f));
    float* o = out + static_cast<size_t>(b) * 3;
    o[0] = fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));   // logaddexp(a, 0)
    o[1] = __fmul_rn(oc, inv);
    o[2] = __fmul_rn(os, inv);
  }
}

}  // namespace

// clusters (batch, ns, 3) f32 origin-centred; weights: flat f32 buffer;
// layers: host int32 array of (cin, cout, w, b, mu, mul, beta) per layer in
// the order detector convs, post convs, attention, orientation (mu = -1:
// no BN); out (batch, 3) f32: attention, c, s.
F3D_EXPORT int f3d_fused_detect(const float* clusters, int ns, int batch,
                                const float* weights, const int* layers, int n_det,
                                int n_det2, float r, float r2, float* out,
                                cudaStream_t stream) {
  Tower tw;
  const int n_layers = n_det + n_det2 + 2;
  if (ns < 1 || ns > kSlots || n_layers > kMaxLayers || n_det < 1)
    return cudaErrorInvalidValue;
  tw.n_det = n_det;
  tw.n_det2 = n_det2;
  tw.buf_width = 4;
  for (int i = 0; i < n_layers; ++i) {
    const int* q = layers + 7 * i;
    tw.l[i] = Layer{q[0], q[1], q[2], q[3], q[4], q[5], q[6]};
  }
  for (int i = 0; i < n_det - 1; ++i)
    tw.buf_width = tw.buf_width > tw.l[i].cout ? tw.buf_width : tw.l[i].cout;
  if (batch == 0) return cudaSuccess;
  const size_t smem = sizeof(float) *
      (kSlots * 4 + 2 * kSlots + (kThreads / 32) * kVec + 2 * kVec + 4 +
       2 * static_cast<size_t>(kSlots) * tw.buf_width);
  cudaError_t err = cudaFuncSetAttribute(
      fused_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_detect_kernel<<<batch, kThreads, smem, stream>>>(clusters, ns, weights, tw, r, r2,
                                                         out);
  return cudaGetLastError();
}
