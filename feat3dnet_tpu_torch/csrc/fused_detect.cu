// Detector-only tower for origin-centred clusters (K6).
//
// Replaces: feat3dnet_tpu/ops/fused_describe.py:_detect_kernel_2d (behind
// fused_detect_clusters_2d) and _detect_kernel_planes (behind
// fused_detect_planes_t), in all three of their modes: the same tower, the
// second fed from the merge kernel's lane-dense planes. This kernel takes
// the (M, ns, 3) offsets that K4 + _finish_grouped give.
// Contract (ops/fused_describe.py:fused_detect_clusters_plain), per cluster:
//   membership d2 = x*x + y*y + z*z < r^2 (no FMA); an empty cluster keeps
//   the first slot at the minimum d2 -> the input scaled -> per slot Dense,
//   then eval BN replayed as ((Wx + b) - mean) * mul + bn_bias where the
//   layer table holds it, then ReLU, for each detector conv -> masked max
//   pool -> post convs the same way -> attention logaddexp(x, 0) and the
//   rsqrt(max(o.o, 1e-8))-normalised orientation (c, s).
// Modes:
//   unfolded       input v / r (IEEE division, as the model path divides),
//                  BN replayed in every conv;
//   folded         BN folded into the weights (no replay: -1 rows in the
//                  table), input v * (1/r);
//   bf16_operands  unfolded, with every product's operands in bf16: the
//                  wrapper rounds the kernel matrices, the kernel rounds
//                  the scaled input and each conv's output as it is
//                  produced (RNE commutes with the max pool, so that is the
//                  rounding of each product's activation operand); sums,
//                  bias and the BN replay stay f32.
// Output (M, 3): attention, c, s; the wrapper takes atan2(s, c).
//
// What bounds it on this card: arithmetic. At the paper widths a cluster
// of 64 slots costs about 2.6 M multiply-adds (3->64->128->256 per slot,
// the 128->256 conv is 80 % of it) against 768 B of input and 12 B of
// output; the extraction's attention pass runs it once per cloud point.
//
// What the design does about it: the layout of K3 (csrc/fused_describe.cu),
// whose per-slot layer it shares (slot_layer.cuh): one block of 256 threads
// per cluster, the 64 slots' activations in shared memory, the widest conv
// never stored but pooled as it is produced. A per-slot layer is a
// register-tiled product, each warp owning 8 slots and each lane Cout/32
// channels (up to 8 x 8 sums in registers, 16 FMAs per loaded value). The
// BN replay is rounded op by op (__fsub_rn, __fmul_rn, __fadd_rn), so the
// only departure from the model path is the order of the f32 sums.
#include "slot_layer.cuh"

namespace {

using f3d::BiasAct;
using f3d::kNoPool;
using f3d::kPoolRelu;

constexpr int kThreads = f3d::kTowerThreads;
constexpr int kSlots = f3d::kTowerSlots;
constexpr int kVec = 256;           // widest pooled / single-row vector
constexpr int kMaxLayers = 12;

struct Layer { int cin, cout, w, b, mu, mul, beta; };   // offsets; -1 = no BN
struct Tower {
  int n_det, n_det2;
  int buf_width;                       // widest stored per-slot activation
  Layer l[kMaxLayers];
};

// Dense + replayed BN (skipped where the table holds -1) + ReLU, then the
// bf16 rounding if kRound.
template <bool kRound>
struct BnReluAct {
  using Chan = int;
  const float* wts;
  Layer L;
  __device__ __forceinline__ Chan chan(int c) const { return c; }
  __device__ __forceinline__ float apply(float acc, int c) const {
    float v = acc + wts[L.b + c];
    if (L.mu >= 0)
      v = __fadd_rn(__fmul_rn(__fsub_rn(v, wts[L.mu + c]), wts[L.mul + c]), wts[L.beta + c]);
    v = fmaxf(v, 0.f);
    return kRound ? f3d::round_bf16(v) : v;
  }
};

template <bool kRound>
__global__ void __launch_bounds__(kThreads, 2)
fused_detect_kernel(const float* __restrict__ clusters, int ns,
                    const float* __restrict__ wts, Tower tw, int folded, float r,
                    float inv_r, float r2, float* __restrict__ out) {
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
  // the model path divides by r; the folded mode multiplies by 1/r
  const auto scale = [&](float v) {
    const float s = folded ? __fmul_rn(v, inv_r) : __fdiv_rn(v, r);
    return kRound ? f3d::round_bf16(s) : s;
  };

  // ---- coordinates and membership --------------------------------------
  if (t < kSlots) {
    float x = 0.f, y = 0.f, z = 0.f, d2 = INFINITY;
    if (t < ns) {
      const float* p = clusters + (static_cast<size_t>(b) * ns + t) * 3;
      x = p[0]; y = p[1]; z = p[2];
      d2 = f3d::sqdist3(x, y, z);
    }
    xin[4 * t + 0] = scale(x);
    xin[4 * t + 1] = scale(y);
    xin[4 * t + 2] = scale(z);
    xin[4 * t + 3] = 0.f;
    d2s[t] = d2;
  }
  __syncthreads();
  if (t < 32) f3d::tower_membership(d2s, r2, mask);
  __syncthreads();

  // ---- per-slot convs, the last one pooled ----------------------------------
  const float* in = xin;
  int in_stride = 4;
  int nb = 0;
  for (int i = 0; i < tw.n_det; ++i) {
    const Layer& L = tw.l[i];
    const bool last = i == tw.n_det - 1;
    float* o = last ? nullptr : buf[nb];
    f3d::slot_layer_any(L.cout, in, L.cin, in_stride, wts + L.w, BnReluAct<kRound>{wts, L}, o,
                        L.cout, last ? kPoolRelu : kNoPool, mask, red, v0);
    if (!last) { in = o; in_stride = L.cout; nb ^= 1; }
  }

  // ---- post convs and heads ---------------------------------------------------
  float* g = v0;
  float* g2 = v1;
  int li = tw.n_det;
  for (int i = 0; i < tw.n_det2; ++i, ++li) {
    const Layer& L = tw.l[li];
    f3d::vec_layer(g, L.cin, L.cout, wts + L.w, BnReluAct<kRound>{wts, L}, g2);
    float* tmp = g; g = g2; g2 = tmp;
  }
  for (int h = 0; h < 2; ++h, ++li) {                   // attention -> head[0], orientation -> head[1:3]
    const Layer& L = tw.l[li];
    f3d::vec_layer(g, L.cin, L.cout, wts + L.w, BiasAct<false>{wts + L.b, false}, head + h);
  }
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

template <bool kRound>
cudaError_t launch(const float* clusters, int ns, int batch, const float* weights,
                   const Tower& tw, int folded, float r, float inv_r, float r2, float* out,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_detect_kernel<kRound>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_detect_kernel<kRound><<<batch, kThreads, smem, stream>>>(
      clusters, ns, weights, tw, folded, r, inv_r, r2, out);
  return cudaGetLastError();
}

}  // namespace

// clusters (batch, ns, 3) f32 origin-centred; weights: flat f32 buffer
// (kernel matrices rounded to bf16 values under bf16); layers: host int32
// array of (cin, cout, w, b, mu, mul, beta) per layer in the order
// detector convs, post convs, attention, orientation (mu = -1: no BN);
// folded: input times inv_r instead of divided by r; bf16: activations
// rounded to bf16 as they are produced; out (batch, 3) f32: attention, c, s.
F3D_EXPORT int f3d_fused_detect(const float* clusters, int ns, int batch,
                                const float* weights, const int* layers, int n_det,
                                int n_det2, int folded, int bf16, float r, float inv_r,
                                float r2, float* out, cudaStream_t stream) {
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
  return bf16 ? launch<true>(clusters, ns, batch, weights, tw, folded, r, inv_r, r2, out, smem,
                             stream)
              : launch<false>(clusters, ns, batch, weights, tw, folded, r, inv_r, r2, out, smem,
                              stream);
}
