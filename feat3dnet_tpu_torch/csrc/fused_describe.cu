// Whole eval forward for origin-centred clusters (K3).
//
// Replaces: feat3dnet_tpu/ops/fused_describe.py:_kernel_t (behind
// fused_describe_clusters_t), in f32 and in its bf16_act mode; _kernel_2d
// and _kernel, which compute the same forward in other TPU layouts (their
// bf16_matmul mode rounds what bf16_act stores); and the time-decomposition
// bodies _ablate_kernel_t and _ablate_kernel_2d. Per cluster, with eval BN
// folded into the weights:
//   membership d2 = x*x + y*y + z*z < r^2 (no FMA); an empty cluster keeps
//   the first slot at the minimum d2 -> detector convs (ReLU) per slot ->
//   masked max pool -> detector post convs (ReLU) -> attention
//   logaddexp(x, 0) and the normalised (c, s) orientation -> rotate
//   x' = x c - y s, y' = x s + y c -> descriptor convs (ReLU) per slot ->
//   masked pool -> [pointwise | pooled] -> mid conv (no ReLU), masked with
//   -1e30 and pooled -> post conv -> L2 normalisation.
// Modes (a template parameter; the same grid, block, shared memory and
// weight reads in all five):
//   kF32       the forward in f32.
//   kBf16      bf16_act: every kernel matrix arrives rounded to bf16 (the
//              wrapper rounds it); the scaled input, every ReLU output, the
//              rotated coordinates and the mid conv's output are rounded to
//              bf16 where they are produced, so every product takes bf16
//              operands and sums in f32. Membership, heads, softplus,
//              orientation, the final product and the L2 norm stay f32.
//              Activations are stored in shared memory as f32 holding bf16
//              values (the layout of kF32).
//   kStream    reads the coordinates, writes desc[b, :] = x of slot 0 and
//              att[b] = y of slot 0: the launch and input floor. Both
//              _ablate_kernel_t and _ablate_kernel_2d compute this.
//   kMatmul    _ablate_kernel_t's body: every product of the forward at its
//              shapes without the elementwise stream: raw coordinates into
//              both towers, no membership, ReLU, mask or rotation, pools as
//              sums over the ns slots, desc = kp (sum_s (km [d_s ; sum_s
//              d_s] + bm)) + bp unnormalised, att = (ka g + ba) + (ko g +
//              bo)[0] * 1e-30.
//   kMatmul2d  _ablate_kernel_2d's body: the same products, but each pool
//              is slot 0's row (g = h_0, m = km [d_0 ; d_0] + bm) and the
//              mid conv's input is [d_s ; d_s].
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
// is never stored, its outputs go straight into the pool. The per-slot
// layer (slot_layer.cuh, shared with K6) is register-tiled: each warp owns
// 8 slots, each lane Cout/32 channels, so a thread keeps up to 8 x 8 sums
// in registers and does 16 FMAs per value it loads. Activations come as
// float4 broadcasts from shared memory; weights (stored (Cin, Cout),
// 16-byte aligned) as coalesced vector reads that all 8 warps share through
// L1. Plain f32 FMA on the CUDA cores in every mode, bf16 included;
// tensor-core (mma / wgmma) tiles over many clusters per block are later
// work.
#include "slot_layer.cuh"

namespace {

using f3d::BiasAct;
using f3d::kNoPool;
using f3d::kPoolMaskedNeg;
using f3d::kPoolRelu;
using f3d::kPoolSum;

constexpr int kThreads = f3d::kTowerThreads;
constexpr int kSlots = f3d::kTowerSlots;
constexpr int kVec = 256;           // widest pooled / single-row vector
constexpr int kMaxLayers = 16;

enum Mode { kF32 = 0, kBf16 = 1, kStream = 2, kMatmul = 3, kMatmul2d = 4 };

struct Layer { int cin, cout, w, b; };  // offsets into the flat weight buffer
struct Tower {
  int n_det, n_det2, n_desc;
  int buf_width;                         // widest stored per-slot activation
  Layer l[kMaxLayers];
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
fused_describe_kernel(const float* __restrict__ packed, int ns, int batch,
                      const float* __restrict__ wts, Tower tw, float r2,
                      float inv_r, float* __restrict__ desc,
                      float* __restrict__ att) {
  constexpr bool kFull = kMode == kF32 || kMode == kBf16;  // the forward itself
  constexpr bool kRound = kMode == kBf16;
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
  const auto act = [](float v) { return kRound ? f3d::round_bf16(v) : v; };
  const Layer& P = tw.l[tw.n_det + tw.n_det2 + 2 + tw.n_desc + 1];   // post conv

  // ---- coordinates and membership --------------------------------------
  if (t < kSlots) {
    float x = 0.f, y = 0.f, z = 0.f, d2 = INFINITY;
    if (t < ns) {
      x = packed[static_cast<size_t>(8 * t + 0) * batch + b];
      y = packed[static_cast<size_t>(8 * t + 1) * batch + b];
      z = packed[static_cast<size_t>(8 * t + 2) * batch + b];
      if constexpr (kFull) d2 = f3d::sqdist3(x, y, z);
    }
    if constexpr (kFull) {
      x = act(__fmul_rn(x, inv_r));
      y = act(__fmul_rn(y, inv_r));
      z = act(__fmul_rn(z, inv_r));
    }
    xin[4 * t + 0] = x;
    xin[4 * t + 1] = y;
    xin[4 * t + 2] = z;
    xin[4 * t + 3] = 0.f;
    d2s[t] = d2;
    if constexpr (kMode == kMatmul) mask[t] = t < ns ? 1.f : 0.f;   // sum every slot
    if constexpr (kMode == kMatmul2d) mask[t] = t == 0 ? 1.f : 0.f;  // "sum" = slot 0
  }
  __syncthreads();
  if constexpr (kMode == kStream) {
    for (int c = t; c < P.cout; c += kThreads)
      desc[static_cast<size_t>(b) * P.cout + c] = xin[0];
    if (t == 0) att[b] = xin[1];
    return;
  }
  if constexpr (kFull) {
    if (t < 32) f3d::tower_membership(d2s, r2, mask);
    __syncthreads();
  }
  constexpr int kSlotPool = kFull ? kPoolRelu : kPoolSum;
  constexpr int kMidPool = kFull ? kPoolMaskedNeg : kPoolSum;

  // ---- detector: per-slot convs, the last one pooled ---------------------
  int li = 0;
  const float* in = xin;
  int cin_stride = 4;
  int nb = 0;
  for (int i = 0; i < tw.n_det; ++i, ++li) {
    const Layer& L = tw.l[li];
    const bool last = i == tw.n_det - 1;
    float* out = last ? nullptr : buf[nb];
    f3d::slot_layer_any(L.cout, in, L.cin, cin_stride, wts + L.w,
                        BiasAct<kRound>{wts + L.b, kFull}, out, L.cout,
                        last ? kSlotPool : kNoPool, mask, red, v0);
    if (!last) { in = out; cin_stride = L.cout; nb ^= 1; }
  }
  float* g = v0;
  float* g2 = v1;
  for (int i = 0; i < tw.n_det2; ++i, ++li) {
    const Layer& L = tw.l[li];
    f3d::vec_layer(g, L.cin, L.cout, wts + L.w, BiasAct<kRound>{wts + L.b, kFull}, g2);
    float* tmp = g; g = g2; g2 = tmp;
  }
  for (int h = 0; h < 2; ++h, ++li) {                   // attention -> head[0], orientation -> head[1:3]
    const Layer& L = tw.l[li];
    f3d::vec_layer(g, L.cin, L.cout, wts + L.w, BiasAct<false>{wts + L.b, false}, head + h);
  }
  if constexpr (kFull) {
    if (t == 0) {
      const float a = head[0];
      head[0] = fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));  // logaddexp(a, 0)
      const float oc = head[1], os = head[2];
      const float inv = 1.f / sqrtf(fmaxf(__fadd_rn(__fmul_rn(oc, oc), __fmul_rn(os, os)), 1e-8f));
      head[1] = __fmul_rn(oc, inv);
      head[2] = __fmul_rn(os, inv);
    }
    __syncthreads();

    // ---- rotate into the canonical orientation (from the unrounded x / r)
    if (t < kSlots) {
      const float c = head[1], s = head[2];
      float x = 0.f, y = 0.f;
      if (t < ns) {
        x = __fmul_rn(packed[static_cast<size_t>(8 * t + 0) * batch + b], inv_r);
        y = __fmul_rn(packed[static_cast<size_t>(8 * t + 1) * batch + b], inv_r);
      }
      xin[4 * t] = act(__fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s)));
      xin[4 * t + 1] = act(__fadd_rn(__fmul_rn(x, s), __fmul_rn(y, c)));
    }
    __syncthreads();
  }

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
    f3d::slot_layer_any(L.cout, in, L.cin, cin_stride, wts + L.w,
                        BiasAct<kRound>{wts + L.b, kFull}, out, stride,
                        last ? kSlotPool : kNoPool, mask, red, v0);
    if (last) { cat = out; c_last = L.cout; }
    in = out; cin_stride = stride; nb ^= 1;
  }
  for (int e = t; e < kSlots * c_last; e += kThreads) {
    const int r = e / c_last, k = e - r * c_last;
    cat[r * 2 * c_last + c_last + k] = kMode == kMatmul2d ? cat[r * 2 * c_last + k] : v0[k];
  }
  __syncthreads();

  // ---- mid conv (no ReLU), masked pool; post conv; L2 --------------------
  {
    const Layer& L = tw.l[li++];
    f3d::slot_layer_any(L.cout, cat, L.cin, 2 * c_last, wts + L.w,
                        BiasAct<kRound>{wts + L.b, false}, nullptr, 0, kMidPool, mask,
                        red, v1);
  }
  f3d::vec_layer(v1, P.cin, P.cout, wts + P.w, BiasAct<false>{wts + P.b, false}, v0);
  if (t < 32) {
    float inv = 1.f;
    if constexpr (kFull) {
      float sq = 0.f;
      for (int c = t; c < P.cout; c += 32) sq = fmaf(v0[c], v0[c], sq);
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      inv = 1.f / sqrtf(fmaxf(sq, 1e-8f));
    }
    for (int c = t; c < P.cout; c += 32)
      desc[static_cast<size_t>(b) * P.cout + c] = kFull ? v0[c] * inv : v0[c];
    if (t == 0) att[b] = kFull ? head[0] : __fadd_rn(head[0], __fmul_rn(head[1], 1e-30f));
  }
}

template <int kMode>
cudaError_t launch(const float* packed, int ns, int batch, const float* weights,
                   const Tower& tw, float r2, float inv_r, float* desc, float* att,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_describe_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_describe_kernel<kMode><<<batch, kThreads, smem, stream>>>(
      packed, ns, batch, weights, tw, r2, inv_r, desc, att);
  return cudaGetLastError();
}

}  // namespace

// packed (ns*8, batch) f32; weights: flat f32 buffer (kernel matrices
// rounded to bf16 values for mode 1); layers: host int32 array of (cin,
// cout, w_offset, b_offset) per layer in the order detector convs, detector
// post convs, attention, orientation, descriptor convs, mid conv, post
// conv; mode: 0 f32, 1 bf16 activations, 2 stream, 3 matmul, 4 matmul_2d;
// desc (batch, D) f32; att (batch,) f32.
F3D_EXPORT int f3d_fused_describe(const float* packed, int ns, int batch,
                                  const float* weights, const int* layers,
                                  int n_det, int n_det2, int n_desc, int mode,
                                  float r2, float inv_r, float* desc, float* att,
                                  cudaStream_t stream) {
  Tower tw;
  const int n_layers = n_det + n_det2 + 2 + n_desc + 2;
  if (ns < 1 || ns > kSlots || n_layers > kMaxLayers || n_det < 1 || n_desc < 1 ||
      mode < kF32 || mode > kMatmul2d)
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
  switch (mode) {
    case kF32: return launch<kF32>(packed, ns, batch, weights, tw, r2, inv_r, desc, att, smem, stream);
    case kBf16: return launch<kBf16>(packed, ns, batch, weights, tw, r2, inv_r, desc, att, smem, stream);
    case kStream: return launch<kStream>(packed, ns, batch, weights, tw, r2, inv_r, desc, att, smem, stream);
    case kMatmul: return launch<kMatmul>(packed, ns, batch, weights, tw, r2, inv_r, desc, att, smem, stream);
    default: return launch<kMatmul2d>(packed, ns, batch, weights, tw, r2, inv_r, desc, att, smem, stream);
  }
}
