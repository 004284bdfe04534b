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
// of 64 slots costs 2 674 880 multiply-adds (3->64->128->256 per slot, then
// 256->128->64 and the heads once), 78 % of them in the top per-slot conv
// (128->256), against 768 B of input and 12 B of output; the extraction's
// attention pass runs it once per cloud point.
//
// What the design does about it. The previous design (one cluster per
// block, every product an FFMA register tile, a one-thread-per-channel
// chain for the post convs) reached 31 % of the FFMA peak. Its sums ran in
// k order, one fmaf chain per output, as the plain version's cuBLAS f32
// GEMMs do on this card, and the two agreed to 2.4e-7 rad. That order is
// what the 1e-5 rad check needs: on the trained weights some clusters have
// an orientation vector of norm ~0.02-0.05, and summing any conv in another
// order (3xTF32, or exactly) moves their angle by 1e-5-1e-4 rad
// (tests/test_torch_k6_tc.py). So the outputs keep the previous design's
// sums, bit for bit, and the tensor cores only decide which sums to do:
// - The top per-slot conv runs on the tensor cores (tower_pool.cuh's
//   pooled_conv, shared with K3, on tc_mma.cuh, shared with K7-K10): f32
//   modes mma.sync m16n8k8 on operands rounded to TF32
//   (1xTF32, A through ldmatrix: 3xTF32's fewer candidates did not pay for
//   its three products), bf16_operands m16n8k16 on its bf16 operands. Its
//   output is never stored. Per tile and channel, the rows whose value can
//   be the pool's maximum (within a slack that bounds the two sums'
//   difference, from the row and column norms) are marked, and after the
//   product a thread per channel sums its marked rows as k-order fmaf
//   chains, W's column read coalesced across the warp; the pool is the
//   largest (on the vendored clouds 1.0-1.6 rows per cluster and channel). Rows repeating slot 0 (a ball query's
//   padding) are never marked: their sums are slot 0's.
// - Conv 0 (3 wide) and the per-slot convs below the top one stay on the
//   CUDA cores in k order: conv 0 an fmaf chain per output, the others
//   f3d::slot_layer (the register-tiled FFMA layer K3 shares).
// - kC = 2 clusters per block of 8 warps (128 slot rows; one cluster a
//   block was slower). A warp tile of the top conv is 64 rows of one
//   cluster by 16 channels; the tiles go out row tile first, so warps that
//   load a W fragment at about the same time load the same one (L1 serves
//   the rest).
// - W's fragments are laid out by the wrapper once per weight list,
//   rounded to TF32 (or as bf16 pairs): one 8-byte load per lane per mma's
//   B operand, the next k step's loaded while this one's products run.
// - The post convs and heads run in a second kernel
//   (fused_detect_kernel_post, kPost = 16 clusters a block), fed the pooled
//   vectors through a stream-ordered scratch buffer: in a block of kC = 2
//   clusters they are chains 256 deep on half the threads with only kC-way
//   independence (~2.2 of 24 ms on a stream unit); there a thread keeps
//   kPostN = 8 clusters' chains of one channel, W's column read once for
//   the 8, the pooled rows read as float4 broadcasts (0.7 ms). Each output
//   is still one k-order fmaf chain from 0.
// - Conv inputs keep a row stride of cin + 4 floats, so a fragment's eight
//   rows fall in eight bank groups.
#include <cuda_bf16.h>

#include <cstdint>
#include <mutex>

#include "common.cuh"
#include "slot_layer.cuh"
#include "tc_mma.cuh"
#include "tower_pool.cuh"

namespace {

using namespace f3d::tower;   // kC clusters a block, Layer, the pooled conv

constexpr int kMaxLayers = 12;

struct Tower {
  int n_det, n_det2, ns, batch, folded;
  float* pooled_out;   // (batch, the top conv's cout): fused_detect_kernel_post's input
  float r, inv_r, r2;
  int x_off, mask_off, d2_off, vec_off;   // shared memory, in floats
  int buf_off[2], buf_ld[2];              // per-slot activations
  Layer l[kMaxLayers];
};

// The per-slot convs' epilogue for f3d::slot_layer (the FFMA layer K3
// shares): bias, BN where the layer has one, ReLU, the bf16 rounding.
template <bool kBf16>
struct SlotEpi {
  using Chan = int;
  const float* wts;
  Layer L;
  __device__ __forceinline__ Chan chan(int c) const { return c; }
  __device__ __forceinline__ float apply(float acc, int c) const {
    float v = acc + wts[L.b + c];
    if (L.mu >= 0)
      v = __fadd_rn(__fmul_rn(__fsub_rn(v, wts[L.mu + c]), wts[L.mul + c]), wts[L.beta + c]);
    v = fmaxf(v, 0.f);
    return kBf16 ? f3d::round_bf16(v) : v;
  }
};

// kC clusters per block; `stop` (the time split) leaves after a stage:
// 1 input and membership, 2 + l per-slot conv l (the top one without its
// pool), n_det + 2 the pool's candidates listed, n_det + 3 the pool; 0 runs
// everything.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
fused_detect_kernel(const float* __restrict__ clusters, const float* __restrict__ wts,
                    const __grid_constant__ Tower T, float* __restrict__ out, int stop) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xin = sm + T.x_off;          // kRows x 4: x, y, z, 0 (scaled)
  float* mask = sm + T.mask_off;      // kRows
  float* d2s = sm + T.d2_off;         // kRows (then the repeat flags)
  float* buf[2] = {sm + T.buf_off[0], sm + T.buf_off[1]};
  // in the buffer the top conv would write: pooled (kC x kMaxC), the top
  // conv input's row norms (kRows), the pool's candidate marks (kC x kMaxC x
  // 2 words) and their count
  float* pooled = sm + T.vec_off;
  float* hnorm = pooled + kC * kMaxC;
  unsigned* rowmask = reinterpret_cast<unsigned*>(hnorm + kRows);
  int* count = reinterpret_cast<int*>(rowmask + 2 * kC * kMaxC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kC;
  // the model path divides by r; the folded mode multiplies by 1/r
  const auto scale = [&](float v) {
    const float s = T.folded ? __fmul_rn(v, T.inv_r) : __fdiv_rn(v, T.r);
    return kBf16 ? f3d::round_bf16(s) : s;
  };

  // ---- coordinates and membership ------------------------------------------
  for (int row = tid; row < kRows; row += kThreads) {
    const int s = row % kSlots, b = b0 + row / kSlots;
    float x = 0.f, y = 0.f, z = 0.f, d2 = INFINITY;
    if (b < T.batch && s < T.ns) {
      const float* p = clusters + (static_cast<size_t>(b) * T.ns + s) * 3;
      x = p[0]; y = p[1]; z = p[2];
      d2 = f3d::sqdist3(x, y, z);
    }
    xin[4 * row + 0] = scale(x);
    xin[4 * row + 1] = scale(y);
    xin[4 * row + 2] = scale(z);
    xin[4 * row + 3] = 0.f;
    d2s[row] = d2;
  }
  __syncthreads();
  for (int c = warp; c < kC; c += kWarps)
    membership(d2s + c * kSlots, T.r2, mask + c * kSlots, lane);
  __syncthreads();
  // then the distances' room holds, per slot, whether it repeats its
  // cluster's slot 0 (a ball query's padding): its rows equal slot 0's
  int* dup = reinterpret_cast<int*>(d2s);
  for (int row = tid; row < kRows; row += kThreads) {
    const float4 p = *reinterpret_cast<const float4*>(xin + 4 * row);
    const float4 o = *reinterpret_cast<const float4*>(xin + 4 * (row - row % kSlots));
    dup[row] = row % kSlots > 0 && o.x == p.x && o.y == p.y && o.z == p.z;
  }
  if (stop == 1) return;

  // ---- conv 0 on the CUDA cores: 4 input rows (x, y, z, 0), fmaf in k order
  {
    const Layer& L = T.l[0];
    const int cout = L.cout, c = tid % cout, step = kThreads / cout;
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __ldg(wts + L.w + k * cout + c);
    const Chan ch = chan(L, wts, c);
    const bool bn = L.mu >= 0;
    const int ld = T.buf_ld[0];
    for (int row = tid / cout; row < kRows; row += step) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = fmaf(xin[4 * row + k], w[k], acc);
      buf[0][row * ld + c] = bn_relu<kBf16>(acc, ch, bn);
    }
  }
  __syncthreads();
  if (stop == 2) return;

  // ---- per-slot convs 1 .. n_det - 2 on the CUDA cores (k order), then the
  // top one on the tensor cores, pooled
  for (int l = 1; l < T.n_det; ++l) {
    const Layer& L = T.l[l];
    const int src = (l - 1) & 1;
    if (l < T.n_det - 1) {
      for (int c = 0; c < kC; ++c)
        f3d::slot_layer_any(L.cout, buf[src] + c * kSlots * T.buf_ld[src], L.cin,
                            T.buf_ld[src], wts + L.w, SlotEpi<kBf16>{wts, L},
                            buf[l & 1] + c * kSlots * T.buf_ld[l & 1], T.buf_ld[l & 1],
                            f3d::kNoPool, mask + c * kSlots, nullptr, nullptr);
      if (stop == 2 + l) return;
      continue;
    }
    // the input's row norms, rounded up (f32 sums of K squares: within
    // K 2^-24 of the exact norm), kThreads / kRows threads a row
    for (int i = tid; i < 2 * kC * kMaxC; i += kThreads) rowmask[i] = 0u;
    if (tid == 0) *count = 0;
    {
      constexpr int kParts = kThreads / kRows;
      const int cin = L.cin, ld = T.buf_ld[src], row = tid / kParts, part = tid % kParts;
      float ss = 0.f;
      for (int k = part; k < cin; k += kParts) {
        const float v = buf[src][row * ld + k];
        ss = fmaf(v, v, ss);
      }
#pragma unroll
      for (int off = 1; off < kParts; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (part == 0) hnorm[row] = sqrtf(ss) * 1.0001f;
    }
    __syncthreads();
    pooled_conv<kBf16>(L, wts, buf[src], T.buf_ld[src], mask, dup, hnorm, pooled, rowmask,
                       count, stop == 2 + l ? 0 : stop == 3 + l ? 1 : 2);
    // the candidates stage leaves the block's count in out[block] (the
    // work the pool re-sums, read by the time split)
    if (stop == 3 + l && tid == 0) out[blockIdx.x] = static_cast<float>(*count);
    if (stop >= 2 + l && stop <= 4 + l) return;
  }

  // ---- the pooled vectors out, for fused_detect_kernel_post
  {
    const int cout = T.l[T.n_det - 1].cout;
    for (int i = tid; i < kC * cout; i += kThreads) {
      const int c = i / cout, n = i % cout;
      if (b0 + c < T.batch)
        T.pooled_out[static_cast<size_t>(b0 + c) * cout + n] = pooled[c * kMaxC + n];
    }
  }
}

// The post convs and heads over kPost clusters a block, from the pooled
// vectors fused_detect_kernel wrote: a thread per channel and group of
// kPostN clusters keeps their fmaf chains in k order (post_chains), then the
// attention and the normalised orientation.
constexpr int kPost = 16;
constexpr int kPostN = 8;

// acc[c] += sum_k x[c * kMaxC + k] W[k * stride] (c < kPostN) over k < cin,
// one fmaf chain in k order per c (column_chains' sums): W's column read
// 32 deep ahead of its products, x as float4 (the warp's lanes read the same
// rows: broadcasts).
__device__ __forceinline__ void post_chains(const float* x, const float* __restrict__ W,
                                            int stride, int cin, float (&acc)[kPostN]) {
  int k0 = 0;
  for (; k0 + 32 <= cin; k0 += 32) {
    float w[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) w[q] = __ldg(W + (k0 + q) * stride);
#pragma unroll
    for (int q = 0; q < 32; q += 4)
#pragma unroll
      for (int c = 0; c < kPostN; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(x + c * kMaxC + k0 + q);
        acc[c] = fmaf(a.x, w[q], acc[c]);
        acc[c] = fmaf(a.y, w[q + 1], acc[c]);
        acc[c] = fmaf(a.z, w[q + 2], acc[c]);
        acc[c] = fmaf(a.w, w[q + 3], acc[c]);
      }
  }
  for (; k0 < cin; ++k0) {
    const float wv = __ldg(W + k0 * stride);
#pragma unroll
    for (int c = 0; c < kPostN; ++c) acc[c] = fmaf(x[c * kMaxC + k0], wv, acc[c]);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
fused_detect_kernel_post(const float* __restrict__ wts, const __grid_constant__ Tower T,
                         float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][kPost * kMaxC];
  __shared__ float head[kPost * 4];
  const int tid = threadIdx.x, b0 = blockIdx.x * kPost;
  {
    const int cout = T.l[T.n_det - 1].cout;
    for (int i = tid; i < kPost * cout; i += kThreads) {
      const int c = i / cout, n = i % cout;
      buf[0][c * kMaxC + n] =
          b0 + c < T.batch ? T.pooled_out[static_cast<size_t>(b0 + c) * cout + n] : 0.f;
    }
  }
  __syncthreads();
  for (int i = 0; i < T.n_det2; ++i) {
    const Layer& L = T.l[T.n_det + i];
    const int cin = L.cin, cout = L.cout;
    const bool bn = L.mu >= 0;
    const float* g = buf[i & 1];
    float* o = buf[(i + 1) & 1];
    for (int j = tid; j < cout * (kPost / kPostN); j += kThreads) {
      const int n = j % cout, c0 = j / cout * kPostN;
      float acc[kPostN];
#pragma unroll
      for (int c = 0; c < kPostN; ++c) acc[c] = 0.f;
      post_chains(g + c0 * kMaxC, wts + L.w + n, cout, cin, acc);
      const Chan ch = chan(L, wts, n);
#pragma unroll
      for (int c = 0; c < kPostN; ++c) o[(c0 + c) * kMaxC + n] = bn_relu<kBf16>(acc[c], ch, bn);
    }
    __syncthreads();
  }

  // ---- heads: attention (cin -> 1), orientation (cin -> 2); a thread per
  // cluster and output, an fmaf chain in k order
  {
    const float* g = buf[T.n_det2 & 1];
    const int li = T.n_det + T.n_det2;
    const int cin = T.l[li].cin;
    for (int o = tid; o < 3 * kPost; o += kThreads) {
      const int c = o / 3, j = o % 3;
      const Layer& H = T.l[li + (j > 0)];
      const int col = j > 0 ? j - 1 : 0;
      float acc[1] = {0.f};
      column_chains<1>(g + c * kMaxC, wts + H.w + col, H.cout, cin, acc);
      head[c * 4 + j] = acc[0] + __ldg(wts + H.b + col);
    }
  }
  __syncthreads();
  if (tid < kPost && b0 + tid < T.batch) {
    const float a = head[tid * 4], oc = head[tid * 4 + 1], os = head[tid * 4 + 2];
    const float inv = 1.f / sqrtf(fmaxf(__fadd_rn(__fmul_rn(oc, oc), __fmul_rn(os, os)), 1e-8f));
    float* po = out + static_cast<size_t>(b0 + tid) * 3;
    po[0] = fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));   // logaddexp(a, 0)
    po[1] = __fmul_rn(oc, inv);
    po[2] = __fmul_rn(os, inv);
  }
}

// Host: the tower from the (n, 7) layer table and the (n, 2) offsets of
// each layer's W fragments and column norms, with its shared-memory layout;
// returns the bytes, or 0 for a tower the kernel does not take.
size_t make_tower(Tower* T, int ns, int batch, const int* layers, const int* extra, int n_det,
                  int n_det2) {
  const int n_layers = n_det + n_det2 + 2;
  if (ns < 1 || ns > kSlots || n_det < 2 || n_det2 < 0 || n_layers > kMaxLayers || batch < 0)
    return 0;
  *T = Tower{};
  T->n_det = n_det;
  T->n_det2 = n_det2;
  T->ns = ns;
  T->batch = batch;
  for (int i = 0; i < n_layers; ++i) {
    const int* q = layers + 7 * i;
    Layer& L = T->l[i];
    L = Layer{q[0], q[1], q[2], q[3], q[4], q[5], q[6], extra ? extra[2 * i] : -1,
              extra ? extra[2 * i + 1] : -1};
    if (L.cout < 1 || L.cout > kMaxC || L.cin < 1 || L.cin > kMaxC) return 0;
    if (i == 0 && (L.cin != 4 || kThreads % L.cout)) return 0;
    if (i > 0 && i < n_det && (L.cin % 4 || L.cout % 32)) return 0;
    if (i == n_det - 1 && (L.cin % 32 || (extra && (L.frag < 0 || L.wnorm < 0)))) return 0;
    if (i >= n_det + n_det2 && L.cout != (i == n_layers - 2 ? 1 : 2)) return 0;
  }
  // conv l writes buffer l & 1 (the top conv none); the vectors live in the
  // buffer the top conv would write
  const int rows = kRows;
  size_t bytes[2] = {0, 0};
  for (int l = 0; l + 1 < n_det; ++l) {
    const int ld = T->l[l].cout + 4;
    T->buf_ld[l & 1] = ld > T->buf_ld[l & 1] ? ld : T->buf_ld[l & 1];
  }
  for (int j = 0; j < 2; ++j) bytes[j] = sizeof(float) * rows * T->buf_ld[j];
  const size_t vec = sizeof(float) * ((3 * kC * kMaxC + rows + 1 + 3) / 4 * 4);
  const int dead = (n_det - 1) & 1;
  bytes[dead] = bytes[dead] > vec ? bytes[dead] : vec;
  int off = 0;
  T->x_off = off;
  off += 4 * rows;
  T->mask_off = off;
  off += rows;
  T->d2_off = off;
  off += rows;
  for (int j = 0; j < 2; ++j) {
    T->buf_off[j] = off;
    off += static_cast<int>(bytes[j] / 4);
  }
  T->vec_off = T->buf_off[dead];
  return static_cast<size_t>(off) * sizeof(float);
}

// The pooled vectors' scratch comes from the device's stream-ordered pool,
// which is told once to keep what is freed (a stream unit's 128 MiB would
// otherwise go back to the driver at every synchronisation).
void keep_pool_memory() {
  static std::once_flag once[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return;
  std::call_once(once[dev], [dev] {
    cudaMemPool_t pool;
    if (cudaDeviceGetDefaultMemPool(&pool, dev) != cudaSuccess) return;
    uint64_t keep = UINT64_MAX;
    cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  });
}

template <bool kBf16>
cudaError_t launch(const float* clusters, const float* weights, Tower T, size_t smem,
                   float* out, int stop, cudaStream_t stream, int* occ) {
  auto kernel = fused_detect_kernel<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (occ) {
    occ[0] = static_cast<int>(smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ + 1, kernel, kThreads, smem);
  }
  if (T.batch == 0) return cudaSuccess;
  if (stop != 0) {   // the time split: the block leaves before the pooled vectors go out
    kernel<<<(T.batch + kC - 1) / kC, kThreads, smem, stream>>>(clusters, weights, T, out, stop);
    return cudaGetLastError();
  }
  keep_pool_memory();
  const size_t bytes = sizeof(float) * T.batch * T.l[T.n_det - 1].cout;
  err = cudaMallocAsync(reinterpret_cast<void**>(&T.pooled_out), bytes, stream);
  if (err != cudaSuccess) return err;
  kernel<<<(T.batch + kC - 1) / kC, kThreads, smem, stream>>>(clusters, weights, T, out, 0);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    fused_detect_kernel_post<kBf16><<<(T.batch + kPost - 1) / kPost, kThreads, 0, stream>>>(
        weights, T, out);
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(T.pooled_out, stream);
  return err != cudaSuccess ? err : freed;
}

// One entry for the launch, the time split and the occupancy query (occ
// given: nothing launched).
int detect(const float* clusters, int ns, int batch, const float* weights, const int* layers,
           const int* extra, int n_det, int n_det2, int folded, int bf16, float r, float inv_r,
           float r2, float* out, int stop, cudaStream_t stream, int* occ) {
  if (stop < 0 || stop > n_det + 3) return cudaErrorInvalidValue;
  Tower T;
  const size_t smem = make_tower(&T, ns, batch, layers, extra, n_det, n_det2);
  if (smem == 0) return cudaErrorInvalidValue;
  T.folded = folded;
  T.r = r;
  T.inv_r = inv_r;
  T.r2 = r2;
  return bf16 ? launch<true>(clusters, weights, T, smem, out, stop, stream, occ)
              : launch<false>(clusters, weights, T, smem, out, stop, stream, occ);
}

}  // namespace

// clusters (batch, ns, 3) f32 origin-centred; weights: the flat f32 buffer
// of ops/fused_describe.py:_detect_kernel_weights (kernel matrices rounded
// to bf16 values under bf16); layers: host int32 array of (cin, cout, w, b,
// mu, mul, beta) per layer in the order detector convs, post convs,
// attention, orientation (mu = -1: no BN); extra: host int32 (n, 2), per
// layer the offsets of its W fragments for the tensor cores (TF32 values,
// bf16 pairs under bf16) and its column 2-norms (rounded up), -1 where it
// has none (all but the top per-slot conv); folded: input times inv_r
// instead of divided by r; bf16: activations rounded to bf16 as they are
// produced; out (batch, 3) f32: attention, c, s.
F3D_EXPORT int f3d_fused_detect(const float* clusters, int ns, int batch,
                                const float* weights, const int* layers, const int* extra,
                                int n_det, int n_det2, int folded, int bf16, float r,
                                float inv_r, float r2, float* out, cudaStream_t stream) {
  return detect(clusters, ns, batch, weights, layers, extra, n_det, n_det2, folded, bf16, r,
                inv_r, r2, out, 0, stream, nullptr);
}

// As f3d_fused_detect, leaving each cluster after stage `stop` (1 input and
// membership, 2 + l per-slot conv l, the top one without its pool, n_det +
// 2 its candidates listed, n_det + 3 the pool; 0 = all). The time split.
F3D_EXPORT int f3d_fused_detect_split(const float* clusters, int ns, int batch,
                                      const float* weights, const int* layers, const int* extra,
                                      int n_det, int n_det2, int folded, int bf16, float r,
                                      float inv_r, float r2, float* out, int stop,
                                      cudaStream_t stream) {
  return detect(clusters, ns, batch, weights, layers, extra, n_det, n_det2, folded, bf16, r,
                inv_r, r2, out, stop, stream, nullptr);
}

// The launch on this tower: out = (dynamic shared-memory bytes, blocks per
// SM).
F3D_EXPORT int f3d_fused_detect_occupancy(int ns, const int* layers, int n_det, int n_det2,
                                          int bf16, int* out) {
  return detect(nullptr, ns, 1, nullptr, layers, nullptr, n_det, n_det2, 0, bf16, 1.f, 1.f,
                1.f, nullptr, 0, nullptr, out);
}
