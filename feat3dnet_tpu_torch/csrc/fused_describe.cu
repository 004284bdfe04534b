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
// Modes:
//   kF32       the forward in f32.
//   kBf16      bf16_act: every kernel matrix arrives rounded to bf16 (the
//              wrapper rounds it); the scaled input, every ReLU output, the
//              rotated coordinates and the mid conv's output are rounded to
//              bf16 where they are produced, so every product takes bf16
//              operands and sums in f32. Membership, heads, softplus,
//              orientation, the final product and the L2 norm stay f32.
//              Activations are stored in shared memory as f32 holding bf16
//              values (the layout of kF32).
//   kStream    reads the coordinates as the forward loads them and writes
//              desc[b, :] = x of slot 0 and att[b] = y of slot 0: the launch
//              and input floor. Both _ablate_kernel_t and _ablate_kernel_2d
//              compute this.
//   kMatmul    _ablate_kernel_t's body: every product of the forward at its
//              shapes without the elementwise stream: raw coordinates into
//              both towers, no membership, ReLU, mask or rotation, pools as
//              sums over the ns slots (each slot's bias counted), desc = kp
//              (sum_s (km [d_s ; sum_s d_s] + bm)) + bp unnormalised, att =
//              (ka g + ba) + (ko g + bo)[0] * 1e-30.
//   kMatmul2d  _ablate_kernel_2d's body: the same products, but each pool
//              is slot 0's row (g = h_0, m = km [d_0 ; d_0] + bm) and the
//              mid conv's input is [d_s ; d_s].
//
// What bounds it on this card: arithmetic. At the paper widths a cluster of
// 64 slots costs about 3.9 M multiply-adds against 768 B of input and 132 B
// of output: the detector's top conv (128->256, pooled) 2.1 M (55 %), the
// descriptor's mid conv (128->128, pooled) 1.05 M (27 %), the detector's
// conv1 (64->128) 0.52 M, the descriptor's conv1 (32->64) 0.13 M. The
// folded weights are about 106 k floats (425 KB), more than a block's
// shared memory; every block reads them from L2.
//
// What the design does about it, in the forward modes (describe_kernel):
// - The outputs equal the previous design's bit for bit. That design (one
//   block of 256 threads a cluster, every product an FFMA register tile)
//   summed each output as one fmaf chain in k order, as the plain version's
//   cuBLAS f32 GEMMs do on this card. K3 rotates its descriptor's input by
//   the detector's orientation, and on the trained weights some clusters'
//   orientation moves by 1e-5-1e-4 rad when any conv sums in another order
//   (K6's finding, tests/test_torch_k6_tc.py); the descriptor is held to
//   1e-4 and cosine 0.99999.
// - The two max-pooled convs, 82 % of the work, run on the tensor cores
//   (tower_pool.cuh's pooled_conv, K6's code): 1xTF32 m16n8k8 through
//   ldmatrix in f32, bf16 m16n8k16 on bf16_act's bf16 operands. The product
//   only marks the rows that can hold a channel's maximum (within a slack
//   from the row and column norms) and a thread per channel re-sums those
//   rows as k-order chains, so the pools are the chains' pools. The mid
//   conv's values are signed (no ReLU): its candidates are not clamped at
//   0, and rows outside the ball are never candidates. A cluster always
//   has a member row (an empty ball keeps its nearest slot), so the -1e30
//   fill of its masked pool never reaches the output. Its input's right
//   half, the pool, is the same in every row of a cluster, so the TF32
//   rounding of those products is the same error in every row and its
//   slack leaves it out (pooled_conv's kShared): 1.0-1.2 candidates per
//   cluster and channel instead of 2.4-3.
// - kC = 2 clusters a block of 8 warps (128 slot rows), as K6: each
//   pooled conv's warp tile is 64 rows of one cluster by 16 channels, the
//   single-row layers (post convs, heads, the descriptor's post conv) run
//   a thread per channel with both clusters' chains, W loaded once for both.
// - The other per-slot convs stay on the CUDA cores in k order
//   (f3d::slot_layer, per cluster); the descriptor's last conv is pooled
//   after it is stored (a max of ReLU values, exact in any order).
// - Conv inputs keep a row stride of cin + 4 floats, so a fragment's eight
//   rows fall in eight bank groups. The pooled convs' W fragments (TF32
//   values, or bf16 pairs) and column norms are laid out by the wrapper,
//   once per weight list.
// - Shared memory at the paper widths: 105 504 B (2 blocks per SM): the
//   coordinates, mask, repeat flags and heads, then two buffers, 128 x 68
//   and 128 x 132 floats, that the per-slot convs ping-pong through; each
//   pooled conv keeps its pool, the single-row vectors, its input's row
//   norms and its candidate marks in the buffer it does not read.
// The decomposition bodies (kStream, kMatmul, kMatmul2d) are modes of the
// same kernel, so they differ from the f32 forward only by the work they
// leave out: the same launch, shared-memory layout and input load; the
// same per-slot convs on slot_layer (no ReLU); the two pooled convs on the
// same 1xTF32 tiles (tf32_tile_product), each tile's rows summed straight
// from its accumulators (sum_pool_layer: no row norms, marks or re-sums);
// the same single-row chains. Their time split of the forward (ms of
// stream <= matmul <= f32) is then one of the forward's own work.
#include <cuda_bf16.h>

#include "common.cuh"
#include "slot_layer.cuh"
#include "tc_mma.cuh"
#include "tower_pool.cuh"

namespace {

using f3d::BiasAct;
using f3d::kNoPool;
using namespace f3d::tower;

constexpr int kMaxLayers = 16;

enum Mode { kF32 = 0, kBf16 = 1, kStream = 2, kMatmul = 3, kMatmul2d = 4 };

struct Tower {
  int n_det, n_det2, n_desc, ns, batch;
  float r2, inv_r;
  int x_off, mask_off, dup_off, head_off, buf_off[2];   // shared memory, in floats
  int smem_floats;
  Layer l[kMaxLayers];                  // detector convs, post convs, attention,
                                        // orientation, descriptor convs, mid, post
};

// A pooled conv's room in the buffer it does not read: its pool, two
// single-row vectors (kC x kMaxC each), its input's row norms and those of
// the rows' left halves (kRows each), the candidate marks (kC x kMaxC x 2
// words) and their count.
struct PoolRoom {
  float* pooled;
  float* vec[2];
  float* hnorm;
  float* hnorm_l;
  unsigned* rowmask;
  int* count;
  __device__ explicit PoolRoom(float* p)
      : pooled(p), vec{p + kC * kMaxC, p + 2 * kC * kMaxC}, hnorm(p + 3 * kC * kMaxC),
        hnorm_l(hnorm + kRows), rowmask(reinterpret_cast<unsigned*>(hnorm_l + kRows)),
        count(reinterpret_cast<int*>(rowmask + 2 * kC * kMaxC)) {}
};
constexpr int kPoolRoomFloats = 5 * kC * kMaxC + 2 * kRows + 1;

// Pooled conv L on the block's rows of `in` (row stride ld) into room.pooled:
// marks cleared, input row norms, then pooled_conv in the phase the split
// asks (2: all); with phase 1, the candidates' count into desc[block].
// kRelu: the detector's top conv; else the mid conv, whose input's right
// half is the same in every row of a cluster (pooled_conv's kShared).
// Out of line: the pooled convs' registers then spill less into the rest.
template <bool kBf16, bool kRelu>
__device__ __noinline__ void pool_layer(const Layer& L, const float* __restrict__ wts,
                                        const float* in, int ld, const float* mask,
                                        const int* dup, const PoolRoom& room, int phase,
                                        float* desc) {
  for (int i = threadIdx.x; i < 2 * kC * kMaxC; i += kThreads) room.rowmask[i] = 0u;
  if (threadIdx.x == 0) *room.count = 0;
  row_norms(in, ld, L.cin, kRelu ? L.cin : L.cin / 2, room.hnorm, room.hnorm_l, threadIdx.x);
  __syncthreads();
  pooled_conv<kBf16, kRelu, !kRelu>(L, wts, in, ld, mask, dup, room.hnorm, room.pooled,
                                    room.rowmask, room.count, phase, room.hnorm_l);
  if (phase == 1 && threadIdx.x == 0) desc[blockIdx.x] = static_cast<float>(*room.count);
}

// A decomposition body's pooled conv L on the block's rows of `in` (row
// stride ld) into pooled[cluster * kMaxC + n]: the forward's 1xTF32 warp
// tiles (64 rows of one cluster by 16 channels), and per tile and channel
// the sum of (product + bias) over the rows whose keep flag is set, taken
// from the accumulators: each lane sums its eight rows (i, then r), then
// shuffles add the tile's eight row groups. Out of line, as pool_layer.
// Ends synced.
__device__ __noinline__ void sum_pool_layer(const Layer& L, const float* __restrict__ wts,
                                            const float* in, int ld, const float* keep,
                                            float* pooled) {
  constexpr int NT = 8 / kMT;
  constexpr int kTilesM = kRows / (16 * kMT);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles = kTilesM * (L.cout / (8 * NT));
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += kWarps) {
    const int m0 = tile % kTilesM * 16 * kMT, n0 = tile / kTilesM * 8 * NT;
    float acc[kMT][NT][4];
    tf32_tile_product<NT>(L, wts, in, ld, m0, n0, acc);
    // column 2 q + e is channel n0 + 8 q + 2 t + e, its rows m0 + 16 i + 8 r + g
    bool kept[kMT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) kept[i][r] = keep[m0 + 16 * i + 8 * r + g] > 0.5f;
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * q + 2 * t + e;
        const float b = __ldg(wts + L.b + n);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (kept[i][r]) sum += acc[i][q][2 * r + e] + b;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (g == 0) pooled[m0 / kSlots * kMaxC + n] = sum;
      }
  }
  __syncthreads();
}

// out[c * kMaxC + n] = epi(sum_k x[c * kMaxC + k] W[k][n]) for the block's
// clusters: a thread per channel keeping the kC clusters' fmaf chains in k
// order; epi rounds as BiasAct does. Ends synced.
template <bool kRound>
__device__ __forceinline__ void row_layer(const Layer& L, const float* __restrict__ wts,
                                          const float* x, bool relu, float* out) {
  const BiasAct<kRound> epi{wts + L.b, relu};
  for (int n = threadIdx.x; n < L.cout; n += kThreads) {
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.f;
    column_chains<kC>(x, wts + L.w + n, L.cout, L.cin, acc);
    const float b = epi.chan(n);
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * kMaxC + n] = epi.apply(acc[c], b);
  }
  __syncthreads();
}

// K3 in mode kMode, kC clusters a block. The forward modes (kF32, kBf16):
// `stop` (the time split) leaves after a stage: 1 input and membership, 2 +
// l detector conv l below the top one, then from s = n_det + 1 on: s the
// top conv's products, s + 1 its pool, s + 2 the post convs and heads, s +
// 3 the rotation, s + 4 the descriptor convs, s + 5 the mid conv's
// products, s + 6 its pool; s + 7 and s + 8 the top and the mid conv's
// candidates marked, their count in desc[block]; 0 runs everything. The
// decomposition bodies (kStream, kMatmul, kMatmul2d) run with stop 0.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
describe_kernel(const float* __restrict__ packed, const float* __restrict__ wts,
                const __grid_constant__ Tower T, float* __restrict__ desc,
                float* __restrict__ att, int stop) {
  constexpr bool kRound = kMode == kBf16;    // bf16_act's roundings
  constexpr bool kBody = kMode >= kStream;   // a decomposition body
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xin = sm + T.x_off;                           // kRows x 4: x, y, z, 0 (scaled)
  float* mask = sm + T.mask_off;                       // kRows (a body's: the rows pooled)
  int* dup = reinterpret_cast<int*>(sm + T.dup_off);   // kRows (first the distances)
  float* head = sm + T.head_off;                       // kC x 4: attention, c, s, -
  float* buf[2] = {sm + T.buf_off[0], sm + T.buf_off[1]};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kC, batch = T.batch;
  const int top = T.n_det - 1, d0 = T.n_det + T.n_det2 + 2, mid = d0 + T.n_desc;
  const int s = T.n_det + 1;
  const auto act = [](float v) { return kRound ? f3d::round_bf16(v) : v; };
  const auto coord = [&](int slot, int j, int b) {
    return packed[static_cast<size_t>(8 * slot + j) * batch + b];
  };

  // ---- coordinates and membership; then, per slot, whether its
  // coordinates repeat its cluster's slot 0 (a ball query's padding: every
  // value of the row is slot 0's, and so is its membership). A body keeps
  // the raw coordinates and flags the rows its pools sum: the ns slots
  // (kMatmul) or slot 0 (kMatmul2d).
  float* d2s = reinterpret_cast<float*>(dup);
  for (int row = tid; row < kRows; row += kThreads) {
    const int slot = row % kSlots, b = b0 + row / kSlots;
    float x = 0.f, y = 0.f, z = 0.f, d2 = INFINITY;
    if (b < batch && slot < T.ns) {
      x = coord(slot, 0, b);
      y = coord(slot, 1, b);
      z = coord(slot, 2, b);
      d2 = f3d::sqdist3(x, y, z);
    }
    if constexpr (kBody) {
      xin[4 * row + 0] = x;
      xin[4 * row + 1] = y;
      xin[4 * row + 2] = z;
      xin[4 * row + 3] = 0.f;
      mask[row] = (kMode == kMatmul ? slot < T.ns : slot == 0) ? 1.f : 0.f;
    } else {
      xin[4 * row + 0] = act(__fmul_rn(x, T.inv_r));
      xin[4 * row + 1] = act(__fmul_rn(y, T.inv_r));
      xin[4 * row + 2] = act(__fmul_rn(z, T.inv_r));
      xin[4 * row + 3] = 0.f;
      d2s[row] = d2;
    }
  }
  __syncthreads();
  if constexpr (kMode == kStream) {
    const int D = T.l[mid + 1].cout;
    for (int e = tid; e < kC * D; e += kThreads) {
      const int c = e / D;
      if (b0 + c < batch) desc[static_cast<size_t>(b0 + c) * D + e - c * D] = xin[4 * c * kSlots];
    }
    if (tid < kC && b0 + tid < batch) att[b0 + tid] = xin[4 * tid * kSlots + 1];
    return;
  }
  if constexpr (!kBody) {
    for (int c = warp; c < kC; c += kWarps)
      membership(d2s + c * kSlots, T.r2, mask + c * kSlots, lane);
    __syncthreads();
    for (int row = tid; row < kRows; row += kThreads) {
      const int slot = row % kSlots, b = b0 + row / kSlots;
      bool rep = b < batch && slot > 0 && slot < T.ns;
      for (int j = 0; j < 3 && rep; ++j)
        rep = __float_as_uint(coord(slot, j, b)) == __float_as_uint(coord(0, j, b));
      dup[row] = rep;
    }
    if (stop == 1) return;
  }

  // ---- detector convs below the top one: CUDA cores, k order, per cluster
  const float* in = xin;
  int ld = 4;
  for (int l = 0; l < top; ++l) {
    const Layer& L = T.l[l];
    float* out = buf[l & 1];
    const int out_ld = L.cout + 4;
    for (int c = 0; c < kC; ++c)
      f3d::slot_layer_any(L.cout, in + c * kSlots * ld, L.cin, ld, wts + L.w,
                          BiasAct<kRound>{wts + L.b, !kBody}, out + c * kSlots * out_ld,
                          out_ld, kNoPool, mask + c * kSlots, nullptr, nullptr);
    in = out;
    ld = out_ld;
    if (stop == 2 + l) return;
  }

  // ---- the top conv on the tensor cores: its max pool re-summed in k
  // order, or a body's sum pool
  const PoolRoom det(buf[top & 1]);
  if constexpr (kBody) {
    sum_pool_layer(T.l[top], wts, in, ld, mask, det.pooled);
  } else {
    pool_layer<kRound, true>(T.l[top], wts, in, ld, mask, dup, det,
                             stop == s ? 0 : stop == s + 7 ? 1 : 2, desc);
    if (stop == s || stop == s + 1 || stop == s + 7) return;
  }

  // ---- post convs (ReLU but in a body), then the heads: attention (cin ->
  // 1) and orientation (cin -> 2), a thread per cluster and output, k order
  const float* g = det.pooled;
  for (int i = 0; i < T.n_det2; ++i) {
    row_layer<kRound>(T.l[T.n_det + i], wts, g, !kBody, det.vec[i & 1]);
    g = det.vec[i & 1];
  }
  {
    const int li = T.n_det + T.n_det2;
    const int cin = T.l[li].cin;
    for (int o = tid; o < 3 * kC; o += kThreads) {
      const int c = o / 3, j = o % 3;
      const Layer& H = T.l[li + (j > 0)];
      const int col = j > 0 ? j - 1 : 0;
      float acc[1] = {0.f};
      column_chains<1>(g + c * kMaxC, wts + H.w + col, H.cout, cin, acc);
      head[c * 4 + j] = acc[0] + __ldg(wts + H.b + col);
    }
  }
  __syncthreads();
  if constexpr (!kBody) {
    if (tid < kC) {
      const float a = head[tid * 4], oc = head[tid * 4 + 1], os = head[tid * 4 + 2];
      head[tid * 4] = fmaxf(a, 0.f) + log1pf(expf(-fabsf(a)));   // logaddexp(a, 0)
      const float inv =
          1.f / sqrtf(fmaxf(__fadd_rn(__fmul_rn(oc, oc), __fmul_rn(os, os)), 1e-8f));
      head[tid * 4 + 1] = __fmul_rn(oc, inv);
      head[tid * 4 + 2] = __fmul_rn(os, inv);
    }
    __syncthreads();
    if (stop == s + 2) return;

    // ---- rotate into the canonical orientation (from the unrounded x / r)
    for (int row = tid; row < kRows; row += kThreads) {
      const int slot = row % kSlots, c = row / kSlots, b = b0 + c;
      const float co = head[c * 4 + 1], si = head[c * 4 + 2];
      float x = 0.f, y = 0.f;
      if (b < batch && slot < T.ns) {
        x = __fmul_rn(coord(slot, 0, b), T.inv_r);
        y = __fmul_rn(coord(slot, 1, b), T.inv_r);
      }
      xin[4 * row] = act(__fsub_rn(__fmul_rn(x, co), __fmul_rn(y, si)));
      xin[4 * row + 1] = act(__fadd_rn(__fmul_rn(x, si), __fmul_rn(y, co)));
    }
    __syncthreads();
    if (stop == s + 3) return;
  }

  // ---- descriptor convs on the CUDA cores; the last one stored into the
  // left half of [h | pool], then the right half: its masked max pool, a
  // body's sum over the ns slots (kMatmul, in slot order) or the row's own
  // left half (kMatmul2d)
  in = xin;
  ld = 4;
  int c_last = 0;
  for (int i = 0; i < T.n_desc; ++i) {
    const Layer& L = T.l[d0 + i];
    const bool last = i == T.n_desc - 1;
    float* out = buf[i & 1];
    const int out_ld = (last ? 2 * L.cout : L.cout) + 4;
    for (int c = 0; c < kC; ++c)
      f3d::slot_layer_any(L.cout, in + c * kSlots * ld, L.cin, ld, wts + L.w,
                          BiasAct<kRound>{wts + L.b, !kBody}, out + c * kSlots * out_ld,
                          out_ld, kNoPool, mask + c * kSlots, nullptr, nullptr);
    in = out;
    ld = out_ld;
    c_last = L.cout;
  }
  float* cat = buf[(T.n_desc - 1) & 1];
  for (int e = tid; e < kC * c_last; e += kThreads) {
    const int c = e / c_last, k = e - c * c_last;
    float* col = cat + c * kSlots * ld + k;
    if constexpr (kMode == kMatmul2d) {
      for (int r = 0; r < kSlots; ++r) col[r * ld + c_last] = col[r * ld];
    } else {
      float p = 0.f;
      for (int r = 0; r < kSlots; ++r)   // ReLU values: the max of mask * v is exact
        p = kBody ? p + col[r * ld] * mask[c * kSlots + r]
                  : fmaxf(p, col[r * ld] * mask[c * kSlots + r]);
      for (int r = 0; r < kSlots; ++r) col[r * ld + c_last] = p;
    }
  }
  __syncthreads();
  if (stop == s + 4) return;

  // ---- the mid conv (no ReLU) on the tensor cores: its masked max pool
  // re-summed in k order, or a body's sum pool; the post conv; L2 (a body's
  // output unnormalised, its orientation kept live)
  const PoolRoom dsc(buf[T.n_desc & 1]);
  if constexpr (kBody) {
    sum_pool_layer(T.l[mid], wts, cat, ld, mask, dsc.pooled);
  } else {
    pool_layer<kRound, false>(T.l[mid], wts, cat, ld, mask, dup, dsc,
                              stop == s + 5 ? 0 : stop == s + 8 ? 1 : 2, desc);
    if (stop == s + 5 || stop == s + 6 || stop == s + 8) return;
  }
  const Layer& P = T.l[mid + 1];
  row_layer<false>(P, wts, dsc.pooled, false, dsc.vec[0]);
  if (warp < kC && b0 + warp < batch) {
    const float* v = dsc.vec[0] + warp * kMaxC;
    if constexpr (kBody) {
      const size_t b = b0 + warp;
      for (int c = lane; c < P.cout; c += 32) desc[b * P.cout + c] = v[c];
      if (lane == 0) att[b] = __fadd_rn(head[warp * 4], __fmul_rn(head[warp * 4 + 1], 1e-30f));
    } else {
      float sq = 0.f;
      for (int c = lane; c < P.cout; c += 32) sq = fmaf(v[c], v[c], sq);
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      const float inv = 1.f / sqrtf(fmaxf(sq, 1e-8f));
      const size_t b = b0 + warp;
      for (int c = lane; c < P.cout; c += 32) desc[b * P.cout + c] = v[c] * inv;
      if (lane == 0) att[b] = head[warp * 4];
    }
  }
}

// Host: the tower from the (n, 4) layer table and the (n, 2) offsets of the
// pooled convs' W fragments and column norms (extra: NULL for the occupancy
// query), with the kernel's shared-memory layout. Returns false for a tower
// the kernel does not take.
bool slot_width(int c) { return c == 32 || c == 64 || c == 128 || c == 256; }

bool make_tower(Tower* T, int ns, int batch, const int* layers, const int* extra, int n_det,
                int n_det2, int n_desc) {
  const int n_layers = n_det + n_det2 + 2 + n_desc + 2;
  if (ns < 1 || ns > kSlots || batch < 0 || n_det < 1 || n_det2 < 0 || n_desc < 1 ||
      n_layers > kMaxLayers)
    return false;
  *T = Tower{};
  T->n_det = n_det;
  T->n_det2 = n_det2;
  T->n_desc = n_desc;
  T->ns = ns;
  T->batch = batch;
  const int d0 = n_det + n_det2 + 2, mid = d0 + n_desc;
  for (int i = 0; i < n_layers; ++i) {
    const int* q = layers + 4 * i;
    Layer& L = T->l[i];
    L = Layer{q[0], q[1], q[2], q[3], -1, -1, -1, extra ? extra[2 * i] : -1,
              extra ? extra[2 * i + 1] : -1};
    const bool slot = i < n_det || (i >= d0 && i < mid);
    if (L.cin < 1 || L.cin > kMaxC || L.cout < 1 || L.cout > kMaxC ||
        (slot && (!slot_width(L.cout) || L.cin % 4)))
      return false;
  }
  if (T->l[0].cin != 4 || T->l[d0].cin != 4) return false;
  // the two pooled convs on the tensor cores (16-channel warp tiles, 32-deep
  // re-sum slices), the heads 1 and 2 wide
  const Layer& top = T->l[n_det - 1];
  const Layer& m = T->l[mid];
  if (n_det < 2 || top.cin % 32 || top.cout % 16 || m.cin != 2 * T->l[mid - 1].cout ||
      m.cin % 32 || m.cout % 16 || T->l[n_det + n_det2].cout != 1 ||
      T->l[n_det + n_det2 + 1].cout != 2 || T->l[mid + 1].cin != m.cout)
    return false;
  if (extra && (top.frag < 0 || top.wnorm < 0 || m.frag < 0 || m.wnorm < 0)) return false;
  // buffer j holds what the per-slot convs write into it (conv l of a tower
  // writes buffer l & 1, the descriptor's last one [h | pool]) and the room
  // of the pooled conv that reads the other buffer
  int words[2] = {0, 0};
  const auto need = [&](int j, int n) { words[j] = words[j] > n ? words[j] : n; };
  for (int l = 0; l + 1 < n_det; ++l) need(l & 1, kRows * (T->l[l].cout + 4));
  for (int i = 0; i < n_desc; ++i) {
    const int c = T->l[d0 + i].cout;
    need(i & 1, kRows * ((i == n_desc - 1 ? 2 * c : c) + 4));
  }
  const int room = (kPoolRoomFloats + 3) / 4 * 4;
  need((n_det - 1) & 1, room);
  need(n_desc & 1, room);
  int off = 0;
  T->x_off = off;
  off += 4 * kRows;
  T->mask_off = off;
  off += kRows;
  T->dup_off = off;
  off += kRows;
  T->head_off = off;
  off += 4 * kC;
  for (int j = 0; j < 2; ++j) {
    T->buf_off[j] = off;
    off += words[j];
  }
  T->smem_floats = off;
  return true;
}

// Sets a kernel's dynamic shared memory; with occ, writes (bytes, blocks
// per SM) into it.
template <typename K>
cudaError_t prepare(K kernel, size_t smem, int* occ) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess || !occ) return err;
  occ[0] = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ + 1, kernel, kThreads, smem);
}

// One entry for the launch, the time split and the occupancy query (occ
// given: nothing launched).
int describe(const float* packed, int ns, int batch, const float* weights, const int* layers,
             const int* extra, int n_det, int n_det2, int n_desc, int mode, float r2,
             float inv_r, float* desc, float* att, int stop, cudaStream_t stream, int* occ) {
  const bool forward = mode == kF32 || mode == kBf16;
  if (mode < kF32 || mode > kMatmul2d || stop < 0 || (!forward && stop) ||
      stop > n_det + 9 || (!extra && !occ))
    return cudaErrorInvalidValue;
  Tower T;
  if (!make_tower(&T, ns, batch, layers, extra, n_det, n_det2, n_desc))
    return cudaErrorInvalidValue;
  T.r2 = r2;
  T.inv_r = inv_r;
  const auto kernel = mode == kF32      ? describe_kernel<kF32>
                      : mode == kBf16   ? describe_kernel<kBf16>
                      : mode == kStream ? describe_kernel<kStream>
                      : mode == kMatmul ? describe_kernel<kMatmul>
                                        : describe_kernel<kMatmul2d>;
  const size_t smem = sizeof(float) * static_cast<size_t>(T.smem_floats);
  const cudaError_t err = prepare(kernel, smem, occ);
  if (err != cudaSuccess || occ || batch == 0) return err;
  kernel<<<(batch + kC - 1) / kC, kThreads, smem, stream>>>(packed, weights, T, desc, att, stop);
  return cudaGetLastError();
}

}  // namespace

// packed (ns*8, batch) f32; weights: flat f32 buffer (kernel matrices
// rounded to bf16 values for mode 1); layers: host int32 array of (cin,
// cout, w_offset, b_offset) per layer in the order detector convs, detector
// post convs, attention, orientation, descriptor convs, mid conv, post
// conv; extra: host int32 (n, 2), per layer the offsets of its W fragments
// for the tensor cores (TF32 values, bf16 pairs in mode 1) and of its
// column 2-norms (rounded up), -1 where it has none (all but the detector's
// top conv and the mid conv), in every mode; mode: 0 f32, 1 bf16
// activations, 2 stream, 3 matmul, 4 matmul_2d; desc (batch, D) f32; att
// (batch,) f32.
F3D_EXPORT int f3d_fused_describe(const float* packed, int ns, int batch,
                                  const float* weights, const int* layers, const int* extra,
                                  int n_det, int n_det2, int n_desc, int mode,
                                  float r2, float inv_r, float* desc, float* att,
                                  cudaStream_t stream) {
  return describe(packed, ns, batch, weights, layers, extra, n_det, n_det2, n_desc, mode, r2,
                  inv_r, desc, att, 0, stream, nullptr);
}

// As f3d_fused_describe in modes 0 and 1, leaving each cluster after stage
// `stop` (describe_kernel; 0 = all). The time split.
F3D_EXPORT int f3d_fused_describe_split(const float* packed, int ns, int batch,
                                        const float* weights, const int* layers,
                                        const int* extra, int n_det, int n_det2, int n_desc,
                                        int mode, float r2, float inv_r, float* desc,
                                        float* att, int stop, cudaStream_t stream) {
  return describe(packed, ns, batch, weights, layers, extra, n_det, n_det2, n_desc, mode, r2,
                  inv_r, desc, att, stop, stream, nullptr);
}

// The launch on this tower in `mode`: out = (dynamic shared-memory bytes,
// blocks per SM).
F3D_EXPORT int f3d_fused_describe_occupancy(int ns, const int* layers, int n_det, int n_det2,
                                            int n_desc, int mode, int* out) {
  return describe(nullptr, ns, 1, nullptr, layers, nullptr, n_det, n_det2, n_desc, mode, 1.f,
                  1.f, nullptr, nullptr, 0, nullptr, out);
}
