// Fused training-tower passes K7-K10: stats, final, top backward, per-conv backward.
//
// Replaces: feat3dnet_tpu/ops/fused_train.py:_stats_kernel (K7, called at
// :513), _final_kernel (K8, :532), _bwdstats_top_kernel (K9, :575) and
// _bwd_kernel (K10, :630), the four Pallas passes behind tower_prepool_fused's
// custom_vjp, in the slot-major layout. Contract: the plain versions beside
// the wrappers in ops/fused_train.py. Per cluster (ns <= 64 slots), with the
// folded affines z = y * a + c of the convs already finalised:
//   K7  recompute the prefix (conv, z, ReLU, poolcat) and conv j's pre-BN
//       y = h W_j + b_j; masked sum y and sum y^2 over clusters < g_total;
//   K8  recompute everything, slot max-pool -> pooled (Gp, C_top);
//   K9  recompute, route dpooled through the pool's ties (even split), ReLU
//       mask, sum dz and sum dz * xhat of the top conv;
//   K10 recompute up to conv j; dz from the routed dpooled (top) or the
//       streamed cotangent; dy = ga * ((dz - m1) - xhat * m2), zero on pad
//       clusters; dW_j += h^T dy, db_j += dy; then either dx = dy W_0^T
//       (j = 0) or do_{j-1} = dy W_j^T (through the poolcat's lane split,
//       slot sum and tie routing), rounded to the cotangent type, and conv
//       j-1's sum dz and sum dz * xhat from the rounded value.
// Cross-block sums go to per-block partials that the wrapper adds with one
// torch.sum: no atomics, so two runs give the same bits.
//
// What bounds it on this card: arithmetic. At the paper shapes (9 216
// clusters of 64 slots, detector 3-64-128-256) one training step's 8 + 8
// passes recompute the towers about 2.2e11 multiply-adds, against about
// 7 MB of input per pass and the streamed bf16 cotangents.
//
// What the design does about it: a block of 256 threads walks its share
// of the clusters one at a time; a cluster's 64 slots live in shared memory
// (the input of every recomputed conv and the pre-BN y of the convs the
// pass reads back). Every product runs on the tensor cores (tc_product):
// mma.sync m16n8k8 with TF32 operands in the 3xTF32 split, f32
// accumulators, so the results keep f32 accuracy; only conv 0's 3-wide
// input stays on the CUDA cores (conv_fma). The recompute's convs,
// y = h W + b, take h from shared memory and W through L1; one device
// function that every pass calls sums each conv in one fixed order (the
// warp tile depends only on the conv's widths), so the recompute is
// bit-identical across passes and the ReLU and tie masks agree. A conv's
// input rows have stride cin + 4 (x: 4), so that the eight rows of a
// fragment fall in eight bank groups. Elementwise steps round op by op
// (__fmul_rn, __fadd_rn); a thread's running per-channel sums are
// compensated (Kahan).
//
// K8 and K9 take the slot max-pool of the top conv's output, and its tie
// count, where the top conv's product leaves its accumulators (conv_pool):
// a max and a tie count are exact in any order, so the reduction runs per
// thread, across a warp tile's row groups by shuffles and across the warp
// tiles through shared memory, and gives pool_ties' results bit for bit.
// K8 then keeps no top y, and two detector blocks fit on an SM.
//
// K10 does two products of its own per cluster beside the recompute,
// dW_j += h^T dy (C_in x C_j over the 64 slots) and dy W_j^T (64 x C_in over
// C_j; dx for conv 0), as many multiply-adds again as the recompute of the
// top conv or more. Operands come from shared memory (W_j^T through L1): h
// in the recompute's layout, dy written by the dy step at a swizzled column
// so that both products read it without bank conflicts. Ragged widths, pad
// slots and conv 0's 3-wide input load as zeros; each product takes the
// widest warp tile that still gives all 8 warps work. dW is added into the
// block's partial in device memory once per cluster from the accumulators
// (the partial read before the products, so the add waits on no load).
#include "common.cuh"
#include "tc_mma.cuh"

#include <cuda_bf16.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

namespace {

constexpr int kThreads = f3d::kTcThreads;
constexpr int kWarps = f3d::kTcWarps;

using f3d::tc_product_any;
using f3d::tc_tile;
using f3d::with_warp_tile;
constexpr int kSlots = 64;                 // slots per cluster in shared memory
constexpr int kMaxConvs = 8;
constexpr int kMaxC = 256;                 // widest conv input or output
constexpr int kX = 4;                      // x row stride in shared memory

struct Conv {
  int cin, cout, relu, poolcat;   // poolcat: the input is [o_prev | bcast slotmax(o_prev)]
  int w, wt, b, a, c;             // weight-buffer offsets (-1: not in this launch)
  int ld;                         // input row stride: cin + 4 (x: kX), see make_tower
  int in_off, y_off;              // shared-memory offsets of the input rows and of y
};

struct Tower {
  int n;                          // convs this launch recomputes
  int ns, gp, g_total, cin0;
  int is_top;                     // K10: conv n-1 is the plan's last conv
  int mu, isig, m1, m2, ga, mu_p, isig_p;   // vector offsets (K9, K10)
  int vec_off;                    // shared memory: 2 * kMaxC + kThreads floats (K9: + 4 kThreads)
  int part_off;                   // K8, K9: conv_pool's partials (the scratch y region)
  Conv l[kMaxConvs];
};

__device__ __forceinline__ float fold(float y, float a, float c) {
  return __fadd_rn(__fmul_rn(y, a), c);
}

__device__ __forceinline__ float act(float z, int relu) { return relu ? fmaxf(z, 0.f) : z; }

// Compensated (Kahan) running sum: a thread adds up to a few thousand terms
// over its clusters, and the BN backward subtracts such sums from each other.
struct Kahan {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = __fsub_rn(v, c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  }
};

// Where K10 writes dy[s][c] in conv j's y rows: c ^ dy_swizzle(s) when C is
// a multiple of 32 (row stride C maps a column to one bank in every row);
// the XOR stays inside the 32 channels of a warp.
// Bits 3-4 from s & 3 and bit 2 from (s >> 2) & 1 spread both fragment
// patterns over the 32 banks: B of dW (rows k0 + t, columns n0 + g) and A
// of dy W^T (rows m0 + g, columns k0 + t).
__device__ __forceinline__ int dy_swizzle(int s, int mask) {
  return (((s & 3) << 3) | (s & 4)) & mask;
}

// A thread's share of a (slot, channel) sweep over C channels: channel
// t % C, slots t / C, t / C + 256 / C, ... (threads past (256 / C) * C idle).
struct Phase {
  int c, p, step;
  bool on;
};

__device__ __forceinline__ Phase phase_of(int C) {
  const int step = kThreads / C;
  const int t = threadIdx.x;
  return Phase{t % C, t / C, step, t < step * C};
}

// Sum one value per thread over the phases of each channel, in phase order,
// into out[0..C). red: kThreads floats of shared memory.
__device__ void reduce_phases(float v, int C, float* red, float* out) {
  red[threadIdx.x] = v;
  __syncthreads();
  const int step = kThreads / C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int p = 0; p < step; ++p) s += red[p * C + c];
    out[c] = s;
  }
  __syncthreads();
}

// y (64 x L.cout, row stride cout) = h W + b for the 64 slot rows of conv
// L's input h (row stride L.ld); the bias added after the product. An input
// narrower than one mma step (conv 0's x) stays on the CUDA cores, one fmaf
// chain per output in k order: exact to f32's rounding, so conv 0's ReLU
// mask sits where an f32 reference puts it (the split's residue, ~2^-22,
// would move the z ~ 0 entries of ~600 000 rows x C). Thread t keeps
// channel t % cout's column of W in registers and walks its slots.
__device__ __forceinline__ void conv_fma(const Conv& L, const float* __restrict__ wts,
                                         const float* h, float* y) {
  const Phase ph = phase_of(L.cout);
  if (!ph.on) return;
  const int cin = L.cin, cout = L.cout, ld = L.ld;
  float w[kX];
#pragma unroll
  for (int k = 0; k < kX; ++k) w[k] = k < cin ? __ldg(wts + L.w + k * cout + ph.c) : 0.f;
  const float b = __ldg(wts + L.b + ph.c);
  for (int s = ph.p; s < kSlots; s += ph.step) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kX; ++k)
      if (k < cin) acc = fmaf(h[s * ld + k], w[k], acc);
    y[s * cout + ph.c] = __fadd_rn(acc, b);
  }
}

// Conv L's operands on the tensor cores: A (m, k) its input rows h (row
// stride L.ld), B (k, n) its W through L1; 0 past cin and cout.
__device__ __forceinline__ auto conv_a(const Conv& L, const float* h) {
  const int cin = L.cin, ld = L.ld;
  return [=](int m, int k) { return k < cin ? h[m * ld + k] : 0.f; };
}

__device__ __forceinline__ auto conv_b(const Conv& L, const float* __restrict__ wts) {
  const int cin = L.cin, cout = L.cout;
  const float* W = wts + L.w;
  return [=](int k, int n) { return k < cin && n < cout ? __ldg(W + k * cout + n) : 0.f; };
}

__device__ __forceinline__ void conv_tc(const Conv& L, const float* __restrict__ wts,
                                        const float* h, float* y) {
  const int cout = L.cout;
  const float* bias = wts + L.b;
  tc_product_any<true>(
      kSlots, cout, L.cin, conv_a(L, h), conv_b(L, wts),
      [](int, int) { return make_float2(0.f, 0.f); },
      [&](int m, int n, float2 d, float2) {
        if (n < cout)
          *reinterpret_cast<float2*>(y + m * cout + n) =
              make_float2(__fadd_rn(d.x, __ldg(bias + n)), __fadd_rn(d.y, __ldg(bias + n + 1)));
      });
}

// (v, count) into a channel's running slot max-pool m and tie count n
// (start: -inf, 0): the larger max wins, equal maxima (==, so +0 and -0
// alike) add their counts. Exact in any order, so every order gives
// pool_ties' pool (up to the sign of a zero) and count; a NaN takes no
// part, as in pool_ties past slot 0. Without kTies only the max.
template <bool kTies>
__device__ __forceinline__ void pool_add(float& m, float& n, float v, float count) {
  const float x = fmaxf(m, v);
  if (kTies) n = (m == x ? n : 0.f) + (v == x ? count : 0.f);
  m = x;
}

// One level of a warp tile's reduction across its eight row groups g, on
// lane bit `bit` (16, 8, 4): with kC > 1 columns left in (m, n), a lane
// keeps half of them (the upper half where its bit is set), adds its
// partner's values of that half and records in idx which half; with one
// left, both lanes add it, and of the two only the one without the bit
// goes on writing (writer).
template <bool kTies, int kC, int kN>
__device__ __forceinline__ void pool_level(float (&m)[kN], float (&n)[kN], int bit, int& idx,
                                           bool& writer) {
  const bool up = threadIdx.x & bit;
  if constexpr (kC == 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m[0], bit);
    const float on = kTies ? __shfl_xor_sync(0xffffffffu, n[0], bit) : 0.f;
    pool_add<kTies>(m[0], n[0], om, on);
    writer = writer && !up;
  } else {
    constexpr int kH = kC / 2;
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const float om = __shfl_xor_sync(0xffffffffu, up ? m[i] : m[i + kH], bit);
      const float on = kTies ? __shfl_xor_sync(0xffffffffu, up ? n[i] : n[i + kH], bit) : 0.f;
      if (up) {
        m[i] = m[i + kH];
        n[i] = n[i + kH];
      }
      pool_add<kTies>(m[i], n[i], om, on);
    }
    idx += up ? kH : 0;
  }
}

// conv_pool's partials in shared memory: maxima at part[k * C + c], counts
// at part[kPartCount + k * C + c]; k < the 64 slots' warp tiles (at most 4)
// or conv_fma's phases (256 / C, k * C < 256)
constexpr int kPartCount = 4 * kMaxC;

// The top conv's y = h W + b, as conv_fma / conv_tc compute it, with the
// slot max-pool of its output o = act(fold(y)) and (kTies) the pool's tie
// count taken where y is made, over the slots < ns (pad slots take no
// part). On the tensor cores: each thread over its 2 MT rows of each of
// its 2 NT columns, then across the warp tile's eight row groups
// (pool_level: shuffles on lane bits 4, 3, 2, halving the columns a lane
// holds); on the CUDA cores each thread over its slots. Then across the
// partials (the warp tiles of the 64 slots, or conv_fma's phases) through
// `part` (2 kPartCount floats of shared memory), in partial order. y is
// stored only when given (K9 reads it back; K8 keeps none). Ends with
// out(c, pool, count) for every channel (count 0 without kTies), not
// synced.
template <bool kTies, typename Out>
__device__ __forceinline__ void conv_pool(const Conv& L, const float* __restrict__ wts,
                                          const float* h, float* y, int ns, float* part,
                                          Out out) {
  const int cout = L.cout, relu = L.relu;
  const float* bias = wts + L.b;
  const float* fa = wts + L.a;
  const float* fc = wts + L.c;
  int parts;
  if (L.cin < 8) {
    const Phase ph = phase_of(cout);
    parts = ph.step;
    if (ph.on) {
      const int cin = L.cin, ld = L.ld;
      float w[kX];
#pragma unroll
      for (int k = 0; k < kX; ++k) w[k] = k < cin ? __ldg(wts + L.w + k * cout + ph.c) : 0.f;
      const float b = __ldg(bias + ph.c), a = fa[ph.c], c = fc[ph.c];
      float pm = -INFINITY, pn = 0.f;
      for (int s = ph.p; s < kSlots; s += ph.step) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kX; ++k)
          if (k < cin) acc = fmaf(h[s * ld + k], w[k], acc);
        const float yv = __fadd_rn(acc, b);
        if (y) y[s * cout + ph.c] = yv;
        if (s < ns) pool_add<kTies>(pm, pn, act(fold(yv, a, c), relu), 1.f);
      }
      part[ph.p * cout + ph.c] = pm;
      if (kTies) part[kPartCount + ph.p * cout + ph.c] = pn;
    }
  } else {
    with_warp_tile(kSlots, cout, [&](auto wt) {
      constexpr int MT = decltype(wt)::MT, NT = decltype(wt)::NT, kCols = 2 * NT;
      const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
      const int tiles_n = (cout + 8 * NT - 1) / (8 * NT);
      parts = kSlots / (16 * MT);
      for (int tile = threadIdx.x >> 5; tile < parts * tiles_n; tile += kWarps) {
        const int mt = tile / tiles_n, m0 = mt * 16 * MT, n0 = tile % tiles_n * 8 * NT;
        float acc[MT][NT][4];
        tc_tile<true>(m0, n0, L.cin, conv_a(L, h), conv_b(L, wts), acc);
        bool valid[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) valid[i][r] = m0 + 16 * i + 8 * r + g < ns;
        // column j = 2 q + e: n0 + 8 q + 2 t + e; its rows m0 + 16 i + 8 r + g
        float pm[kCols], pn[kCols];
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          const int n = n0 + 8 * q + 2 * t;     // columns n, n + 1: cout % 4 == 0
          if (n >= cout) {
            pm[2 * q] = pm[2 * q + 1] = -INFINITY;
            pn[2 * q] = pn[2 * q + 1] = 0.f;
            continue;
          }
          const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
          const float a0 = fa[n], a1 = fa[n + 1], c0 = fc[n], c1 = fc[n + 1];
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 v = make_float2(__fadd_rn(acc[i][q][2 * r], b0),
                                           __fadd_rn(acc[i][q][2 * r + 1], b1));
              if (y) *reinterpret_cast<float2*>(y + (m0 + 16 * i + 8 * r + g) * cout + n) = v;
              acc[i][q][2 * r] = act(fold(v.x, a0, c0), relu);
              acc[i][q][2 * r + 1] = act(fold(v.y, a1, c1), relu);
            }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float mx = -INFINITY, cnt = 0.f;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (valid[i][r]) mx = fmaxf(mx, acc[i][q][2 * r + e]);
            if (kTies)
#pragma unroll
              for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int r = 0; r < 2; ++r)
                  cnt += valid[i][r] && acc[i][q][2 * r + e] == mx ? 1.f : 0.f;
            pm[2 * q + e] = mx;
            pn[2 * q + e] = cnt;
          }
        }
        int idx = 0;
        bool writer = true;
        pool_level<kTies, kCols>(pm, pn, 16, idx, writer);
        pool_level<kTies, (kCols > 1 ? kCols / 2 : 1)>(pm, pn, 8, idx, writer);
        pool_level<kTies, (kCols > 2 ? kCols / 4 : 1)>(pm, pn, 4, idx, writer);
        const int n = n0 + 8 * (idx / 2) + 2 * t + idx % 2;
        if (writer && n < cout) {
          part[mt * cout + n] = pm[0];
          if (kTies) part[kPartCount + mt * cout + n] = pn[0];
        }
      }
    });
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cout; c += kThreads) {
    float m = -INFINITY, n = 0.f;
    for (int k = 0; k < parts; ++k)
      pool_add<kTies>(m, n, part[k * cout + c], kTies ? part[kPartCount + k * cout + c] : 0.f);
    out(c, m, n);
  }
}

// recompute's default last conv: y stored like every other conv's (K7, K10).
struct StoreY {};

// Cluster g through convs 0..T.n-1: x into conv 0's input, then per conv its
// y, and for every conv but the last its output into the next conv's input
// (with the poolcat's broadcast half where the plan has one). A `top` other
// than StoreY runs the last conv as top(L, h), h its input rows. Ends synced.
template <typename Top = StoreY>
__device__ void recompute(const Tower& T, const float* __restrict__ x,
                          const float* __restrict__ wts, float* sm, int g, Top top = {}) {
  float* in0 = sm + T.l[0].in_off;
  for (int e = threadIdx.x; e < kSlots * kX; e += kThreads) {
    const int s = e / kX, k = e % kX;
    in0[e] = (s < T.ns && k < T.cin0)
        ? __ldg(x + (static_cast<size_t>(s) * T.gp + g) * T.cin0 + k) : 0.f;
  }
  __syncthreads();
  for (int l = 0; l < T.n; ++l) {
    const Conv& L = T.l[l];
    if constexpr (!std::is_same_v<Top, StoreY>) {
      if (l + 1 == T.n) {
        top(L, sm + L.in_off);
        __syncthreads();
        break;
      }
    }
    float* y = sm + L.y_off;
    if (L.cin < 8) conv_fma(L, wts, sm + L.in_off, y);
    else conv_tc(L, wts, sm + L.in_off, y);
    __syncthreads();
    if (l + 1 == T.n) break;
    const Conv& N = T.l[l + 1];
    float* nxt = sm + N.in_off;
    const int C = L.cout, ld = N.ld;
    for (int e = threadIdx.x; e < kSlots * C; e += kThreads) {
      const int s = e / C, c = e % C;
      nxt[s * ld + c] = act(fold(y[e], wts[L.a + c], wts[L.c + c]), L.relu);
    }
    __syncthreads();
    if (N.poolcat) {
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float m = nxt[c];
        for (int s = 1; s < T.ns; ++s) m = fmaxf(m, nxt[s * ld + c]);
        for (int s = 0; s < kSlots; ++s) nxt[s * ld + C + c] = m;
      }
      __syncthreads();
    }
  }
}

// Slot max-pool of conv L's output o = act(fold(y)) per channel, its tie
// count, and (dpool given) the even-split share dpool / count.
__device__ void pool_ties(const Conv& L, const float* __restrict__ wts, const float* y, int ns,
                          const float* __restrict__ dpool, float* pool, float* unit) {
  const int C = L.cout;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float a = wts[L.a + c], cc = wts[L.c + c];
    float m = act(fold(y[c], a, cc), L.relu);
    for (int s = 1; s < ns; ++s) m = fmaxf(m, act(fold(y[s * C + c], a, cc), L.relu));
    float n = 0.f;
    for (int s = 0; s < ns; ++s) n += act(fold(y[s * C + c], a, cc), L.relu) == m ? 1.f : 0.f;
    pool[c] = m;
    if (dpool) unit[c] = __fdiv_rn(dpool[c], n);
  }
}

__device__ __forceinline__ float load_cot(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(kThreads)
train_stats_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   const __grid_constant__ Tower T, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Conv& L = T.l[T.n - 1];
  const int C = L.cout;
  const Phase ph = phase_of(C);
  Kahan s1, s2;
  for (int g = blockIdx.x; g < T.gp; g += gridDim.x) {
    recompute(T, x, wts, sm, g);
    if (g < T.g_total && ph.on) {
      const float* y = sm + L.y_off;
      for (int s = ph.p; s < T.ns; s += ph.step) {
        const float v = y[s * C + ph.c];
        s1.add(v);
        s2.add(__fmul_rn(v, v));
      }
    }
    __syncthreads();
  }
  float* red = sm + T.vec_off + 2 * kMaxC;
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * C;
  reduce_phases(ph.on ? s1.s : 0.f, C, red, out);
  reduce_phases(ph.on ? s2.s : 0.f, C, red, out + C);
}

// K8's and K10's stages; a split build returns from each cluster after one
// of them (chip_smoke's train_final_time_split and train_bwd_time_split),
// kStopNone runs them all. K8 has only kStopRecompute.
enum Stop { kStopNone, kStopRecompute, kStopDy, kStopDw, kStopDcat };

// K8: the pool taken in the top conv's epilogue (conv_pool), no top y kept,
// so that two detector blocks fit on an SM. The split build (kStopRecompute)
// reduces the pool into conv_pool's partials and leaves before combining and
// writing them.
template <int kStop>
__global__ void __launch_bounds__(kThreads, 2)
train_final_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   const __grid_constant__ Tower T, float* __restrict__ pooled) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* part = sm + T.part_off;
  for (int g = blockIdx.x; g < T.gp; g += gridDim.x) {
    float* out = pooled + static_cast<size_t>(g) * T.l[T.n - 1].cout;
    recompute(T, x, wts, sm, g, [&](const Conv& L, const float* h) {
      if constexpr (kStop == kStopRecompute)
        conv_pool<false>(L, wts, h, nullptr, T.ns, part, [](int, float, float) {});
      else
        conv_pool<false>(L, wts, h, nullptr, T.ns, part,
                         [&](int c, float m, float) { out[c] = m; });
    });
  }
}

// K9: the pool and its tie count from the top conv's epilogue (conv_pool);
// y kept for the dz sums. A thread's running sums wait in shared memory
// between clusters (run: s1 and s2, each sum and compensation), so that
// the recompute's products have the registers.
__global__ void __launch_bounds__(kThreads)
train_bwd_top_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                     const __grid_constant__ Tower T, const float* __restrict__ dpool,
                     float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Conv& L = T.l[T.n - 1];
  const int C = L.cout;
  float* pool = sm + T.vec_off;
  float* unit = pool + kMaxC;
  float* pool_part = sm + T.part_off;
  const float* y = sm + L.y_off;
  const Phase ph = phase_of(C);
  float* run = sm + T.vec_off + 2 * kMaxC + kThreads;
  for (int k = 0; k < 4; ++k) run[k * kThreads + threadIdx.x] = 0.f;
  for (int g = blockIdx.x; g < T.gp; g += gridDim.x) {
    const float* dp = dpool + static_cast<size_t>(g) * C;
    recompute(T, x, wts, sm, g, [&](const Conv&, const float* h) {
      conv_pool<true>(L, wts, h, sm + L.y_off, T.ns, pool_part, [&](int c, float m, float n) {
        pool[c] = m;
        unit[c] = __fdiv_rn(dp[c], n);
      });
    });
    if (ph.on) {
      const int c = ph.c;
      const float a = wts[L.a + c], cc = wts[L.c + c];
      const float mu = wts[T.mu + c], isig = wts[T.isig + c];
      float* r = run + threadIdx.x;
      Kahan s1{r[0], r[kThreads]}, s2{r[2 * kThreads], r[3 * kThreads]};
      for (int s = ph.p; s < T.ns; s += ph.step) {
        const float yv = y[s * C + c];
        const float z = fold(yv, a, cc);
        const float d = act(z, L.relu) == pool[c] ? unit[c] : 0.f;
        const float dz = (L.relu && !(z > 0.f)) ? 0.f : d;
        s1.add(dz);
        s2.add(__fmul_rn(dz, __fmul_rn(__fsub_rn(yv, mu), isig)));
      }
      r[0] = s1.s;
      r[kThreads] = s1.c;
      r[2 * kThreads] = s2.s;
      r[3 * kThreads] = s2.c;
    }
    __syncthreads();
  }
  float* red = sm + T.vec_off + 2 * kMaxC;
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * C;
  reduce_phases(ph.on ? run[threadIdx.x] : 0.f, C, red, out);
  reduce_phases(ph.on ? run[2 * kThreads + threadIdx.x] : 0.f, C, red, out + C);
}

template <int kStop>
__global__ void __launch_bounds__(kThreads)
train_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                 const __grid_constant__ Tower T, const void* __restrict__ src, int src_bf16,
                 float* __restrict__ dw_part, float* __restrict__ db_part,
                 void* __restrict__ out, int out_bf16, float* __restrict__ bst_part) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int j = T.n - 1;
  const Conv& L = T.l[j];
  const int C = L.cout;
  float* y = sm + L.y_off;          // y_j, then dy in place
  float* hin = sm + L.in_off;       // conv j's input, then dy W_j^T
  float* pool = sm + T.vec_off;
  float* unit = pool + kMaxC;
  float* red = unit + kMaxC;
  const Phase ph = phase_of(C);
  const int cp = j > 0 ? T.l[j - 1].cout : 1;
  const Phase pp = phase_of(cp);
  const int swz = C % 32 == 0 ? 31 : 0;
  Kahan db, s1, s2;
  float* dw = dw_part + static_cast<size_t>(blockIdx.x) * L.cin * C;
  bool first = true;
  for (int g = blockIdx.x; g < T.gp; g += gridDim.x) {
    recompute(T, x, wts, sm, g);
    if (kStop == kStopRecompute) continue;
    if (T.is_top) {
      pool_ties(L, wts, y, T.ns, reinterpret_cast<const float*>(src) + static_cast<size_t>(g) * C,
                pool, unit);
      __syncthreads();
    }
    // ---- dy = ga * ((dz - m1) - xhat * m2), zero on pad clusters and pad
    // slots, in place at the swizzled column: the lanes of a warp hold 32
    // consecutive channels of one slot, so a shuffle hands each lane the
    // value its own position stores and no thread writes what another reads
    if (ph.on) {
      const int c = ph.c;
      const float a = wts[L.a + c], cc = wts[L.c + c];
      const float mu = wts[T.mu + c], isig = wts[T.isig + c];
      const float m1 = wts[T.m1 + c], m2 = wts[T.m2 + c], ga = wts[T.ga + c];
      const float valid = g < T.g_total ? 1.f : 0.f;
      for (int s = ph.p; s < kSlots; s += ph.step) {
        float* p = y + s * C + c;
        float dyv = 0.f;
        if (s < T.ns) {
          const float yv = *p;
          const float z = fold(yv, a, cc);
          float d;
          if (T.is_top) d = act(z, L.relu) == pool[c] ? unit[c] : 0.f;
          else d = load_cot(src, src_bf16, (static_cast<size_t>(s) * T.gp + g) * C + c);
          const float dz = (L.relu && !(z > 0.f)) ? 0.f : d;
          const float xh = __fmul_rn(__fsub_rn(yv, mu), isig);
          const float t = __fsub_rn(__fsub_rn(dz, m1), __fmul_rn(xh, m2));
          dyv = __fmul_rn(__fmul_rn(ga, t), valid);
          db.add(dyv);
        }
        *p = swz ? __shfl_xor_sync(0xffffffffu, dyv, dy_swizzle(s, swz)) : dyv;
      }
    }
    __syncthreads();
    if (kStop == kStopDy) continue;
    // ---- dW_j += h^T dy: M = C_in, N = C_j, K = the 64 slots (dy is 0 past ns)
    {
      const int ldh = L.ld, cin = L.cin;
      tc_product_any(
          cin, C, kSlots, [&](int m, int k) { return m < cin ? hin[k * ldh + m] : 0.f; },
          [&](int k, int n) { return n < C ? y[k * C + (n ^ dy_swizzle(k, swz))] : 0.f; },
          [&](int m, int n) {
            return first || m >= cin || n >= C
                ? make_float2(0.f, 0.f)
                : *reinterpret_cast<const float2*>(dw + static_cast<size_t>(m) * C + n);
          },
          [&](int m, int n, float2 d, float2 o) {
            if (m >= cin || n >= C) return;
            *reinterpret_cast<float2*>(dw + static_cast<size_t>(m) * C + n) =
                first ? d : make_float2(o.x + d.x, o.y + d.y);
          });
    }
    first = false;
    __syncthreads();
    if (kStop == kStopDw) continue;
    // dy as the A operand of dy W^T: M = the 64 slots, K = C_j
    auto dy_a = [&](int m, int k) { return k < C ? y[m * C + (k ^ dy_swizzle(m, swz))] : 0.f; };
    auto no_prev = [](int, int) { return make_float2(0.f, 0.f); };
    if (j == 0) {
      // ---- dx = dy W_0^T: N = cin0 (W_0 is (cin0, C) row-major)
      float* dx = reinterpret_cast<float*>(out);
      const float* W = wts + L.w;
      const int cin0 = T.cin0;
      tc_product_any(
          kSlots, cin0, C, dy_a,
          [&](int k, int n) { return k < C && n < cin0 ? __ldg(W + n * C + k) : 0.f; },
          no_prev, [&](int m, int n, float2 d, float2) {
            if (m >= T.ns) return;
            float* p = dx + (static_cast<size_t>(m) * T.gp + g) * cin0;
            if (n < cin0) p[n] = d.x;
            if (n + 1 < cin0) p[n + 1] = d.y;
          });
    } else {
      // ---- do_{j-1} = dy W_j^T (through the poolcat), rounded, and conv j-1's sums
      const Conv& P = T.l[j - 1];
      const float* wt = wts + L.wt;   // W_j^T, (C, C_in) row-major
      const int cin = L.cin, ld = L.ld;
      tc_product_any(
          kSlots, cin, C, dy_a,
          [&](int k, int n) { return k < C && n < cin ? __ldg(wt + k * cin + n) : 0.f; },
          no_prev, [&](int m, int n, float2 d, float2) {
            if (n < cin) *reinterpret_cast<float2*>(hin + m * ld + n) = d;
          });
      __syncthreads();
      if (kStop == kStopDcat) continue;
      const float* yp = sm + P.y_off;
      if (L.poolcat) {
        pool_ties(P, wts, yp, T.ns, nullptr, pool, nullptr);
        for (int c = threadIdx.x; c < cp; c += kThreads) {
          float dp = hin[cp + c];
          for (int s = 1; s < T.ns; ++s) dp = __fadd_rn(dp, hin[s * L.ld + cp + c]);
          float n = 0.f;
          for (int s = 0; s < T.ns; ++s)
            n += act(fold(yp[s * cp + c], wts[P.a + c], wts[P.c + c]), P.relu) == pool[c]
                ? 1.f : 0.f;
          unit[c] = __fdiv_rn(dp, n);
        }
        __syncthreads();
      }
      if (pp.on) {
        const int c = pp.c;
        const float a = wts[P.a + c], cc = wts[P.c + c];
        const float mu = wts[T.mu_p + c], isig = wts[T.isig_p + c];
        for (int s = pp.p; s < T.ns; s += pp.step) {
          const float yv = yp[s * cp + c];
          const float z = fold(yv, a, cc);
          float d = hin[s * L.ld + c];
          if (L.poolcat) d = __fadd_rn(d, act(z, P.relu) == pool[c] ? unit[c] : 0.f);
          const size_t o = (static_cast<size_t>(s) * T.gp + g) * cp + c;
          float dr = d;
          if (out_bf16) {
            const __nv_bfloat16 hb = __float2bfloat16_rn(d);
            reinterpret_cast<__nv_bfloat16*>(out)[o] = hb;
            dr = __bfloat162float(hb);
          } else {
            reinterpret_cast<float*>(out)[o] = d;
          }
          const float dz = (P.relu && !(z > 0.f)) ? 0.f : dr;
          s1.add(dz);
          s2.add(__fmul_rn(dz, __fmul_rn(__fsub_rn(yv, mu), isig)));
        }
      }
    }
    __syncthreads();
  }
  reduce_phases(ph.on ? db.s : 0.f, C, red, db_part + static_cast<size_t>(blockIdx.x) * C);
  if (j > 0) {
    float* bo = bst_part + static_cast<size_t>(blockIdx.x) * 2 * cp;
    reduce_phases(pp.on ? s1.s : 0.f, cp, red, bo);
    reduce_phases(pp.on ? s2.s : 0.f, cp, red, bo + cp);
  }
}

enum Kind { kStats, kFinal, kBwdTop, kBwd };

// Host: the tower from the (n, 9) conv table (cin, cout, relu, poolcat, w,
// wt, b, a, c) and the vector offsets, with its shared-memory layout: the
// input rows of every conv, y rows of the convs the pass reads back, one
// scratch region for the rest, then the per-channel vectors (and K9's
// running sums). Returns the bytes, or 0 for a bad tower.
size_t make_tower(Tower* T, int kind, int ns, int gp, int g_total, int cin0, const int* convs,
                  int n, const int* vecs, int is_top) {
  if (n < 1 || n > kMaxConvs || ns < 1 || ns > kSlots || cin0 < 1 || cin0 > kX || gp < 1 ||
      g_total < 0 || g_total > gp)
    return 0;
  *T = Tower{};
  T->n = n;
  T->ns = ns;
  T->gp = gp;
  T->g_total = g_total;
  T->cin0 = cin0;
  T->is_top = is_top;
  int* v[7] = {&T->mu, &T->isig, &T->m1, &T->m2, &T->ga, &T->mu_p, &T->isig_p};
  for (int i = 0; i < 7; ++i) *v[i] = -1;
  if (kind == kBwdTop) { T->mu = vecs[0]; T->isig = vecs[1]; }
  if (kind == kBwd)
    for (int i = 0; i < 7; ++i) *v[i] = vecs[i];
  size_t off = 0;
  for (int l = 0; l < n; ++l) {
    const int* q = convs + 9 * l;
    Conv& L = T->l[l];
    L = Conv{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], 0, 0, 0};
    const bool ok_in = l == 0 ? L.cin == cin0 : (L.cin % 4 == 0 && L.cin <= kMaxC);
    if (!ok_in || L.cout % 4 || L.cout < 4 || L.cout > kMaxC || (l == 0 && L.poolcat)) return 0;
    if (l > 0 && L.cin != (L.poolcat ? 2 : 1) * T->l[l - 1].cout) return 0;
    // cin + 4 is 4 mod 32 at the widths that are multiples of 32: a
    // fragment's rows (g) and columns (t) map to bank 4 g + t, and h^T's in
    // K10's dW to 4 t + g, all 32 distinct
    L.ld = l == 0 ? kX : L.cin + 4;
    L.in_off = static_cast<int>(off);
    off += static_cast<size_t>(kSlots) * L.ld;
  }
  // y rows kept for the convs the pass reads back: the last (but in K8,
  // whose pool conv_pool takes from the accumulators) and in K10 also the
  // one before; one scratch region for the rest, in K8 and K9 also
  // conv_pool's partials (dead y rows once the top conv's product starts)
  auto kept = [&](int l) {
    return (l == n - 1 && kind != kFinal) || (kind == kBwd && l == n - 2);
  };
  size_t scratch = 0;
  for (int l = 0; l < n; ++l) {
    if (kept(l)) {
      T->l[l].y_off = static_cast<int>(off);
      off += static_cast<size_t>(kSlots) * T->l[l].cout;
    } else if (l < n - 1) {
      scratch = std::max(scratch, static_cast<size_t>(kSlots) * T->l[l].cout);
    }
  }
  if (kind == kFinal || kind == kBwdTop) scratch = std::max(scratch, size_t{2} * kPartCount);
  for (int l = 0; l < n; ++l)
    if (!kept(l)) T->l[l].y_off = static_cast<int>(off);
  T->part_off = static_cast<int>(off);
  off += scratch;
  T->vec_off = static_cast<int>(off);
  off += 2 * kMaxC + kThreads;
  if (kind == kBwdTop) off += 4 * kThreads;   // K9's running sums
  return off * sizeof(float);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The dynamic shared memory of a launch and the blocks of it that fit on
// one SM: out = (bytes, blocks).
template <typename K>
cudaError_t occupancy(K kernel, size_t smem, int* out) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  out[0] = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kernel, kThreads, smem);
}

template <int kStop>
cudaError_t launch_final(const float* x, int ns, int gp, int cin0, const float* wts,
                         const int* convs, int n, int nblk, float* pooled, cudaStream_t stream) {
  Tower T;
  const size_t smem = make_tower(&T, kFinal, ns, gp, gp, cin0, convs, n, nullptr, 0);
  if (smem == 0 || nblk < 1) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(train_final_kernel<kStop>, smem);
  if (err != cudaSuccess) return err;
  train_final_kernel<kStop><<<nblk, kThreads, smem, stream>>>(x, wts, T, pooled);
  return cudaGetLastError();
}

template <int kStop>
cudaError_t launch_bwd(const Tower& T, size_t smem, int nblk, const float* x, const float* wts,
                       const void* src, int src_bf16, float* dw_part, float* db_part, void* out,
                       int out_bf16, float* bst_part, cudaStream_t stream) {
  cudaError_t err = set_smem(train_bwd_kernel<kStop>, smem);
  if (err != cudaSuccess) return err;
  train_bwd_kernel<kStop><<<nblk, kThreads, smem, stream>>>(x, wts, T, src, src_bf16, dw_part,
                                                           db_part, out, out_bf16, bst_part);
  return cudaGetLastError();
}

int train_bwd(const float* x, int ns, int gp, int g_total, int cin0, const float* wts,
              const int* convs, int n, const int* vecs, int nblk, int is_top, const void* src,
              int src_bf16, float* dw_part, float* db_part, void* out, int out_bf16,
              float* bst_part, int stop, cudaStream_t stream) {
  Tower T;
  const size_t smem = make_tower(&T, kBwd, ns, gp, g_total, cin0, convs, n, vecs, is_top);
  if (smem == 0 || nblk < 1 || T.l[n - 1].wt < 0 || (n > 1 && bst_part == nullptr))
    return cudaErrorInvalidValue;
  switch (stop) {
#define F3D_BWD(k) \
  case k:          \
    return launch_bwd<k>(T, smem, nblk, x, wts, src, src_bf16, dw_part, db_part, out, out_bf16, \
                         bst_part, stream);
    F3D_BWD(kStopNone)
    F3D_BWD(kStopRecompute)
    F3D_BWD(kStopDy)
    F3D_BWD(kStopDw)
    F3D_BWD(kStopDcat)
#undef F3D_BWD
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Common arguments: x (ns, gp, cin0) f32 slot-major; wts: the flat f32
// weight buffer; convs: host int32 (n, 9) table; nblk: blocks (each writes
// one row of the partials). K7: part (nblk, 2, C_j) sum y / sum y^2.
F3D_EXPORT int f3d_train_stats(const float* x, int ns, int gp, int g_total, int cin0,
                               const float* wts, const int* convs, int n, int nblk,
                               float* part, cudaStream_t stream) {
  Tower T;
  const size_t smem = make_tower(&T, kStats, ns, gp, g_total, cin0, convs, n, nullptr, 0);
  if (smem == 0 || nblk < 1) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(train_stats_kernel, smem);
  if (err != cudaSuccess) return err;
  train_stats_kernel<<<nblk, kThreads, smem, stream>>>(x, wts, T, part);
  return cudaGetLastError();
}

// K8: pooled (gp, C_top) f32.
F3D_EXPORT int f3d_train_final(const float* x, int ns, int gp, int cin0, const float* wts,
                               const int* convs, int n, int nblk, float* pooled,
                               cudaStream_t stream) {
  return launch_final<kStopNone>(x, ns, gp, cin0, wts, convs, n, nblk, pooled, stream);
}

// K8 returning from each cluster after the recompute (stop 1; 0 = all):
// the time split, nothing else. pooled is not written.
F3D_EXPORT int f3d_train_final_split(const float* x, int ns, int gp, int cin0, const float* wts,
                                     const int* convs, int n, int nblk, float* pooled, int stop,
                                     cudaStream_t stream) {
  switch (stop) {
    case kStopNone:
      return launch_final<kStopNone>(x, ns, gp, cin0, wts, convs, n, nblk, pooled, stream);
    case kStopRecompute:
      return launch_final<kStopRecompute>(x, ns, gp, cin0, wts, convs, n, nblk, pooled, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K9: vecs = (mu, isig) offsets; dpool (gp, C_top) f32; part (nblk, 2, C_top).
F3D_EXPORT int f3d_train_bwd_top(const float* x, int ns, int gp, int cin0, const float* wts,
                                 const int* convs, int n, const int* vecs, int nblk,
                                 const float* dpool, float* part, cudaStream_t stream) {
  Tower T;
  const size_t smem = make_tower(&T, kBwdTop, ns, gp, gp, cin0, convs, n, vecs, 1);
  if (smem == 0 || nblk < 1) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(train_bwd_top_kernel, smem);
  if (err != cudaSuccess) return err;
  train_bwd_top_kernel<<<nblk, kThreads, smem, stream>>>(x, wts, T, dpool, part);
  return cudaGetLastError();
}

// K10 for conv j = n - 1: vecs = (mu, isig, m1, m2, ga, mu_p, isig_p)
// offsets; src: dpooled (gp, C_j) f32 when is_top, else the cotangent
// (ns, gp, C_j) (bf16 when src_bf16); dw_part (nblk, C_in, C_j), db_part
// (nblk, C_j); out: do_{j-1} (ns, gp, C_{j-1}) (bf16 when out_bf16) with
// bst_part (nblk, 2, C_{j-1}), or dx (ns, gp, cin0) f32 when j == 0.
F3D_EXPORT int f3d_train_bwd(const float* x, int ns, int gp, int g_total, int cin0,
                             const float* wts, const int* convs, int n, const int* vecs,
                             int nblk, int is_top, const void* src, int src_bf16,
                             float* dw_part, float* db_part, void* out, int out_bf16,
                             float* bst_part, cudaStream_t stream) {
  return train_bwd(x, ns, gp, g_total, cin0, wts, convs, n, vecs, nblk, is_top, src, src_bf16,
                   dw_part, db_part, out, out_bf16, bst_part, kStopNone, stream);
}

// K10 returning from each cluster after stage `stop` (1 recompute, 2 dy,
// 3 dW, 4 dy W^T; 0 = all): the time split, nothing else. Outputs are
// partial.
F3D_EXPORT int f3d_train_bwd_split(const float* x, int ns, int gp, int g_total, int cin0,
                                   const float* wts, const int* convs, int n, const int* vecs,
                                   int nblk, int is_top, const void* src, int src_bf16,
                                   float* dw_part, float* db_part, void* out, int out_bf16,
                                   float* bst_part, int stop, cudaStream_t stream) {
  return train_bwd(x, ns, gp, g_total, cin0, wts, convs, n, vecs, nblk, is_top, src, src_bf16,
                   dw_part, db_part, out, out_bf16, bst_part, stop, stream);
}

// The launch of pass `kind` (0 K7, 1 K8, 2 K9, 3 K10) on this tower: out =
// (its dynamic shared-memory bytes, the blocks of it that fit on one SM).
F3D_EXPORT int f3d_train_occupancy(int kind, int ns, int gp, int cin0, const int* convs, int n,
                                   int is_top, int* out) {
  static const int vecs[7] = {};
  Tower T;
  const size_t smem = make_tower(&T, kind, ns, gp, gp, cin0, convs, n, vecs, is_top);
  if (smem == 0) return cudaErrorInvalidValue;
  switch (kind) {
    case kStats: return occupancy(train_stats_kernel, smem, out);
    case kFinal: return occupancy(train_final_kernel<kStopNone>, smem, out);
    case kBwdTop: return occupancy(train_bwd_top_kernel, smem, out);
    case kBwd: return occupancy(train_bwd_kernel<kStopNone>, smem, out);
    default: return cudaErrorInvalidValue;
  }
}
