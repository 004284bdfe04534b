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
// What the design does about it: K6's per-slot layer. A block of 256
// threads walks its share of the clusters one at a time; a cluster's 64
// slots live in shared memory (the input of every recomputed conv and the
// pre-BN y of the convs the pass reads back). Each conv is a register-tiled
// product, each warp owning 8 slots and each lane up to 8 channels, summed
// in one fixed order by one device function that every pass calls, so the
// recompute is bit-identical across passes and the ReLU and tie masks
// agree. Elementwise steps round op by op (__fmul_rn, __fadd_rn); a thread's
// running per-channel sums are compensated (Kahan). dW is a
// second register-tiled product over the slots into the block's partial in
// device memory. Plain f32 FMA on the CUDA cores; tensor cores are later
// work.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 64;                 // slots per cluster in shared memory
constexpr int kRows = kSlots / kWarps;     // slots per warp (8)
constexpr int kMaxConvs = 8;
constexpr int kMaxC = 256;                 // widest conv input or output
constexpr int kX = 4;                      // x row stride in shared memory

struct Conv {
  int cin, cout, relu, poolcat;   // poolcat: the input is [o_prev | bcast slotmax(o_prev)]
  int w, wt, b, a, c;             // weight-buffer offsets (-1: not in this launch)
  int in_off, y_off;              // shared-memory offsets of the input rows and of y
};

struct Tower {
  int n;                          // convs this launch recomputes
  int ns, gp, g_total, cin0;
  int is_top;                     // K10: conv n-1 is the plan's last conv
  int mu, isig, m1, m2, ga, mu_p, isig_p;   // vector offsets (K9, K10)
  int vec_off;                    // shared memory: 2 * kMaxC + kThreads floats
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

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// y[r][c] = sum_k in[r][k] W[k][c] (+ bias[c]) for the 64 slot rows, k in
// order 0..cin-1, one fmaf chain per output. Warp w owns rows 8w..8w+7, lane
// l channels l + 32q (q < NQ). in: shared, row stride ld (multiple of 4,
// 16-byte aligned; columns cin..ld-1 are read but multiply nothing).
template <int NQ>
__device__ __forceinline__ void slot_conv(const float* __restrict__ in, int ld, int cin,
                                          const float* __restrict__ W, int cout,
                                          const float* __restrict__ bias,
                                          float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  float acc[kRows][NQ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[i][q] = 0.f;
  for (int k = 0; k < cin; k += 4) {
    float4 av[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      av[i] = *reinterpret_cast<const float4*>(in + (r0 + i) * ld + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (k + kk >= cin) break;
      float w[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = lane + 32 * q;
        w[q] = c < cout ? __ldg(W + (k + kk) * cout + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float v = lane_of(av[i], kk);
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[i][q] = fmaf(v, w[q], acc[i][q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = lane + 32 * q;
    if (c >= cout) continue;
    const float bc = bias ? __ldg(bias + c) : 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      y[(r0 + i) * cout + c] = bias ? __fadd_rn(acc[i][q], bc) : acc[i][q];
  }
}

__device__ void slot_conv_any(const float* in, int ld, int cin, const float* W, int cout,
                              const float* bias, float* y) {
  if (cout <= 32) slot_conv<1>(in, ld, cin, W, cout, bias, y);
  else if (cout <= 64) slot_conv<2>(in, ld, cin, W, cout, bias, y);
  else if (cout <= 128) slot_conv<4>(in, ld, cin, W, cout, bias, y);
  else slot_conv<8>(in, ld, cin, W, cout, bias, y);
}

// out[i][c] (= or +=) sum_{s < ns} h[s][i] d[s][c], i < cin, c < cout: warps
// take 8 rows i at a time, lanes the channels. out: the block's partial in
// device memory, owned element by element by one thread.
template <int NQ>
__device__ __forceinline__ void wgrad(const float* __restrict__ h, int ld, int cin,
                                      const float* __restrict__ d, int cout, int ns,
                                      float* __restrict__ out, bool first) {
  const int lane = threadIdx.x & 31;
  for (int i0 = (threadIdx.x >> 5) * kRows; i0 < cin; i0 += kWarps * kRows) {
    float acc[kRows][NQ];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[r][q] = 0.f;
    for (int s = 0; s < ns; ++s) {
      float av[kRows], bv[NQ];
#pragma unroll
      for (int r = 0; r < kRows; ++r) av[r] = i0 + r < cin ? h[s * ld + i0 + r] : 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = lane + 32 * q;
        bv[q] = c < cout ? d[s * cout + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r >= cin) break;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = lane + 32 * q;
        if (c >= cout) continue;
        float* p = out + static_cast<size_t>(i0 + r) * cout + c;
        *p = first ? acc[r][q] : *p + acc[r][q];
      }
    }
  }
}

__device__ void wgrad_any(const float* h, int ld, int cin, const float* d, int cout, int ns,
                          float* out, bool first) {
  if (cout <= 32) wgrad<1>(h, ld, cin, d, cout, ns, out, first);
  else if (cout <= 64) wgrad<2>(h, ld, cin, d, cout, ns, out, first);
  else if (cout <= 128) wgrad<4>(h, ld, cin, d, cout, ns, out, first);
  else wgrad<8>(h, ld, cin, d, cout, ns, out, first);
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

// Cluster g through convs 0..T.n-1: x into conv 0's input, then per conv its
// y, and for every conv but the last its output into the next conv's input
// (with the poolcat's broadcast half where the plan has one). Ends synced.
__device__ void recompute(const Tower& T, const float* __restrict__ x,
                          const float* __restrict__ wts, float* sm, int g) {
  float* in0 = sm + T.l[0].in_off;
  for (int e = threadIdx.x; e < kSlots * kX; e += kThreads) {
    const int s = e / kX, k = e % kX;
    in0[e] = (s < T.ns && k < T.cin0)
        ? __ldg(x + (static_cast<size_t>(s) * T.gp + g) * T.cin0 + k) : 0.f;
  }
  __syncthreads();
  for (int l = 0; l < T.n; ++l) {
    const Conv& L = T.l[l];
    float* y = sm + L.y_off;
    slot_conv_any(sm + L.in_off, l == 0 ? kX : L.cin, L.cin, wts + L.w, L.cout, wts + L.b, y);
    __syncthreads();
    if (l + 1 == T.n) break;
    const Conv& N = T.l[l + 1];
    float* nxt = sm + N.in_off;                     // row stride N.cin
    const int C = L.cout;
    for (int e = threadIdx.x; e < kSlots * C; e += kThreads) {
      const int s = e / C, c = e % C;
      nxt[s * N.cin + c] = act(fold(y[e], wts[L.a + c], wts[L.c + c]), L.relu);
    }
    __syncthreads();
    if (N.poolcat) {
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float m = nxt[c];
        for (int s = 1; s < T.ns; ++s) m = fmaxf(m, nxt[s * N.cin + c]);
        for (int s = 0; s < kSlots; ++s) nxt[s * N.cin + C + c] = m;
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

__global__ void __launch_bounds__(kThreads)
train_final_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   const __grid_constant__ Tower T, float* __restrict__ pooled) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Conv& L = T.l[T.n - 1];
  float* pool = sm + T.vec_off;
  for (int g = blockIdx.x; g < T.gp; g += gridDim.x) {
    recompute(T, x, wts, sm, g);
    pool_ties(L, wts, sm + L.y_off, T.ns, nullptr, pool, nullptr);
    for (int c = threadIdx.x; c < L.cout; c += kThreads)
      pooled[static_cast<size_t>(g) * L.cout + c] = pool[c];
    __syncthreads();
  }
}

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
  const Phase ph = phase_of(C);
  Kahan s1, s2;
  for (int g = blockIdx.x; g < T.gp; g += gridDim.x) {
    recompute(T, x, wts, sm, g);
    const float* y = sm + L.y_off;
    pool_ties(L, wts, y, T.ns, dpool + static_cast<size_t>(g) * C, pool, unit);
    __syncthreads();
    if (ph.on) {
      const int c = ph.c;
      const float a = wts[L.a + c], cc = wts[L.c + c];
      const float mu = wts[T.mu + c], isig = wts[T.isig + c];
      for (int s = ph.p; s < T.ns; s += ph.step) {
        const float yv = y[s * C + c];
        const float z = fold(yv, a, cc);
        const float d = act(z, L.relu) == pool[c] ? unit[c] : 0.f;
        const float dz = (L.relu && !(z > 0.f)) ? 0.f : d;
        s1.add(dz);
        s2.add(__fmul_rn(dz, __fmul_rn(__fsub_rn(yv, mu), isig)));
      }
    }
    __syncthreads();
  }
  float* red = sm + T.vec_off + 2 * kMaxC;
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * C;
  reduce_phases(ph.on ? s1.s : 0.f, C, red, out);
  reduce_phases(ph.on ? s2.s : 0.f, C, red, out + C);
}

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
  Kahan db, s1, s2;
  float* dw = dw_part + static_cast<size_t>(blockIdx.x) * L.cin * C;
  bool first = true;
  for (int g = blockIdx.x; g < T.gp; g += gridDim.x) {
    recompute(T, x, wts, sm, g);
    if (T.is_top) {
      pool_ties(L, wts, y, T.ns, reinterpret_cast<const float*>(src) + static_cast<size_t>(g) * C,
                pool, unit);
      __syncthreads();
    }
    // ---- dy = ga * ((dz - m1) - xhat * m2), zero on pad clusters and pad slots
    if (ph.on) {
      const int c = ph.c;
      const float a = wts[L.a + c], cc = wts[L.c + c];
      const float mu = wts[T.mu + c], isig = wts[T.isig + c];
      const float m1 = wts[T.m1 + c], m2 = wts[T.m2 + c], ga = wts[T.ga + c];
      const float valid = g < T.g_total ? 1.f : 0.f;
      for (int s = ph.p; s < kSlots; s += ph.step) {
        float* p = y + s * C + c;
        if (s >= T.ns) {
          *p = 0.f;
          continue;
        }
        const float yv = *p;
        const float z = fold(yv, a, cc);
        float d;
        if (T.is_top) d = act(z, L.relu) == pool[c] ? unit[c] : 0.f;
        else d = load_cot(src, src_bf16, (static_cast<size_t>(s) * T.gp + g) * C + c);
        const float dz = (L.relu && !(z > 0.f)) ? 0.f : d;
        const float xh = __fmul_rn(__fsub_rn(yv, mu), isig);
        const float t = __fsub_rn(__fsub_rn(dz, m1), __fmul_rn(xh, m2));
        const float dyv = __fmul_rn(__fmul_rn(ga, t), valid);
        *p = dyv;
        db.add(dyv);
      }
    }
    __syncthreads();
    // ---- dW_j += h^T dy
    wgrad_any(hin, j == 0 ? kX : L.cin, L.cin, y, C, T.ns, dw, first);
    first = false;
    __syncthreads();
    if (j == 0) {
      // ---- dx = dy W_0^T
      float* dx = reinterpret_cast<float*>(out);
      const float* W = wts + L.w;
      for (int e = threadIdx.x; e < T.ns * T.cin0; e += kThreads) {
        const int s = e / T.cin0, k = e % T.cin0;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc = fmaf(y[s * C + c], __ldg(W + k * C + c), acc);
        dx[(static_cast<size_t>(s) * T.gp + g) * T.cin0 + k] = acc;
      }
    } else {
      // ---- do_{j-1} = dy W_j^T (through the poolcat), rounded, and conv j-1's sums
      const Conv& P = T.l[j - 1];
      slot_conv_any(y, C, C, wts + L.wt, L.cin, nullptr, hin);
      __syncthreads();
      const float* yp = sm + P.y_off;
      if (L.poolcat) {
        pool_ties(P, wts, yp, T.ns, nullptr, pool, nullptr);
        for (int c = threadIdx.x; c < cp; c += kThreads) {
          float dp = hin[cp + c];
          for (int s = 1; s < T.ns; ++s) dp = __fadd_rn(dp, hin[s * L.cin + cp + c]);
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
          float d = hin[s * L.cin + c];
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
// input rows of every conv, y rows of the convs the pass reads back (the
// last; in K10 also the one before), one scratch y region for the rest,
// then the per-channel vectors. Returns the bytes, or 0 for a bad tower.
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
    L = Conv{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], 0, 0};
    const bool ok_in = l == 0 ? L.cin == cin0 : (L.cin % 4 == 0 && L.cin <= kMaxC);
    if (!ok_in || L.cout % 4 || L.cout < 4 || L.cout > kMaxC || (l == 0 && L.poolcat)) return 0;
    if (l > 0 && L.cin != (L.poolcat ? 2 : 1) * T->l[l - 1].cout) return 0;
    L.in_off = static_cast<int>(off);
    off += static_cast<size_t>(kSlots) * (l == 0 ? kX : L.cin);
  }
  int scratch = 0;
  for (int l = 0; l < n; ++l) {
    const bool kept = l == n - 1 || (kind == kBwd && l == n - 2);
    if (kept) {
      T->l[l].y_off = static_cast<int>(off);
      off += static_cast<size_t>(kSlots) * T->l[l].cout;
    } else if (T->l[l].cout > scratch) {
      scratch = T->l[l].cout;
    }
  }
  for (int l = 0; l < n; ++l)
    if (!(l == n - 1 || (kind == kBwd && l == n - 2))) T->l[l].y_off = static_cast<int>(off);
  off += static_cast<size_t>(kSlots) * scratch;
  T->vec_off = static_cast<int>(off);
  off += 2 * kMaxC + kThreads;
  return off * sizeof(float);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  Tower T;
  const size_t smem = make_tower(&T, kFinal, ns, gp, gp, cin0, convs, n, nullptr, 0);
  if (smem == 0 || nblk < 1) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(train_final_kernel, smem);
  if (err != cudaSuccess) return err;
  train_final_kernel<<<nblk, kThreads, smem, stream>>>(x, wts, T, pooled);
  return cudaGetLastError();
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
  Tower T;
  const size_t smem = make_tower(&T, kBwd, ns, gp, g_total, cin0, convs, n, vecs, is_top);
  if (smem == 0 || nblk < 1 || T.l[n - 1].wt < 0 || (n > 1 && bst_part == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(train_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  train_bwd_kernel<<<nblk, kThreads, smem, stream>>>(x, wts, T, src, src_bf16, dw_part, db_part,
                                                    out, out_bf16, bst_part);
  return cudaGetLastError();
}
