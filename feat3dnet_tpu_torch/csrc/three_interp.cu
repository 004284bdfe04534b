// Three-nearest-neighbour inverse-distance interpolation (K11), the
// feature propagation of PointNet++ (Qi et al., arXiv:1706.02413).
//
// Replaces: feat3dnet_tpu/ops/ has no counterpart. The JAX package runs
// 3DFeat-Net alone, which never interpolates; the port added PointNet++
// MSG (models/pointnet2.py), whose four FP levels each bring a coarse
// level's C-wide features onto the finer level's points.
//
// Contract, against ops/interpolate.py's plain twin: for each unknown point
// u of cloud b, the 3 known points of the smallest squared distance
// ((dx*dx) + dy*dy) + dz*dz (dx = u - k, rounded after every operation),
// ties to the lower index (a stable sort's order); their distances
// d_i = sqrt(d2_i), r_i = 1 / (d_i + 1e-8), w_i = r_i / ((r_0 + r_1) + r_2);
// out[b, u, :] = (w_0 f[i_0] + w_1 f[i_1]) + w_2 f[i_2], every operation
// rounded to nearest (no FMA), so the kernel reproduces the plain twin's
// arithmetic. It also writes the three indices and weights.
//
// What bounds it on this card: the search is n x m pairs at 8 flops each
// (16 384 x 4 096 a cloud at the finest level: 5.4e8 flops, 1.1 us at the
// tensor cores' peak, 8 us at f32's), the sum 6 C flops a point; the bytes
// are the C-wide output written once (16.8 MB a cloud at C 256) and the
// known features read once (4.2 MB): about 6 us a cloud at 3.35 TB/s. Its
// time on the card is the search's instruction issue (compares and selects
// beside the 8 flops) and, for the small levels, the launch.
//
// What the design does about it: a thread per unknown point, 256 a block,
// grid (ceil(n / 256), B). The block stages the cloud's known points in
// shared memory in tiles of 1 024 (float4, 16 KB); every thread walks the
// tile from the same address at the same time (a broadcast, no bank
// conflict), keeping its best three in registers. The block then writes
// its rows' indices and weights to shared memory and computes the weighted
// sum with a warp per row and its lanes along the channels, so the three
// known rows are read and the output row written coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
three_interp_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                    const float* __restrict__ feats, int n, int m, int c,
                    float* __restrict__ out, int* __restrict__ idx_out,
                    float* __restrict__ w_out) {
  __shared__ float4 tile[kTile];
  __shared__ int s_idx[kThreads * 3];
  __shared__ float s_w[kThreads * 3];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;
  const bool live = p < n;
  float ux = 0.f, uy = 0.f, uz = 0.f;
  if (live) {
    const float* u = unknown + (static_cast<size_t>(b) * n + p) * 3;
    ux = u[0];
    uy = u[1];
    uz = u[2];
  }
  float d0 = __int_as_float(0x7f800000), d1 = d0, d2 = d0;
  int i0 = 0, i1 = 0, i2 = 0;
  const float* kb = known + static_cast<size_t>(b) * m * 3;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* q = kb + static_cast<size_t>(t0 + j) * 3;
      tile[j] = make_float4(q[0], q[1], q[2], 0.f);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 q = tile[j];
      const float d = f3d::sqdist3(ux - q.x, uy - q.y, uz - q.z);
      // strict compares: a later index never displaces an equal distance
      if (d < d2) {
        const int k = t0 + j;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = k;
          } else {
            d1 = d;
            i1 = k;
          }
        } else {
          d2 = d;
          i2 = k;
        }
      }
    }
  }
  if (live) {
    const float r0 = __frcp_rn(__fadd_rn(__fsqrt_rn(d0), 1e-8f));
    const float r1 = __frcp_rn(__fadd_rn(__fsqrt_rn(d1), 1e-8f));
    const float r2 = __frcp_rn(__fadd_rn(__fsqrt_rn(d2), 1e-8f));
    const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
    const float w0 = __fdiv_rn(r0, norm), w1 = __fdiv_rn(r1, norm), w2 = __fdiv_rn(r2, norm);
    const size_t o = (static_cast<size_t>(b) * n + p) * 3;
    idx_out[o] = i0;
    idx_out[o + 1] = i1;
    idx_out[o + 2] = i2;
    w_out[o] = w0;
    w_out[o + 1] = w1;
    w_out[o + 2] = w2;
    const int s = threadIdx.x * 3;
    s_idx[s] = i0;
    s_idx[s + 1] = i1;
    s_idx[s + 2] = i2;
    s_w[s] = w0;
    s_w[s + 1] = w1;
    s_w[s + 2] = w2;
  }
  __syncthreads();

  const int rows = min(kThreads, n - p0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* fb = feats + static_cast<size_t>(b) * m * c;
  for (int r = warp; r < rows; r += kWarps) {
    const float* f0 = fb + static_cast<size_t>(s_idx[3 * r]) * c;
    const float* f1 = fb + static_cast<size_t>(s_idx[3 * r + 1]) * c;
    const float* f2 = fb + static_cast<size_t>(s_idx[3 * r + 2]) * c;
    const float w0 = s_w[3 * r], w1 = s_w[3 * r + 1], w2 = s_w[3 * r + 2];
    float* o = out + (static_cast<size_t>(b) * n + p0 + r) * c;
    for (int ch = lane; ch < c; ch += 32) {
      o[ch] = __fadd_rn(__fadd_rn(__fmul_rn(w0, f0[ch]), __fmul_rn(w1, f1[ch])),
                        __fmul_rn(w2, f2[ch]));
    }
  }
}

}  // namespace

// unknown (b, n, 3), known (b, m, 3), feats (b, m, c) f32, contiguous;
// out (b, n, c) f32, idx (b, n, 3) int32, w (b, n, 3) f32. m >= 3 (the
// wrapper checks).
F3D_EXPORT int f3d_three_interp(const float* unknown, const float* known, const float* feats,
                                int b, int n, int m, int c, float* out, int* idx, float* w,
                                cudaStream_t stream) {
  if (b > 0 && n > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, b);
    three_interp_kernel<<<grid, kThreads, 0, stream>>>(unknown, known, feats, n, m, c, out,
                                                       idx, w);
  }
  return static_cast<int>(cudaGetLastError());
}
