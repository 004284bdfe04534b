// Radius-ball maximum of a per-point value on a sorted cloud (K5).
//
// Replaces: feat3dnet_tpu/ops/hash_grid.py:_ballmax_kernel_fori (the
// default form), _ballmax_kernel (the 2-D grid form for larger clouds) and
// _ballmax_csr_kernel (the hit-list variant); all three compute this.
// Contract (ops/hash_grid.py:ball_max_plain): for each centre, the max of
// values[j] over the sorted rows j with d2 < r2 (strict, d2 =
// ((dx*dx) + dy*dy) + dz*dz without FMA), starting from -1e30 for a real
// centre and +1e30 for an invalid or padding one (x >= 5e8). The NMS keeps
// a point iff its own value ties its ball's max.
//
// What bounds it on this card: distance tests again, fewer than K4's: the
// NMS radius (0.5 m) is a quarter of the grouping radius, so a tile's hit
// list is short. 16 B of coordinates and 4 B of value per point, all in L2.
//
// What the design does about it: one block per tile of centres, one thread
// per centre, the tile's row of the hit mask compacted into a shared list
// as in K4. Each hit block is staged once in shared memory as
// (x, y, z, value) and every thread of the tile scans it from there, so a
// point is read from L2 once per tile. There is no whole-block value skip
// (the TPU kernel's optional shortcut); it would not change a result.
#include "common.cuh"

namespace {

constexpr int kMaxTile = 512;
constexpr float kBig = 1.0e30f;

__global__ void __launch_bounds__(kMaxTile)
ball_max_kernel(const float4* __restrict__ pts4, const float* __restrict__ values,
                const uint8_t* __restrict__ hit, int nb, int block,
                const float* __restrict__ centers, int m, float r2,
                float* __restrict__ out) {
  extern __shared__ float4 stage[];                  // blockDim.x points
  int* hits = reinterpret_cast<int*>(stage + blockDim.x);   // nb entries
  __shared__ int warp_count[kMaxTile / 32];
  __shared__ int n_hits;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const uint8_t* hit_row = hit + static_cast<size_t>(blockIdx.x) * nb;

  if (t == 0) n_hits = 0;
  __syncthreads();
  for (int j0 = 0; j0 < nb; j0 += blockDim.x) {
    const int j = j0 + t;
    const bool h = j < nb && hit_row[j] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, h);
    if (lane == 0) warp_count[warp] = __popc(bal);
    __syncthreads();
    int off = n_hits;
    for (int w = 0; w < warp; ++w) off += warp_count[w];
    if (h) hits[off + __popc(bal & lt_mask)] = j;
    __syncthreads();
    if (t == 0) {
      int s = 0;
      for (int w = 0; w < n_warps; ++w) s += warp_count[w];
      n_hits += s;
    }
    __syncthreads();
  }
  const int nh = n_hits;

  const int c = blockIdx.x * blockDim.x + t;
  float cx = 2.0e9f, cy = 2.0e9f, cz = 2.0e9f;
  if (c < m) {
    cx = centers[3 * static_cast<size_t>(c)];
    cy = centers[3 * static_cast<size_t>(c) + 1];
    cz = centers[3 * static_cast<size_t>(c) + 2];
  }
  float best = cx >= 5.0e8f ? kBig : -kBig;

  for (int h = 0; h < nh; ++h) {
    const int base_b = hits[h] * block;
    for (int base = base_b; base < base_b + block; base += blockDim.x) {
      const int n_here = min(static_cast<int>(blockDim.x), base_b + block - base);
      if (t < n_here) {
        float4 p = pts4[base + t];
        p.w = values[base + t];
        stage[t] = p;
      }
      __syncthreads();
      for (int k = 0; k < n_here; ++k) {
        const float4 p = stage[k];
        if (f3d::sqdist3(cx - p.x, cy - p.y, cz - p.z) < r2) best = fmaxf(best, p.w);
      }
      __syncthreads();
    }
  }
  if (c < m) out[c] = best;
}

}  // namespace

// pts4 (np, 4) f32 (column 3 unused); values (np,) f32 per sorted row;
// hit (ceil(m / tile), nb) u8; block: points per block; centers (m, 3) f32;
// tile: centres per block of threads (a multiple of 32, <= 512); out (m,).
F3D_EXPORT int f3d_ball_max(const float* pts4, const float* values, int np,
                            const uint8_t* hit, int nb, int block, const float* centers,
                            int m, int tile, float r2, float* out, cudaStream_t stream) {
  if (tile < 32 || tile > kMaxTile || tile % 32 || block < 1 ||
      static_cast<long long>(nb) * block != np)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const size_t smem = sizeof(float4) * tile + sizeof(int) * static_cast<size_t>(nb);
  cudaError_t err = cudaFuncSetAttribute(
      ball_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (m + tile - 1) / tile;
  ball_max_kernel<<<tiles, tile, smem, stream>>>(
      reinterpret_cast<const float4*>(pts4), values, hit, nb, block, centers, m, r2, out);
  return cudaGetLastError();
}
