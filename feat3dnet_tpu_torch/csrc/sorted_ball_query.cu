// Morton-culled exact ball query on a sorted cloud (K4).
//
// Replaces: feat3dnet_tpu/ops/hash_grid.py:_bq_kernel_t_fori (the default
// form up to 131 072 points), _bq_kernel_t (the 2-D grid form above that),
// _bq_kernel (the row layout) and the hit-list pair _bq_csr_kernel /
// _bq_csr_kernel_t. All five compute the same thing; this one kernel walks
// a per-tile hit list, which is what the CSR pair did and what the grid
// forms' skip bits amount to.
// Contract (ops/hash_grid.py:sorted_ball_query_plain): pts4 (np, 4) rows
// [x y z key] in Morton-block order, keys the original indices (unique,
// ascending within a block); for each centre, the ns in-ball points
// (d2 < r2 strict, d2 = ((dx*dx) + dy*dy) + dz*dz without FMA) with the
// smallest keys, ascending, as rows [x y z key]; slots past the count are
// [0 0 0 1e30]; cnt = the true in-ball count over the whole cloud.
//
// What bounds it on this card: distance tests. A tile of centres visits
// every point of every block whose bounding box comes within r of the
// tile's box (an exact gap test in torch gives the hit mask), tens of
// blocks of 256 points for a 2 m ball in a lidar cloud, so a few thousand
// tests per centre. The sorted cloud is 16 B/point (4 MB at 262 144
// points) and stays in L2; each tile's blocks are read by its 8 warps and
// hit in L1.
//
// What the design does about it: one block of 256 threads per tile; it
// first compacts its row of the hit mask into a shared-memory list, in
// block order. Then one warp serves one centre at a time: 32 consecutive
// points per step, the in-ball lanes found with __ballot_sync. Morton order
// is not index order across blocks, so an early exit at ns hits would be
// wrong (most balls hold more than ns points): the warp keeps the running
// top-ns keys (and sorted rows) in shared memory and merges each step's
// candidates into it. Both lists are sorted, so every element's new place
// is its own rank plus its rank in the other list (a binary search); the
// merged list goes to the other half of a ping-pong buffer. A step whose
// smallest candidate exceeds a full list's largest key is skipped. The
// coordinates are gathered from the sorted rows once, at the end.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNs = 64;
constexpr float kBigKey = 1.0e30f;

struct WarpBuf {
  int key[2][kMaxNs];
  int row[2][kMaxNs];
  int ckey[32];
  int crow[32];
};

// Number of entries of the ascending list a[0..n) that are < v.
__device__ __forceinline__ int rank_below(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
sorted_ball_query_kernel(const float4* __restrict__ pts4, const uint8_t* __restrict__ hit,
                         int nb, int block, const float* __restrict__ centers, int m,
                         int tile, float r2, int ns, float4* __restrict__ top,
                         int* __restrict__ cnt) {
  extern __shared__ int smem_i[];
  int* hits = smem_i;                                        // nb entries
  __shared__ WarpBuf wb[kWarps];
  __shared__ int warp_count[kWarps];
  __shared__ int n_hits;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const uint8_t* hit_row = hit + static_cast<size_t>(blockIdx.x) * nb;

  // ---- this tile's hit list, in block order --------------------------------
  if (t == 0) n_hits = 0;
  __syncthreads();
  for (int j0 = 0; j0 < nb; j0 += kThreads) {
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
      for (int w = 0; w < kWarps; ++w) s += warp_count[w];
      n_hits += s;
    }
    __syncthreads();
  }
  const int nh = n_hits;
  WarpBuf& buf = wb[warp];

  // ---- one warp per centre --------------------------------------------------
  for (int i = warp; i < tile; i += kWarps) {
    const int c = blockIdx.x * tile + i;
    if (c >= m) break;                                       // uniform in the warp
    const float cx = centers[3 * static_cast<size_t>(c)];
    const float cy = centers[3 * static_cast<size_t>(c) + 1];
    const float cz = centers[3 * static_cast<size_t>(c) + 2];
    int a = 0;          // entries in the running list
    int cur = 0;        // which half of the ping-pong buffer holds it
    int total = 0;      // true in-ball count
    for (int h = 0; h < nh; ++h) {
      const int base_b = hits[h] * block;
      for (int base = base_b; base < base_b + block; base += 32) {
        const int row = base + lane;
        const float4 p = pts4[row];
        const bool in = f3d::sqdist3(cx - p.x, cy - p.y, cz - p.z) < r2;
        const unsigned bal = __ballot_sync(0xffffffffu, in);
        if (bal == 0u) continue;
        const int nc = __popc(bal);
        total += nc;
        const int key = __float2int_rn(p.w);
        // candidates ascend with the lane: the first in-ball lane is the smallest
        const int kmin = __shfl_sync(0xffffffffu, key, __ffs(bal) - 1);
        if (a == ns && kmin > buf.key[cur][ns - 1]) continue;
        if (in) {
          const int j = __popc(bal & lt_mask);
          buf.ckey[j] = key;
          buf.crow[j] = row;
        }
        __syncwarp();
        const int nxt = cur ^ 1;
        for (int q = lane; q < a; q += 32) {                 // list entries move down
          const int k = buf.key[cur][q];
          const int pos = q + rank_below(buf.ckey, nc, k);
          if (pos < ns) { buf.key[nxt][pos] = k; buf.row[nxt][pos] = buf.row[cur][q]; }
        }
        if (lane < nc) {                                     // candidates slot in
          const int k = buf.ckey[lane];
          const int pos = lane + rank_below(buf.key[cur], a, k);
          if (pos < ns) { buf.key[nxt][pos] = k; buf.row[nxt][pos] = buf.crow[lane]; }
        }
        __syncwarp();
        a = min(a + nc, ns);
        cur = nxt;
      }
    }
    float4* out = top + static_cast<size_t>(c) * ns;
    for (int q = lane; q < ns; q += 32)
      out[q] = q < a ? pts4[buf.row[cur][q]] : make_float4(0.f, 0.f, 0.f, kBigKey);
    if (lane == 0) cnt[c] = total;
    __syncwarp();
  }
}

}  // namespace

// pts4 (np, 4) f32; hit (ceil(m / tile), nb) u8, the exact bbox cull per
// (tile, block); block: points per block (a multiple of 32); centers (m, 3)
// f32; top (m, ns, 4) f32; cnt (m,) int32.
F3D_EXPORT int f3d_sorted_ball_query(const float* pts4, int np, const uint8_t* hit,
                                     int nb, int block, const float* centers, int m,
                                     int tile, float r2, int ns, float* top, int* cnt,
                                     cudaStream_t stream) {
  if (ns < 1 || ns > kMaxNs || block < 32 || block % 32 || tile < 1 ||
      static_cast<long long>(nb) * block != np)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const size_t smem = sizeof(int) * static_cast<size_t>(nb);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (m + tile - 1) / tile;
  sorted_ball_query_kernel<<<tiles, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(pts4), hit, nb, block, centers, m, tile, r2, ns,
      reinterpret_cast<float4*>(top), cnt);
  return cudaGetLastError();
}
