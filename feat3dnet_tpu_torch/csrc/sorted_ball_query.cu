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
// What bounds it on this card: the walk's latency, not bytes or flops. The
// sorted cloud is 16 B/point (4 MB at 262 144 points) and stays in L2; a
// centre's ball holds tens to hundreds of points but the blocks that may
// hold them are 256 points each, and every step of a warp's walk waits on
// a load and a ballot. So the work per centre (tests, merges) and the warps
// in flight per SM decide the time.
//
// What the design does about it:
//  * A grid of many waves. The hit mask (one row per tile of `tile`
//    centres, the tile's box against each block's box) stays a prefilter,
//    but each tile is served by several blocks of 4 warps, kCentres
//    consecutive centres each, so there are tile / kCentres times as many
//    blocks as tiles and a slow centre holds up only its own block. Fewer
//    centres a block balance better but repeat the block's set-up (the
//    hit list and its sort) more often: 8 a block was the best compromise
//    between the vendored clouds and a 262 144-point bucket, whose padding
//    tiles list about 250 blocks.
//  * A per-centre cull. Each block compacts its tile's hit row into shared
//    memory and sorts it by each block's smallest key (its first row, as
//    keys ascend within a block). A warp then tests its centre against 32
//    listed blocks at a time (one per lane, __ballot_sync) with the gap
//    expression of block_hitmask, the centre a box of zero size
//    (F3D_CULL_BLOCK, block_cull.cuh, which has the argument that it is
//    never stricter than the point test).
//  * Covered blocks. A block whose box lies wholly inside the ball (the
//    covered test of F3D_CULL_BLOCK) holds only in-ball points, so it
//    counts as `block` with no test and its first rows are its smallest
//    keys. Every padding block is covered for a padding centre, and once
//    its list is full the covered blocks of 32 listed ones count at once.
//  * A key-ordered walk with one merge per block. Blocks are visited in the
//    order of their smallest keys. The warp keeps the running top-ns keys
//    (and sorted rows) in shared memory. Per block it gathers the in-ball
//    keys, ascending, into a buffer of at most ns (cut at ns, or, once the
//    list is full, at the first key above the list's largest) and only
//    counts the rest (each lane its own in-ball points, summed once per
//    centre; kSteps steps of a block are loaded before the first is
//    tested); then it merges the buffer into the list
//    once: both are sorted, so each element's new place is its own rank
//    plus its rank in the other list (a binary search), written to the
//    other half of a ping-pong buffer. Once the list is full and a block's
//    smallest key exceeds its largest, that block and every later one only
//    count. The coordinates are gathered from the sorted rows at the end.
#include "block_cull.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCentres = 8;           // consecutive centres per block, 2 a warp
constexpr int kMinBlocks = 32 / kWarps;  // 32 warps per SM: at most 64 registers a thread
constexpr int kSteps = 4;             // 32-point steps of a block loaded at once
constexpr int kMaxNs = 64;
constexpr float kBigKey = 1.0e30f;

// One warp's lists, in shared memory: the running top-ns (ping-pong) and
// the current block's gathered candidates.
struct WarpBuf {
  int key[2][kMaxNs];
  int row[2][kMaxNs];
  int ckey[kMaxNs];
  int crow[kMaxNs];
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

size_t smem_bytes(int nb) {
  return sizeof(int) * 4 * static_cast<size_t>(nb) + sizeof(WarpBuf) * kWarps;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sorted_ball_query_kernel(const float4* __restrict__ pts4, const float4* __restrict__ bbox,
                         const uint8_t* __restrict__ hit, int nb, int block,
                         const float* __restrict__ centers, int m, int tile, float r2,
                         int ns, float4* __restrict__ top, int* __restrict__ cnt) {
  const int c0 = blockIdx.x * tile + blockIdx.y * kCentres;
  const int n_here = min(min(kCentres, tile - static_cast<int>(blockIdx.y) * kCentres), m - c0);
  if (n_here <= 0) return;                                   // uniform in the block

  extern __shared__ int smem_i[];
  int* lst = smem_i;                  // nb: the hit row compacted, block order
  int* lkey = lst + nb;               // nb: their smallest keys
  int* hits = lkey + nb;              // nb: the list sorted by smallest key
  int* hkey = hits + nb;              // nb: its keys
  WarpBuf* wb = reinterpret_cast<WarpBuf*>(hkey + nb);
  __shared__ int warp_count[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned full = 0xffffffffu;
  const unsigned lt_mask = (1u << lane) - 1u;
  const uint8_t* hit_row = hit + static_cast<size_t>(blockIdx.x) * nb;

  // ---- this tile's hit list, in block order: each thread takes a run of
  // consecutive entries, and a scan of the runs' counts places them --------
  const int per = (nb + kThreads - 1) / kThreads;
  const int j0 = min(t * per, nb), j1 = min(j0 + per, nb);
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += hit_row[j] != 0;
  int inc = mine;                                            // inclusive scan in the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(full, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) warp_count[warp] = inc;
  __syncthreads();
  int off = inc - mine, nh = 0;
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? warp_count[w] : 0;
    nh += warp_count[w];
  }
  for (int j = j0; j < j1; ++j) {
    if (hit_row[j] == 0) continue;
    lst[off] = j;
    lkey[off++] = __float2int_rn(pts4[static_cast<size_t>(j) * block].w);
  }
  __syncthreads();
  // ---- sorted by smallest key (unique keys: the rank is the place) ---------
  for (int j = t; j < nh; j += kThreads) {
    const int k = lkey[j];
    int r = 0;
    for (int i = 0; i < nh; ++i) r += lkey[i] < k;
    hits[r] = lst[j];
    hkey[r] = k;
  }
  __syncthreads();

  WarpBuf& buf = wb[warp];

  // ---- one warp per centre --------------------------------------------------
  for (int i = warp; i < n_here; i += kWarps) {
    const int c = c0 + i;
    const float cx = centers[3 * static_cast<size_t>(c)];
    const float cy = centers[3 * static_cast<size_t>(c) + 1];
    const float cz = centers[3 * static_cast<size_t>(c) + 2];
    int a = 0;              // entries in the running list
    int cur = 0;            // which half of the ping-pong buffer holds it
    int kmax = f3d::kIntMax;  // the list's largest key once it is full
    bool counting = false;  // the list is full and every later block only counts
    int own = 0;            // this lane's share of the in-ball count
    for (int h0 = 0; h0 < nh; h0 += 32) {
      // the per-centre cull and the covered test, one listed block per lane
      bool pass = false, cov = false;
      if (h0 + lane < nh) {
        const int b = hits[h0 + lane];
        const float4 lo = bbox[2 * static_cast<size_t>(b)];       // minx miny minz maxx
        const float4 hi = bbox[2 * static_cast<size_t>(b) + 1];   // maxy maxz 0 0
        F3D_CULL_BLOCK(cx, cy, cz, lo, hi, r2, pass, cov);
      }
      unsigned todo = __ballot_sync(full, pass);
      const unsigned covered = __ballot_sync(full, cov);
      while (todo) {
        int l = __ffs(todo) - 1;
        if (!counting && a == ns && hkey[h0 + l] > kmax) counting = true;
        if (counting) {         // this block and every later one only count
          if (lane == 0) own += __popc(todo & covered) * block;
          todo &= ~covered;
          if (todo == 0) break;
          l = __ffs(todo) - 1;
        }
        todo &= todo - 1;
        const int base_b = hits[h0 + l] * block;
        const bool is_cov = (covered >> l) & 1u;
        int nc = 0;             // candidates gathered from this block
        if (is_cov) {
          if (lane == 0) own += block;
          // every row is in the ball: its first rows are its smallest keys
          const int rows = min(ns, block);
          for (int q0 = 0; q0 < rows; q0 += 32) {
            const int q = q0 + lane;
            int key = 0;
            bool take = false;
            if (q < rows) {
              key = __float2int_rn(pts4[base_b + q].w);
              take = key < kmax;
            }
            const unsigned tb = __ballot_sync(full, take);
            if (take) { buf.ckey[q] = key; buf.crow[q] = base_b + q; }  // a prefix: q == its place
            nc += __popc(tb);
          }
        } else {
          bool gathering = !counting;
          const int end = base_b + block;
          for (int base0 = base_b; base0 < end; base0 += 32 * kSteps) {
            float4 pv[kSteps];                               // kSteps loads in flight
#pragma unroll
            for (int u = 0; u < kSteps; ++u)
              if (base0 + 32 * u < end) pv[u] = pts4[base0 + 32 * u + lane];
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
              const int base = base0 + 32 * u;
              if (base >= end) break;                        // uniform in the warp
              const float4 p = pv[u];
              const bool in = f3d::sqdist3(cx - p.x, cy - p.y, cz - p.z) < r2;
              own += in;
              if (!gathering) continue;                      // uniform in the warp
              const int key = __float2int_rn(p.w);
              const bool take = in && key < kmax;
              const unsigned tb = __ballot_sync(full, take);
              // candidates ascend with the lane
              const int pos = nc + __popc(tb & lt_mask);
              if (take && pos < ns) { buf.ckey[pos] = key; buf.crow[pos] = base + lane; }
              nc = min(nc + __popc(tb), ns);
              gathering = nc < ns && __shfl_sync(full, key, 31) < kmax;
            }
          }
        }
        if (nc == 0) continue;
        __syncwarp();
        const int nxt = cur ^ 1;
        for (int q = lane; q < a; q += 32) {                 // list entries move down
          const int k = buf.key[cur][q];
          const int pos = q + rank_below(buf.ckey, nc, k);
          if (pos < ns) { buf.key[nxt][pos] = k; buf.row[nxt][pos] = buf.row[cur][q]; }
        }
        for (int q = lane; q < nc; q += 32) {                // candidates slot in
          const int k = buf.ckey[q];
          const int pos = q + rank_below(buf.key[cur], a, k);
          if (pos < ns) { buf.key[nxt][pos] = k; buf.row[nxt][pos] = buf.crow[q]; }
        }
        __syncwarp();
        a = min(a + nc, ns);
        cur = nxt;
        if (a == ns) kmax = buf.key[cur][ns - 1];
      }
    }
    const int total = __reduce_add_sync(full, own);
    float4* out = top + static_cast<size_t>(c) * ns;
    for (int q = lane; q < ns; q += 32)
      out[q] = q < a ? pts4[buf.row[cur][q]] : make_float4(0.f, 0.f, 0.f, kBigKey);
    if (lane == 0) cnt[c] = total;
    __syncwarp();
  }
}

}  // namespace

// pts4 (np, 4) f32; blk_bbox (nb, 8) f32 rows [min xyz | max xyz | 0 0] of
// each block's points; hit (ceil(m / tile), nb) u8, the exact bbox cull per
// (tile, block); block: points per block (a multiple of 32); centers (m, 3)
// f32; top (m, ns, 4) f32; cnt (m,) int32.
F3D_EXPORT int f3d_sorted_ball_query(const float* pts4, const float* blk_bbox, int np,
                                     const uint8_t* hit, int nb, int block,
                                     const float* centers, int m, int tile, float r2, int ns,
                                     float* top, int* cnt, cudaStream_t stream) {
  if (ns < 1 || ns > kMaxNs || block < 32 || block % 32 || tile < 1 ||
      static_cast<long long>(nb) * block != np)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const long long tiles = (static_cast<long long>(m) + tile - 1) / tile;
  const long long parts = (static_cast<long long>(tile) + kCentres - 1) / kCentres;
  if (tiles > 0x7fffffffLL || parts > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nb);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(parts));
  sorted_ball_query_kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(pts4), reinterpret_cast<const float4*>(blk_bbox), hit,
      nb, block, centers, m, tile, r2, ns, reinterpret_cast<float4*>(top), cnt);
  return cudaGetLastError();
}

// K4's launch at nb blocks: out[0] its dynamic shared memory in bytes,
// out[1] the blocks of kThreads that fit on one SM.
F3D_EXPORT int f3d_sorted_ball_query_occupancy(int nb, int* out) {
  const size_t smem = smem_bytes(nb);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sorted_ball_query_kernel,
                                                      kThreads, smem);
  out[0] = static_cast<int>(smem);
  out[1] = blocks;
  return err;
}
