// Radius-ball maximum of a per-point value on a sorted cloud (K5).
//
// Replaces: feat3dnet_tpu/ops/hash_grid.py:_ballmax_kernel_fori (the
// default form), _ballmax_kernel (the 2-D grid form for larger clouds) and
// _ballmax_csr_kernel (the hit-list variant); all three compute this.
// Contract (ops/hash_grid.py:ball_max_plain): for each centre, the max of
// values[j] over the sorted rows j with d2 < r2 (strict, d2 =
// ((dx*dx) + dy*dy) + dz*dz without FMA), starting from -1e30 for a real
// centre and +1e30 for an invalid or padding one (x >= 5e8). The NMS keeps
// a point iff its own value ties its ball's max. Values combine with
// fmaxf, which drops a NaN.
//
// What bounds it on this card: the walk's latency, as in K4: the
// cloud (16 B of coordinates and 4 B of value a point) stays in L2, the
// 0.5 m NMS ball holds a few points, and every step of a warp's walk waits
// on a load and a ballot. So the blocks each centre must test, and the
// warps in flight, decide the time.
//
// What the design does about it:
//  * A pre-pass (two small kernels). Per block of the cloud the maximum of
//    its values (fmaxf, as the walk combines them). Then per tile of `tile`
//    centres its box and its hit row: block j is listed iff its box comes
//    within r of the tile's box (block_hitmask's gap expression, never
//    stricter than the centres' own) and its maximum exceeds the smallest
//    start value of the tile's centres (-1e30 if one is real, else +1e30):
//    the TPU kernel's whole-block value skip (hash_grid.py:1178), once per
//    tile. A tile of padding centres lists nothing. On a union of clouds
//    (the batched extraction: equal clouds of whole tiles and blocks, keys
//    local to each) a tile lists only its own cloud's blocks, the TPU
//    kernels' `block_mask` (hash_grid.py:262-290); the walk reads only
//    listed blocks and the centre's own block, so each cloud's maxima are
//    its own run's.
//  * K4's launch: each tile served by several blocks of 4 warps,
//    kCentres consecutive centres a block, so the grid has many waves. Each
//    block compacts its tile's hit row into shared memory.
//  * K4's per-centre cull (block_cull.cuh), a listed block per lane, and
//    the value skip per centre. The running maximum is uniform in the warp.
//    A block whose maximum is <= it cannot raise it (fmaxf) and is not
//    tested. A block wholly inside the ball raises it by the block's
//    maximum, with no distance test. The others are scanned point by point.
//    When the centres are the sorted rows, the centre's own block (it holds
//    the centre) is visited first, so the running maximum starts high.
#include "block_cull.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCentres = 8;              // consecutive centres per block, 2 a warp
constexpr int kMinBlocks = 32 / kWarps;  // 32 warps per SM: at most 64 registers a thread
constexpr int kSteps = 4;                // 32-point steps of a block loaded at once
constexpr int kPrepThreads = 256;
constexpr float kBig = 1.0e30f;
constexpr float kRealCentre = 5.0e8f;    // x at or past this: an invalid or padding centre

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Centre c: row c of `centers`, or the sorted row c when `centers` is NULL.
__device__ __forceinline__ float3 load_centre(const float4* pts4, const float* centers,
                                              int c) {
  if (centers == nullptr) {
    const float4 p = pts4[c];
    return make_float3(p.x, p.y, p.z);
  }
  const size_t i = 3 * static_cast<size_t>(c);
  return make_float3(centers[i], centers[i + 1], centers[i + 2]);
}

// Pre-pass 1: blkmax[b] = the fmaxf of block b's values (-inf if all NaN).
__global__ void __launch_bounds__(kPrepThreads)
block_max_kernel(const float* __restrict__ values, int nb, int block,
                 float* __restrict__ blkmax) {
  const int b = blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
  if (b >= nb) return;                                       // uniform in the warp
  const int lane = threadIdx.x & 31;
  const float* v = values + static_cast<size_t>(b) * block;
  float m = -INFINITY;
  for (int i = lane; i < block; i += 32) m = fmaxf(m, v[i]);
  m = warp_max(m);
  if (lane == 0) blkmax[b] = m;
}

// Pre-pass 2: the hit row of one tile of centres (one block a tile).
// seg_centres / seg_blocks: centres and blocks per cloud of a union (0: one
// cloud); block j is listed only for a tile of its own cloud.
__global__ void __launch_bounds__(kPrepThreads)
tile_hit_kernel(const float4* __restrict__ pts4, const float* __restrict__ centers, int m,
                int tile, const float4* __restrict__ bbox, const float* __restrict__ blkmax,
                int nb, float r2, int seg_centres, int seg_blocks,
                uint8_t* __restrict__ hit) {
  __shared__ float part[6][kPrepThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = blockIdx.x * tile;
  const int n_here = min(tile, m - c0);
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  int real = 0;
  for (int i = t; i < n_here; i += kPrepThreads) {
    const float3 c = load_centre(pts4, centers, c0 + i);
    lo[0] = fminf(lo[0], c.x); lo[1] = fminf(lo[1], c.y); lo[2] = fminf(lo[2], c.z);
    hi[0] = fmaxf(hi[0], c.x); hi[1] = fmaxf(hi[1], c.y); hi[2] = fmaxf(hi[2], c.z);
    real |= !(c.x >= kRealCentre);
  }
  for (int d = 0; d < 3; ++d) {
    lo[d] = warp_min(lo[d]);
    hi[d] = warp_max(hi[d]);
  }
  if (lane == 0)
    for (int d = 0; d < 3; ++d) { part[d][warp] = lo[d]; part[3 + d][warp] = hi[d]; }
  real = __syncthreads_or(real);
  for (int w = 0; w < kPrepThreads / 32; ++w)
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], part[d][w]);
      hi[d] = fmaxf(hi[d], part[3 + d][w]);
    }
  const float start = real ? -kBig : kBig;   // the smallest start value in the tile
  uint8_t* row = hit + static_cast<size_t>(blockIdx.x) * nb;
  const int cloud = seg_centres > 0 ? c0 / seg_centres : 0;
  for (int j = t; j < nb; j += kPrepThreads) {
    if (seg_centres > 0 && j / seg_blocks != cloud) {
      row[j] = 0;
      continue;
    }
    const float4 bl = bbox[2 * static_cast<size_t>(j)];       // minx miny minz maxx
    const float4 bh = bbox[2 * static_cast<size_t>(j) + 1];   // maxy maxz 0 0
    const float gx = fmaxf(fmaxf(bl.x - hi[0], lo[0] - bl.w), 0.f);
    const float gy = fmaxf(fmaxf(bl.y - hi[1], lo[1] - bh.x), 0.f);
    const float gz = fmaxf(fmaxf(bl.z - hi[2], lo[2] - bh.y), 0.f);
    row[j] = f3d::sqdist3(gx, gy, gz) < r2 && blkmax[j] > start;
  }
}

// The maximum of `best` and the values of block b's points in the ball.
__device__ __forceinline__ float scan_block(const float4* __restrict__ pts4,
                                            const float* __restrict__ values, int b,
                                            int block, float cx, float cy, float cz,
                                            float r2, float best, int lane) {
  float acc = best;
  const int end = (b + 1) * block;
  for (int base0 = b * block; base0 < end; base0 += 32 * kSteps) {
    float4 pv[kSteps];                                       // kSteps loads in flight
    float vv[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (base0 + 32 * u < end) {
        pv[u] = pts4[base0 + 32 * u + lane];
        vv[u] = values[base0 + 32 * u + lane];
      }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (base0 + 32 * u >= end) break;                      // uniform in the warp
      if (f3d::sqdist3(cx - pv[u].x, cy - pv[u].y, cz - pv[u].z) < r2)
        acc = fmaxf(acc, vv[u]);
    }
  }
  return warp_max(acc);
}

size_t walk_smem_bytes(int nb) { return sizeof(int) * static_cast<size_t>(nb); }

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ball_max_walk_kernel(const float4* __restrict__ pts4, const float* __restrict__ values,
                     const float4* __restrict__ bbox, const float* __restrict__ blkmax,
                     const uint8_t* __restrict__ hit, int nb, int block,
                     const float* __restrict__ centers, int m, int tile, float r2,
                     float* __restrict__ out) {
  const int c0 = blockIdx.x * tile + blockIdx.y * kCentres;
  const int n_here = min(min(kCentres, tile - static_cast<int>(blockIdx.y) * kCentres), m - c0);
  if (n_here <= 0) return;                                   // uniform in the block

  extern __shared__ int lst[];        // nb: the tile's hit row compacted, block order
  __shared__ int warp_count[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned full = 0xffffffffu;
  const uint8_t* hit_row = hit + static_cast<size_t>(blockIdx.x) * nb;

  // ---- this tile's hit list: each thread takes a run of consecutive
  // entries, and a scan of the runs' counts places them -----------------------
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
  for (int j = j0; j < j1; ++j)
    if (hit_row[j] != 0) lst[off++] = j;
  __syncthreads();

  // ---- one warp per centre --------------------------------------------------
  for (int i = warp; i < n_here; i += kWarps) {
    const int c = c0 + i;
    const float3 ctr = load_centre(pts4, centers, c);
    const float cx = ctr.x, cy = ctr.y, cz = ctr.z;
    float best = cx >= kRealCentre ? kBig : -kBig;           // uniform in the warp
    int own = -1;
    if (centers == nullptr) {                                // the centre's own block first
      own = c / block;
      const float bm = blkmax[own];
      if (bm > best) {
        const float4 lo = bbox[2 * static_cast<size_t>(own)];
        const float4 hi = bbox[2 * static_cast<size_t>(own) + 1];
        bool pass, cov;
        F3D_CULL_BLOCK(cx, cy, cz, lo, hi, r2, pass, cov);
        best = cov ? bm : scan_block(pts4, values, own, block, cx, cy, cz, r2, best, lane);
      }
    }
    for (int h0 = 0; h0 < nh; h0 += 32) {
      // the value skip, the per-centre cull and the covered test, a block a lane
      bool pass = false, cov = false;
      float bm = -INFINITY;
      if (h0 + lane < nh) {
        const int b = lst[h0 + lane];
        bm = blkmax[b];
        if (b != own && bm > best) {
          const float4 lo = bbox[2 * static_cast<size_t>(b)];
          const float4 hi = bbox[2 * static_cast<size_t>(b) + 1];
          F3D_CULL_BLOCK(cx, cy, cz, lo, hi, r2, pass, cov);
        }
      }
      best = fmaxf(best, warp_max(cov ? bm : -INFINITY));    // covered blocks: no test
      unsigned todo = __ballot_sync(full, pass && !cov && bm > best);
      while (todo) {
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        if (__shfl_sync(full, bm, l) <= best) continue;      // uniform: skipped by value
        best = scan_block(pts4, values, lst[h0 + l], block, cx, cy, cz, r2, best, lane);
      }
    }
    if (lane == 0) out[c] = best;
  }
}

}  // namespace

// pts4 (np, 4) f32 (column 3 unused); values (np,) f32 per sorted row;
// blk_bbox (nb, 8) f32 rows [min xyz | max xyz | 0 0] of each block's
// points (np / nb a multiple of 32); centers (m, 3) f32, or NULL for every
// sorted row (m == np); tile: centres per row of the hit mask; hit
// (ceil(m / tile), nb) u8 and blkmax (nb,) f32: the pre-pass's scratch;
// out (m,). seg_centres, seg_blocks: the centres and blocks of each cloud of
// a union (seg_centres a multiple of tile, the same number of clouds for
// both), or 0, 0 for one cloud. stage 0 runs both parts; 1 the pre-pass
// alone, 2 the walk alone on an earlier pre-pass's hit and blkmax (the time
// split).
F3D_EXPORT int f3d_ball_max(const float* pts4, const float* values, int np,
                            const float* blk_bbox, int nb, const float* centers, int m,
                            int tile, float r2, uint8_t* hit, float* blkmax, float* out,
                            int seg_centres, int seg_blocks, int stage,
                            cudaStream_t stream) {
  if (nb < 1 || np % nb || (np / nb) % 32 || tile < 1 || stage < 0 || stage > 2 ||
      (centers == nullptr && m != np))
    return cudaErrorInvalidValue;
  if (seg_centres != 0 &&
      (seg_centres < 0 || seg_blocks < 1 || seg_centres % tile || m % seg_centres ||
       nb % seg_blocks || m / seg_centres != nb / seg_blocks))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const int block = np / nb;
  const long long tiles = (static_cast<long long>(m) + tile - 1) / tile;
  const long long parts = (static_cast<long long>(tile) + kCentres - 1) / kCentres;
  if (tiles > 0x7fffffffLL || parts > 65535) return cudaErrorInvalidValue;
  const float4* p4 = reinterpret_cast<const float4*>(pts4);
  const float4* box = reinterpret_cast<const float4*>(blk_bbox);
  if (stage != 2) {
    const int per_block = kPrepThreads / 32;
    block_max_kernel<<<(nb + per_block - 1) / per_block, kPrepThreads, 0, stream>>>(
        values, nb, block, blkmax);
    tile_hit_kernel<<<static_cast<unsigned>(tiles), kPrepThreads, 0, stream>>>(
        p4, centers, m, tile, box, blkmax, nb, r2, seg_centres, seg_blocks, hit);
  }
  if (stage != 1) {
    const size_t smem = walk_smem_bytes(nb);
    cudaError_t err = cudaFuncSetAttribute(
        ball_max_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(parts));
    ball_max_walk_kernel<<<grid, kThreads, smem, stream>>>(
        p4, values, box, blkmax, hit, nb, block, centers, m, tile, r2, out);
  }
  return cudaGetLastError();
}

// K5's walk at nb blocks: out[0] its dynamic shared memory in bytes, out[1]
// the blocks of kThreads that fit on one SM.
F3D_EXPORT int f3d_ball_max_occupancy(int nb, int* out) {
  const size_t smem = walk_smem_bytes(nb);
  cudaError_t err = cudaFuncSetAttribute(
      ball_max_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ball_max_walk_kernel,
                                                      kThreads, smem);
  out[0] = static_cast<int>(smem);
  out[1] = blocks;
  return err;
}
