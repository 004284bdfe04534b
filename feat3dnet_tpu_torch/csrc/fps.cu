// Iterative farthest point sampling (K1).
//
// Replaces: feat3dnet_tpu/ops/fps.py:_fps_kernel (the Pallas kernel behind
// farthest_point_sample_pallas). Contract, index-exact: start at index 0;
// keep each point's running minimum squared distance to the chosen set
// (initial 1e38); the next centre is the argmax of that minimum, ties to
// the lowest index; points the mask excludes score -inf and are never
// chosen while a valid point remains (an all-masked cloud repeats index 0).
//
// What bounds it on this card: the npoint steps are a chain, and each step
// is a pass over the cloud (12 B of coordinates and a 4 B running minimum
// per point) followed by an argmax over all of it. For the path's clouds
// (4 096-31 000 points, 512 centres) a step moves a few hundred KB at most:
// its time is the latency of the pass, the reductions and the barriers,
// 511 times in a row. The operations and bytes bound (chip_smoke's) cannot
// see the chain.
//
// What the design does about it: one thread-block cluster per cloud
// (cudaLaunchKernelEx, up to 16 CTAs: a non-portable size), so a cloud
// spreads over several SMs and each CTA's share of a step is short.
//  * Each CTA loads its contiguous slice of the cloud into shared memory
//    once, as (x, y, z, running minimum), 16 B a point. A masked point's
//    running minimum starts at -inf, which fminf keeps, so its score is
//    -inf without reading the mask again. No step reads device memory.
//  * A step, per CTA: each thread passes over its points, kUnroll loads at
//    a time (sqdist3, fminf, f3d::argmax_better with the global index, as
//    one block did before); a warp argmax, then one over the warps, each
//    two warp reductions (__reduce_max_sync of an order-preserving key,
//    then __reduce_min_sync of the indices that hold it: argmax_better's
//    order without a chain of shuffles). Lane r of warp 0 then pushes the
//    CTA's winner (key, index, x, y, z) into rank r's inbox through
//    distributed shared memory and arrives on rank r's mbarrier (release,
//    cluster scope); inbox and barrier are double-buffered by the step's
//    parity. Every warp waits on its own CTA's barrier (acquire), reads the
//    csize entries from local shared memory (lane r rank r's) and reduces
//    them the same way, so every CTA holds the same winner and the next
//    step's coordinates with one trip between SMs a step. Rank 0 writes the
//    index. (A cluster barrier followed by every warp reading its peers'
//    slots cost more than the pass on the card: a peer's shared memory
//    serves its requests one at a time. The push takes one trip between
//    SMs where a barrier and a read took two.)
//  * The caller chooses the cluster size (ops/fps.py: from N). A slice
//    past shared memory (N > cluster x kMaxSlice) keeps its coordinates in
//    device memory and its running minimum in a scratch array the wrapper
//    allocates; the steps are the same.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kUnroll = 4;
constexpr float kInitDist = 1e38f;
// points of a slice in shared memory, 16 B each: 229 376 B, below the
// 232 448 B a block may opt into
constexpr int kMaxSlice = 14 * 1024;

// A CTA's winner of a step, as its peers read it: two loads.
struct alignas(16) Winner {
  float4 c;    // its x, y, z (w unused)
  unsigned k;  // order_key of its running minimum
  int i;       // its index; kIntMax for an empty slice
};

// A running minimum as an unsigned key in the same order: the values are
// +0, positive or -inf (squared distances and the masked start), never -0
// or NaN, so equal values have equal keys.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address `a` of this CTA's shared memory in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Writes a winner into a peer's shared memory, then arrives on the peer's
// barrier: the release orders the write before the arrival.
__device__ __forceinline__ void push_winner(uint32_t slot, uint32_t bar, float4 c, unsigned k,
                                            int i) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(slot), "f"(c.x), "f"(c.y), "f"(c.z), "f"(c.w) : "memory");
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};"
               :: "r"(slot + 16), "r"(k), "r"(static_cast<unsigned>(i)) : "memory");
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// The warp's argmax of (key, index) pairs: the largest key, ties to the
// lowest index (f3d::argmax_better's order), in two warp reductions. Every
// lane gets the result.
__device__ __forceinline__ void warp_argmax(unsigned& k, int& i) {
  const unsigned m = __reduce_max_sync(0xffffffffu, k);
  i = static_cast<int>(
      __reduce_min_sync(0xffffffffu, k == m ? static_cast<unsigned>(i) : 0xffffffffu));
  k = m;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
fps_cluster_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                   float* __restrict__ scratch, int n, int slice, int npoint,
                   int* __restrict__ out) {
  extern __shared__ float4 pts[];        // the slice: x, y, z, running minimum
  __shared__ Winner inbox[2][kMaxCluster];  // each rank's winner, by step parity
  __shared__ __align__(8) uint64_t full[2];  // completes when every rank's is in
  __shared__ unsigned red_k[kWarps];
  __shared__ int red_i[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned full_mask = 0xffffffffu;
  xyz += static_cast<size_t>(b) * n * 3;
  if (mask) mask += static_cast<size_t>(b) * n;
  out += static_cast<size_t>(b) * npoint;
  const int lo = min(rank * slice, n);
  const int cnt = min(lo + slice, n) - lo;
  const float* p = xyz + 3 * static_cast<size_t>(lo);
  float* mind = kSmem ? nullptr : scratch + static_cast<size_t>(b) * n + lo;

  for (int i = t; i < cnt; i += kThreads) {
    const float m0 = (mask == nullptr || mask[lo + i]) ? kInitDist : -INFINITY;
    if (kSmem)
      pts[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], m0);
    else
      mind[i] = m0;
  }
  float sx = xyz[0], sy = xyz[1], sz = xyz[2];
  if (t == 0) {
    if (rank == 0) out[0] = 0;
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_addr(&full[q])), "r"(csize) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();                        // every rank's barriers exist before a push

  for (int j = 1; j < npoint; ++j) {
    float bv = -INFINITY;
    int bi = f3d::kIntMax;
    int i = t;
    for (; i + (kUnroll - 1) * kThreads < cnt; i += kUnroll * kThreads) {
      float4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = i + u * kThreads;
        q[u] = kSmem ? pts[e] : make_float4(p[3 * e], p[3 * e + 1], p[3 * e + 2], mind[e]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = i + u * kThreads;
        const float md = fminf(q[u].w, f3d::sqdist3(q[u].x - sx, q[u].y - sy, q[u].z - sz));
        if (kSmem) pts[e].w = md; else mind[e] = md;
        if (f3d::argmax_better(md, lo + e, bv, bi)) { bv = md; bi = lo + e; }
      }
    }
    for (; i < cnt; i += kThreads) {
      const float4 q =
          kSmem ? pts[i] : make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], mind[i]);
      const float md = fminf(q.w, f3d::sqdist3(q.x - sx, q.y - sy, q.z - sz));
      if (kSmem) pts[i].w = md; else mind[i] = md;
      if (f3d::argmax_better(md, lo + i, bv, bi)) { bv = md; bi = lo + i; }
    }
    unsigned bk = order_key(bv);
    warp_argmax(bk, bi);
    if (lane == 0) { red_k[warp] = bk; red_i[warp] = bi; }
    __syncthreads();
    const int par = j & 1;
    if (warp == 0) {
      bk = lane < kWarps ? red_k[lane] : 0u;
      bi = lane < kWarps ? red_i[lane] : f3d::kIntMax;
      warp_argmax(bk, bi);
      if (lane < csize) {                // lane r pushes this CTA's winner to rank r
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
        if (bi != f3d::kIntMax) {                          // the slice holds a point
          const int k = bi - lo;
          if (kSmem) c = pts[k];
          else c = make_float4(p[3 * k], p[3 * k + 1], p[3 * k + 2], 0.f);
        }
        push_winner(peer_addr(smem_addr(&inbox[par][rank]), lane),
                    peer_addr(smem_addr(&full[par]), lane), c, bk, bi);
      }
    }
    // every warp: the cluster's winners, lane r rank r's, once all are in
    // (the barrier of this parity completes once per two steps)
    wait_phase(smem_addr(&full[par]), ((j - 1) >> 1) & 1);
    Winner w{make_float4(0.f, 0.f, 0.f, 0.f), 0u, f3d::kIntMax};
    if (lane < csize) w = inbox[par][lane];
    bk = w.k;
    bi = w.i;
    warp_argmax(bk, bi);
    // rank 0 holds point 0, so the winner is a point; its rank's entry has
    // its coordinates
    const int src = bi / slice;
    sx = __shfl_sync(full_mask, w.c.x, src);
    sy = __shfl_sync(full_mask, w.c.y, src);
    sz = __shfl_sync(full_mask, w.c.z, src);
    if (rank == 0 && t == 0) out[j] = bi;
  }
  cluster.sync();                        // no CTA leaves while a peer may push to it
}

template <bool kSmem>
cudaError_t configure(int cluster, int slice, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const size_t smem = kSmem ? sizeof(float4) * static_cast<size_t>(slice) : 0;
  cudaError_t err = cudaFuncSetAttribute(fps_cluster_kernel<kSmem>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fps_cluster_kernel<kSmem>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

bool valid_cluster(int cluster) {
  return cluster >= 1 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0;
}

}  // namespace

F3D_EXPORT const char* f3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest cloud whose slices fit in shared memory at this cluster size.
F3D_EXPORT int f3d_fps_max_smem_points(int cluster) {
  return valid_cluster(cluster) ? cluster * kMaxSlice : 0;
}

// xyz (b, n, 3) f32, mask (b, n) u8 or NULL, scratch (b, n) f32 (required
// when n > f3d_fps_max_smem_points(cluster), else ignored), cluster: CTAs
// per cloud (1, 2, 4, 8 or 16), out (b, npoint) int32.
F3D_EXPORT int f3d_fps(const float* xyz, const uint8_t* mask, float* scratch, int b, int n,
                       int npoint, int cluster, int* out, cudaStream_t stream) {
  if (b < 1 || b > 65535 || n < 1 || npoint < 1 || !valid_cluster(cluster))
    return cudaErrorInvalidValue;
  const int slice = (n + cluster - 1) / cluster;
  const bool smem = slice <= kMaxSlice;
  if (!smem && scratch == nullptr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(cluster, b);
  cfg.stream = stream;
  cudaError_t err = smem ? configure<true>(cluster, slice, &cfg, attr)
                         : configure<false>(cluster, slice, &cfg, attr);
  if (err != cudaSuccess) return err;
  err = smem ? cudaLaunchKernelEx(&cfg, fps_cluster_kernel<true>, xyz, mask, scratch, n, slice,
                                  npoint, out)
             : cudaLaunchKernelEx(&cfg, fps_cluster_kernel<false>, xyz, mask, scratch, n, slice,
                                  npoint, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K1's launch for clouds of n points at this cluster size: out[0] the
// dynamic shared memory of a CTA in bytes, out[1] the clusters that can be
// resident on the card at once (cudaOccupancyMaxActiveClusters).
F3D_EXPORT int f3d_fps_occupancy(int n, int cluster, int* out) {
  if (n < 1 || !valid_cluster(cluster)) return cudaErrorInvalidValue;
  const int slice = (n + cluster - 1) / cluster;
  const bool smem = slice <= kMaxSlice;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(cluster, 1);
  cudaError_t err = smem ? configure<true>(cluster, slice, &cfg, attr)
                         : configure<false>(cluster, slice, &cfg, attr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = smem ? cudaOccupancyMaxActiveClusters(&clusters, fps_cluster_kernel<true>, &cfg)
             : cudaOccupancyMaxActiveClusters(&clusters, fps_cluster_kernel<false>, &cfg);
  out[0] = static_cast<int>(cfg.dynamicSmemBytes);
  out[1] = clusters;
  return err;
}
