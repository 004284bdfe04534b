// Exact ball query (K2).
//
// Replaces: feat3dnet_tpu/ops/batch_group.py:_bq_batch_kernel (behind
// ball_query_fused), and is the port's ops.ball_query on CUDA tensors.
// Contract (feat3dnet_tpu/ops/neighborhoods.py:ball_query, a scalar radius
// or a (B, M) radius per centre, QueryBallPoint2): for each centre, the
// first ns points in index order with d2 < r2
// (strict; d2 from coordinate differences, no FMA); cnt = min(count, ns);
// slots at or past cnt repeat the first in-ball index; an empty ball gets
// the centre's nearest valid point in every slot (first index on ties)
// with cnt 0; masked points are never selected. Indices are int32 end to
// end (the TPU kernel routed them through f32 matmuls, exact below 2^24).
//
// What bounds it on this card: a scan of the cloud per centre (8 flops a
// pair), which stops at the centre's ns-th hit. Lidar scan order spreads a
// ball's hits through the whole cloud, so most centres scan most of it.
// A warp a centre (this kernel's first design) made every centre a chain
// of N / 32 dependent steps, each three strided loads from L2 and a
// ballot: at 512 centres a cloud the chain, not the work, set the time,
// and every point was read once per centre.
//
// What the design does about it: a thread-block cluster of `cluster` CTAs
// (cudaLaunchKernelEx, up to 16: a non-portable size) serves a group of 32
// centres of one cloud, a lane a centre, and splits the cloud between its
// warps in index order.
//  * The scan runs in rounds of cluster x kWarps x kChunks chunks of 32
//    points. In a round warp v (rank x kWarps + warp) takes a contiguous run
//    of at most kChunks chunks, the runs rising with v. It stages its run in
//    shared memory as (x, y, z, 0), a masked point (or one past N) as
//    +inf, whose d2 is never < r2 nor a nearest; every load of the run is in
//    flight at once. Each lane then reads each point as a broadcast and
//    builds a 32-bit hit mask per chunk (sqdist3, d2 < r2), with the
//    chunk's smallest d2 (fminf) beside it.
//  * Placing the hits is the TPU kernel's chunked prefix rank, done with
//    counts: each warp's hit count per centre; warp 0 sums its CTA's and
//    pushes the 32 sums into every peer's inbox through distributed shared
//    memory, then arrives on the peer's mbarrier (release, cluster scope;
//    inbox and barrier double-buffered by the round's parity). Every warp
//    waits on its own CTA's barrier and forms its exclusive prefix (hits of
//    the rounds before, of the lower ranks, of its CTA's lower warps), then
//    writes its hits to slots prefix, prefix + 1, ... below ns, in index
//    order. A round in which every centre of the group reaches ns hits is
//    the last; the decision is the same in every CTA.
//  * The slot-0 writer keeps that index and fills the slots past the count.
//    An empty ball's nearest: each lane keeps its smallest d2 and the first
//    chunk that held it, finds the first index of that d2 in the chunk again
//    (from device memory, only for an empty ball), and the candidates are
//    reduced over the warps and the ranks with f3d::argmin_better.
//  * The caller chooses the cluster size (ops/batch_group.py: from B, M and
//    N, with kWarps, kChunks and kMaxCluster as f3d_ball_query_shape reports
//    them), so one cloud's 16 groups fill the card and a training batch of
//    288 groups runs 2 CTAs each. `stop` ends the kernel after the count or
//    the exchange (idx and cnt not written), for the time split.
//  * Per-centre radii (kPerCentre, f3d_ball_query_radii) come as the
//    caller's (b, m) radii: each live lane loads its own once, before the
//    scan, and squares it (__fmul_rn, the f32 square of JAX's jnp.square,
//    so a NaN or zero radius is an empty ball and a negative one its
//    absolute value). The scalar instantiation reads no radii and compares
//    with its constant-bank r2 (the caller's square). The per-centre one holds
//    r2 in a register through the scan; ptxas keeps both at 64 registers.
//    Kept live from the entry, the centre's 64-bit index g was then parked
//    in local memory (8 bytes stored and loaded a thread), so the
//    per-centre count's write forms g again from the block and the lane;
//    neither instantiation spills.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 8;     // a warp's 32-point chunks in a round, at most
constexpr int kMaxCluster = 16;

struct Nearest {               // the empty-ball reduction's candidates
  float d[kWarps][32];
  int i[kWarps][32];
  float bd[32];                // the CTA's, per centre
  int bi[32];
};

struct Smem {
  union {
    float4 pts[kWarps][kChunks * 32];  // each warp's staged run
    Nearest near;
  } u;
  unsigned hits[kWarps][kChunks][32];  // per warp, chunk and centre
  int wcnt[2][kWarps][32];             // per warp and centre, by round parity
  int inbox[2][kMaxCluster][32];       // per rank and centre, by round parity
  int btot[32];                        // this CTA's per centre, to push
  unsigned long long full[2];          // completes when every rank's sums are in
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address `a` of this CTA's shared memory in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

template <bool kPerCentre>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  const uint8_t* __restrict__ mask, const float* __restrict__ radii, int n, int m,
                  float r2, int ns, int stop, int* __restrict__ idx, int* __restrict__ cnt) {
  __shared__ Smem s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned all = 0xffffffffu;
  const int groups = (m + 31) / 32;                  // groups of a cloud
  const int group = blockIdx.x / csize;
  const int bi = group / groups;
  const int ci = (group % groups) * 32 + lane;       // this lane's centre in its cloud
  const bool live = ci < m;
  const size_t g = static_cast<size_t>(bi) * m + ci;
  xyz += static_cast<size_t>(bi) * n * 3;
  if (mask) mask += static_cast<size_t>(bi) * n;
  const float nan = __int_as_float(0x7fc00000);
  float cx = nan, cy = nan, cz = nan;                // a lane past m: no hits, no nearest
  if (live) {
    cx = centers[3 * g];
    cy = centers[3 * g + 1];
    cz = centers[3 * g + 2];
    if constexpr (kPerCentre) {
      const float r = radii[g];
      r2 = __fmul_rn(r, r);
    }
  }
  int* out = idx + g * ns;

  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_addr(&s.full[q])), "r"(csize) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every rank's barriers exist before the first push (waited in round 0)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  const int nchunks = (n + 31) / 32;
  const int nw = csize * kWarps;                     // warps of the cluster
  const int v = rank * kWarps + w;                   // this warp's place, in index order
  int base = 0;                  // the centre's hits in the rounds before
  float best_d = INFINITY;       // its smallest d2 in this warp's chunks
  int best_c = -1;               // and the first chunk that held it
  int first = -1;                // the index this lane wrote to slot 0
  for (int r = 0, q0 = 0; q0 < nchunks; ++r, q0 += nw * kChunks) {
    const int q = min(nw * kChunks, nchunks - q0);
    const int c0 = q0 + static_cast<int>((static_cast<long long>(v) * q) / nw);
    const int kc = q0 + static_cast<int>((static_cast<long long>(v + 1) * q) / nw) - c0;
    // stage the run: every load first, then the stores
    float4 st[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int p = (c0 + k) * 32 + lane;
      st[k] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      if (k < kc && p < n) {
        const float x = xyz[3 * p], y = xyz[3 * p + 1], z = xyz[3 * p + 2];
        if (mask == nullptr || mask[p]) st[k] = make_float4(x, y, z, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      if (k < kc) s.u.pts[w][k * 32 + lane] = st[k];
    __syncwarp();
    int count = 0;
    for (int k = 0; k < kc; ++k) {
      const float4* pk = &s.u.pts[w][k * 32];
      unsigned hm = 0u;
      float cmin = INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float4 p = pk[j];
        const float d2 = f3d::sqdist3(cx - p.x, cy - p.y, cz - p.z);
        if (d2 < r2) hm |= 1u << j;
        cmin = fminf(cmin, d2);
      }
      if (cmin < best_d) { best_d = cmin; best_c = c0 + k; }
      s.hits[w][k][lane] = hm;
      count += __popc(hm);
    }
    if (r == 0) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (stop == 1) {
      __syncwarp();
      continue;
    }
    const int par = r & 1;
    s.wcnt[par][w][lane] = count;
    __syncthreads();
    if (w == 0) {
      int t = 0;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) t += s.wcnt[par][x][lane];
      s.btot[lane] = t;
      __syncwarp();
      if (lane < csize) {                  // lane q pushes the 32 sums to rank q
        const uint32_t dst = peer_addr(smem_addr(&s.inbox[par][rank][0]), lane);
#pragma unroll
        for (int e = 0; e < 32; e += 4) {
          const int4 t4 = *reinterpret_cast<const int4*>(&s.btot[e]);
          asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};"
                       :: "r"(dst + 4 * e), "r"(t4.x), "r"(t4.y), "r"(t4.z), "r"(t4.w)
                       : "memory");
        }
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
                     :: "r"(peer_addr(smem_addr(&s.full[par]), lane)) : "memory");
      }
    }
    // the barrier of this parity completes once per two rounds
    wait_phase(smem_addr(&s.full[par]), (r >> 1) & 1);
    int pre = base, tot = 0;
    for (int x = 0; x < csize; ++x) {
      const int t = s.inbox[par][x][lane];
      tot += t;
      if (x < rank) pre += t;
    }
    for (int x = 0; x < w; ++x) pre += s.wcnt[par][x][lane];
    if (stop == 0 && live) {
      for (int k = 0; k < kc && pre < ns; ++k) {
        unsigned hm = s.hits[w][k][lane];
        while (hm != 0u && pre < ns) {
          const int i = (c0 + k) * 32 + __ffs(hm) - 1;
          hm &= hm - 1u;
          if (pre == 0) first = i;
          out[pre++] = i;
        }
      }
    }
    base += tot;
    __syncwarp();
    if (__all_sync(all, !live || base >= ns)) break;     // the same in every CTA
  }
  if (stop != 0) return;

  const int c = min(base, ns);
  if (first >= 0)
    for (int e = c; e < ns; ++e) out[e] = first;
  if (__any_sync(all, live && base == 0)) {              // an empty ball in the group
    float d = INFINITY;
    int i = f3d::kIntMax;
    if (live && base == 0 && best_c >= 0) {
      for (int j = 0; j < 32; ++j) {
        const int p = best_c * 32 + j;
        if (p < n && (mask == nullptr || mask[p]) &&
            f3d::sqdist3(cx - xyz[3 * p], cy - xyz[3 * p + 1], cz - xyz[3 * p + 2]) == best_d) {
          d = best_d;
          i = p;
          break;
        }
      }
    }
    // every warp is past its last read of the staged runs (the last round's
    // __syncthreads), so the union holds the candidates now
    s.u.near.d[w][lane] = d;
    s.u.near.i[w][lane] = i;
    __syncthreads();
    if (w == 0) {
      for (int x = 1; x < kWarps; ++x)
        if (f3d::argmin_better(s.u.near.d[x][lane], s.u.near.i[x][lane], d, i)) {
          d = s.u.near.d[x][lane];
          i = s.u.near.i[x][lane];
        }
      s.u.near.bd[lane] = d;
      s.u.near.bi[lane] = i;
    }
    cluster.sync();
    if (rank == 0 && w == 0 && live && base == 0) {
      for (int x = 1; x < csize; ++x) {
        const float od = *cluster.map_shared_rank(&s.u.near.bd[lane], x);
        const int oi = *cluster.map_shared_rank(&s.u.near.bi[lane], x);
        if (f3d::argmin_better(od, oi, d, i)) { d = od; i = oi; }
      }
      const int fill = i == f3d::kIntMax ? 0 : i;  // no valid point: index 0
      for (int e = 0; e < ns; ++e) out[e] = fill;
    }
    cluster.sync();                  // no CTA leaves while rank 0 reads its candidates
  }
  if (rank == 0 && w == 0 && live) {
    if constexpr (kPerCentre) {
      // g again, from special registers read anew (asm volatile): else the
      // compiler keeps g from the entry, and with r2 in a register through
      // the scan ptxas parks it in local memory
      unsigned bx, cs, ln;
      asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
      asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(cs));
      asm volatile("mov.u32 %0, %%laneid;" : "=r"(ln));
      const int grp = static_cast<int>(bx / cs);
      cnt[static_cast<size_t>(grp / groups) * m + (grp % groups) * 32 + static_cast<int>(ln)] = c;
    } else {
      cnt[g] = c;
    }
  }
}

bool valid_cluster(int cluster) {
  return cluster >= 1 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0;
}

template <bool kPerCentre>
cudaError_t configure(int cluster, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = 0;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(ball_query_kernel<kPerCentre>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <bool kPerCentre>
int launch(const float* xyz, const float* centers, const uint8_t* mask, const float* radii, int b,
           int n, int m, float r2, int ns, int cluster, int stop, int* idx, int* cnt,
           cudaStream_t stream) {
  if (b < 0 || m < 0 || n < 1 || ns < 1 || !valid_cluster(cluster) || stop < 0 || stop > 2)
    return cudaErrorInvalidValue;
  const long long ctas = static_cast<long long>(b) * ((m + 31) / 32) * cluster;
  if (ctas == 0) return cudaSuccess;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.stream = stream;
  cudaError_t err = configure<kPerCentre>(cluster, &cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, ball_query_kernel<kPerCentre>, xyz, centers, mask, radii, n, m,
                           r2, ns, stop, idx, cnt);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3) f32, centers (b, m, 3) f32, mask (b, n) u8 or NULL,
// cluster: CTAs a group of 32 centres (1, 2, 4, 8 or 16), stop: 0, or 1 / 2
// to end after the count / the exchange without writing, idx (b, m, ns)
// int32, cnt (b, m) int32.
F3D_EXPORT int f3d_ball_query(const float* xyz, const float* centers, const uint8_t* mask,
                              int b, int n, int m, float r2, int ns, int cluster, int stop,
                              int* idx, int* cnt, cudaStream_t stream) {
  return launch<false>(xyz, centers, mask, nullptr, b, n, m, r2, ns, cluster, stop, idx, cnt,
                       stream);
}

// As f3d_ball_query with a radius per centre: radii (b, m) f32, in place of
// r2.
F3D_EXPORT int f3d_ball_query_radii(const float* xyz, const float* centers,
                                    const uint8_t* mask, const float* radii, int b, int n, int m,
                                    int ns, int cluster, int stop, int* idx, int* cnt,
                                    cudaStream_t stream) {
  if (radii == nullptr && b > 0 && m > 0) return cudaErrorInvalidValue;
  return launch<true>(xyz, centers, mask, radii, b, n, m, 0.f, ns, cluster, stop, idx, cnt,
                      stream);
}

// K2's sizes, for the caller's choice of cluster size: out[0] kWarps (warps
// a CTA), out[1] kChunks (32-point chunks a warp takes per round, at most),
// out[2] kMaxCluster.
F3D_EXPORT void f3d_ball_query_shape(int* out) {
  out[0] = kWarps;
  out[1] = kChunks;
  out[2] = kMaxCluster;
}

// K2's launch at this cluster size (the scalar instantiation's; the
// per-centre one has the same shared memory): out[0] the static shared memory of a
// CTA in bytes, out[1] the CTAs resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[2] the clusters
// resident on the card (cudaOccupancyMaxActiveClusters).
F3D_EXPORT int f3d_ball_query_occupancy(int cluster, int* out) {
  if (!valid_cluster(cluster)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(cluster);
  cudaError_t err = configure<false>(cluster, &cfg, attr);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ball_query_kernel<false>);
  if (err != cudaSuccess) return err;
  int per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ball_query_kernel<false>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(&clusters, ball_query_kernel<false>, &cfg);
  out[0] = static_cast<int>(fa.sharedSizeBytes);
  out[1] = per_sm;
  out[2] = clusters;
  return err;
}
