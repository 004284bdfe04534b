// Exact ball query (K2).
//
// Replaces: feat3dnet_tpu/ops/batch_group.py:_bq_batch_kernel (behind
// ball_query_fused), and is the port's ops.ball_query on CUDA tensors.
// Contract (feat3dnet_tpu/ops/neighborhoods.py:ball_query, scalar radius):
// for each centre, the first ns points in index order with d2 < r2
// (strict; d2 from coordinate differences, no FMA); cnt = min(count, ns);
// slots at or past cnt repeat the first in-ball index; an empty ball gets
// the centre's nearest valid point in every slot (first index on ties)
// with cnt 0; masked points are never selected. Indices are int32 end to
// end (the TPU kernel routed them through f32 matmuls, exact below 2^24).
//
// What bounds it on this card: a scan of the cloud per centre, 12 B of
// coordinates per point. All centres of one cloud read the same points, so
// the scan runs from L1/L2 and is bound by load and compare issue, not by
// device memory. A centre stops as soon as it holds ns points, so dense
// balls scan only a prefix; empty and sparse balls scan everything.
//
// What the design does about it: one warp per centre. The warp tests 32
// consecutive points per step, places hits with __ballot_sync and
// __popc(mask & lanemask_lt) (the prefix rank the TPU kernel built with
// triangular matmuls), and leaves the loop once it has ns hits. Each lane
// keeps its own nearest candidate, and a shuffle reduction picks the
// nearest only when the ball is empty.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  const uint8_t* __restrict__ mask, int b, int n, int m, float r2,
                  int ns, int* __restrict__ idx, int* __restrict__ cnt) {
  const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);  // centre
  const int lane = threadIdx.x & 31;
  if (g >= b * m) return;                       // uniform across the warp
  const int bi = g / m;
  const float* pts = xyz + static_cast<size_t>(bi) * n * 3;
  const uint8_t* mk = mask ? mask + static_cast<size_t>(bi) * n : nullptr;
  const float cx = centers[3 * static_cast<size_t>(g)];
  const float cy = centers[3 * static_cast<size_t>(g) + 1];
  const float cz = centers[3 * static_cast<size_t>(g) + 2];
  int* out = idx + static_cast<size_t>(g) * ns;
  const unsigned lt_mask = (1u << lane) - 1u;

  int count = 0, first = 0;
  float best_d = INFINITY;
  int best_i = f3d::kIntMax;
  for (int base = 0; base < n && count < ns; base += 32) {
    const int i = base + lane;
    bool in = false;
    if (i < n && (mk == nullptr || mk[i])) {
      const float d2 = f3d::sqdist3(cx - pts[3 * i], cy - pts[3 * i + 1],
                                    cz - pts[3 * i + 2]);
      in = d2 < r2;
      if (d2 < best_d) { best_d = d2; best_i = i; }   // i rises: first wins
    }
    const unsigned hits = __ballot_sync(0xffffffffu, in);
    if (count == 0 && hits) first = base + __ffs(hits) - 1;
    if (in) {
      const int pos = count + __popc(hits & lt_mask);
      if (pos < ns) out[pos] = i;
    }
    count += __popc(hits);
  }

  const int c = count < ns ? count : ns;
  int fill = first;
  if (c == 0) {
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (f3d::argmin_better(od, oi, best_d, best_i)) { best_d = od; best_i = oi; }
    }
    // no valid point at all: index 0, as argmin over all-inf gives
    fill = best_i == f3d::kIntMax ? 0 : best_i;
  }
  for (int s = c + lane; s < ns; s += 32) out[s] = fill;
  if (lane == 0) cnt[g] = c;
}

}  // namespace

// xyz (b, n, 3) f32, centers (b, m, 3) f32, mask (b, n) u8 or NULL,
// idx (b, m, ns) int32, cnt (b, m) int32.
F3D_EXPORT int f3d_ball_query(const float* xyz, const float* centers,
                              const uint8_t* mask, int b, int n, int m, float r2,
                              int ns, int* idx, int* cnt, cudaStream_t stream) {
  const long long centres = static_cast<long long>(b) * m;
  if (centres == 0) return cudaSuccess;
  const int blocks = static_cast<int>((centres + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ball_query_kernel<<<blocks, kThreads, 0, stream>>>(xyz, centers, mask, b, n, m,
                                                     r2, ns, idx, cnt);
  return cudaGetLastError();
}
