// Iterative farthest point sampling (K1).
//
// Replaces: feat3dnet_tpu/ops/fps.py:_fps_kernel (the Pallas kernel behind
// farthest_point_sample_pallas). Contract, index-exact: start at index 0;
// keep each point's running minimum squared distance to the chosen set
// (initial 1e38); the next centre is the argmax of that minimum, ties to
// the lowest index; points the mask excludes score -inf and are never
// chosen while a valid point remains.
//
// What bounds it on this card: the npoint steps are sequential, and each
// step is a pass over the cloud (12 B of coordinates and a 4 B running
// minimum per point) followed by a block-wide argmax. For the path's clouds
// (16k-31k points, 512 centres) that is latency: a few hundred KB per step
// from L2, two block barriers per step, and 511 steps in a row.
//
// What the design does about it: one block of 1024 threads per cloud. The
// running minimum lives in shared memory (up to ~56k points; a larger cloud
// falls back to a global scratch array the wrapper allocates), so the only
// device-memory traffic per step is the coordinate read, which stays
// L2-resident across steps. The argmax is a warp-shuffle reduction of
// (value, index) pairs, then one more across the 32 warps. A cloud uses one
// of the 132 SMs; spreading one cloud over several SMs needs a grid-wide
// barrier per step and is left to a later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kInitDist = 1e38f;
// dynamic shared memory for the running minimum, below the 227 KB opt-in cap
constexpr int kMaxSmemPoints = 56 * 1024;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
           float* __restrict__ scratch, int n, int npoint, int* __restrict__ out) {
  extern __shared__ float smem_mind[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int selected;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  xyz += static_cast<size_t>(b) * n * 3;
  if (mask) mask += static_cast<size_t>(b) * n;
  out += static_cast<size_t>(b) * npoint;
  float* mind = kSmem ? smem_mind : scratch + static_cast<size_t>(b) * n;

  for (int i = t; i < n; i += kThreads) mind[i] = kInitDist;
  if (t == 0) out[0] = 0;
  int last = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float sx = xyz[3 * last], sy = xyz[3 * last + 1], sz = xyz[3 * last + 2];
    float bv = -INFINITY;
    int bi = f3d::kIntMax;
    for (int i = t; i < n; i += kThreads) {
      const float d = f3d::sqdist3(xyz[3 * i] - sx, xyz[3 * i + 1] - sy,
                                   xyz[3 * i + 2] - sz);
      const float md = fminf(mind[i], d);
      mind[i] = md;
      const float score = (mask == nullptr || mask[i]) ? md : -INFINITY;
      if (f3d::argmax_better(score, i, bv, bi)) { bv = score; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (f3d::argmax_better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (f3d::argmax_better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) {
        // a cloud with no finite score left (all masked) repeats index 0,
        // as argmax over all -inf does in the reference
        selected = bi == f3d::kIntMax ? 0 : bi;
        out[j] = selected;
      }
    }
    __syncthreads();
    last = selected;
  }
}

}  // namespace

F3D_EXPORT const char* f3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

F3D_EXPORT int f3d_fps_max_smem_points() { return kMaxSmemPoints; }

// xyz (b, n, 3) f32, mask (b, n) u8 or NULL, scratch (b, n) f32 (required
// when n > kMaxSmemPoints, else ignored), out (b, npoint) int32.
F3D_EXPORT int f3d_fps(const float* xyz, const uint8_t* mask, float* scratch,
                       int b, int n, int npoint, int* out, cudaStream_t stream) {
  if (n <= kMaxSmemPoints) {
    const size_t smem = static_cast<size_t>(n) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fps_kernel<true><<<b, kThreads, smem, stream>>>(xyz, mask, nullptr, n, npoint, out);
  } else {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    fps_kernel<false><<<b, kThreads, 0, stream>>>(xyz, mask, scratch, n, npoint, out);
  }
  return cudaGetLastError();
}
