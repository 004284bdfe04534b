// Shared helpers for the feat3dnet_tpu_torch CUDA kernels.
//
// Distances are written with __fmul_rn/__fadd_rn so nvcc cannot contract
// them into FMAs: the reference computes ((dx*dx) + dy*dy) + dz*dz with a
// rounding after every product, and a contracted FMA rounds differently,
// which flips near-ties in FPS and points on a ball's boundary.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define F3D_EXPORT extern "C" __attribute__((visibility("default")))

namespace f3d {

constexpr int kIntMax = 0x7fffffff;

// ((dx*dx) + dy*dy) + dz*dz, rounded after every operation (no FMA).
__device__ __forceinline__ float sqdist3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) beats (bv, bi) for an argmax that breaks ties to the lowest index.
__device__ __forceinline__ bool argmax_better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// (v, i) beats (bv, bi) for an argmin that breaks ties to the lowest index.
__device__ __forceinline__ bool argmin_better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

}  // namespace f3d
