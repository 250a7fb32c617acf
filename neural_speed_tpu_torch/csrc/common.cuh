// Small device helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace nst {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum / max over a block of `NW` warps; `sh` holds NW floats.  Every thread
// gets the result.  Contains two __syncthreads().
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* sh) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) t += sh[i];
  __syncthreads();
  return t;
}

template <int NW>
__device__ __forceinline__ float block_max(float v, float* sh) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float t = -FLT_MAX;
#pragma unroll
  for (int i = 0; i < NW; ++i) t = fmaxf(t, sh[i]);
  __syncthreads();
  return t;
}

// float -> bf16 -> float (round to nearest even), as a cast to bf16 does.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace nst
