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

// Cache addressing of the attention kernels.  `rows(layer, b, hk)` gives a
// functor that maps a logical cache column c of one (layer, slot, KV head)
// to its physical row: the codes of column c sit at row * D, its scale at
// row.  The contiguous cache [L, B, Hkv, S, D] (scales [L, B, Hkv, S]) keeps
// a (layer, slot, head) run of S rows; the page pool [L, Hkv, P, ps, D]
// (scales [L, Hkv, P, 1, ps]) keeps a (layer, head) run of P * ps rows, in
// which logical block j of slot b is page table[b, j].  The kernels are
// templates over these two, so both do the same arithmetic in the same order.
struct ContigRows {
  size_t base;
  __device__ __forceinline__ size_t operator()(int c) const { return base + c; }
};

struct ContigCache {
  int B, Hkv, S;
  __device__ __forceinline__ ContigRows rows(int layer, int b, int hk) const {
    return {(((size_t)layer * B + b) * Hkv + hk) * S};
  }
};

struct PagedRows {
  size_t base;
  const int* table;  // this slot's row of the page table
  int ps, n_blocks;
  // Columns past the table's end (a prefill tile overhanging S) read a row
  // of the last block's page: in bounds, and masked by the caller.
  __device__ __forceinline__ size_t operator()(int c) const {
    const int blk = min(c / ps, n_blocks - 1);
    return base + (size_t)table[blk] * ps + c % ps;
  }
};

struct PagedCache {
  const int* tables;  // [B, n_blocks]
  int Hkv, P, ps, n_blocks;
  __device__ __forceinline__ PagedRows rows(int layer, int b, int hk) const {
    return {((size_t)layer * Hkv + hk) * P * ps, tables + (size_t)b * n_blocks,
            ps, n_blocks};
  }
};

}  // namespace nst
