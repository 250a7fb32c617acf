// Small device helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

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

// Element type of the cache rows: int8 codes with a bf16 or float32 scale
// per row (the quantized cache), or bf16 or float32 values with no scale.
// Float32 rows are read rounded to bf16 (`to_float`, `to_bf16`: round to
// nearest even, as the JAX kernels' `astype(bfloat16)` before both
// products), so every element type reaches the products as a bf16 value.  `Stage` is the type
// kernel B keeps V rows in shared memory as (the element itself, bf16 for
// float32).
template <class T>
struct KVElem;

template <>
struct KVElem<int8_t> {
  static constexpr bool kQuantized = true;
  using Stage = int8_t;
  static __device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
  static __device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) {
    return __float2bfloat16_rn((float)x);  // exact: |x| <= 127
  }
};

template <>
struct KVElem<__nv_bfloat16> {
  static constexpr bool kQuantized = false;
  using Stage = __nv_bfloat16;
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
    return x;
  }
};

template <>
struct KVElem<float> {
  static constexpr bool kQuantized = false;
  using Stage = __nv_bfloat16;
  static __device__ __forceinline__ float to_float(float x) {
    return round_bf16(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
    return __float2bfloat16_rn(x);
  }
};

// One load of VB bytes (16, or 8 for int8 rows whose length is not a
// multiple of 16 bytes): VB / sizeof(T) elements of a cache row.
template <class T, int VB>
struct RowChunk {
  using Raw = std::conditional_t<VB == 16, int4, int2>;
  Raw raw;
  __device__ __forceinline__ explicit RowChunk(const T* src)
      : raw(*reinterpret_cast<const Raw*>(src)) {}
  __device__ __forceinline__ T operator[](int j) const {
    return reinterpret_cast<const T*>(&raw)[j];
  }
};

// Copies one chunk of a cache row to `dst` in the element type's Stage
// type: as it is, or (float32) rounded to bf16.
template <class T, int VB>
__device__ __forceinline__ void stage_chunk(typename KVElem<T>::Stage* dst,
                                            const T* src) {
  const RowChunk<T, VB> x(src);
  if constexpr (std::is_same<typename KVElem<T>::Stage, T>::value) {
    *reinterpret_cast<typename RowChunk<T, VB>::Raw*>(dst) = x.raw;
  } else {
    static_assert(std::is_same<T, float>::value && VB == 16, "");
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]),
                           __floats2bfloat162_rn(x[2], x[3])};
    *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(h);
  }
}

// Scales of the int8 cache: bf16 (the default) or float32 values, read as
// float32 and written from the float32 scale the codes were computed
// against (rounded only for a bf16 copy).  `from_float` also writes the
// attention outputs, bf16 or float32, from the float32 accumulator.
__device__ __forceinline__ float scale_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float scale_to_float(float x) { return x; }

template <class SC>
__device__ __forceinline__ SC from_float(float x) {
  if constexpr (std::is_same<SC, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// grok's logit softcap, cap * tanh(s / cap), applied after the score scale
// and before ALiBi and the mask as the JAX kernels do: IEEE division and
// libdevice's tanhf (no fast-math approximations), as torch.tanh on the
// card computes the plain versions' softcap.
__device__ __forceinline__ float softcap_score(float s, float cap) {
  return cap * tanhf(s / cap);
}

// ALiBi bias of one score, added after the score scale and before the mask
// as the JAX kernels do: slope * (float(col) - float(pos)), rounded at the
// product and at the sum (no fused multiply-add, like the plain versions).
__device__ __forceinline__ float add_alibi(float s, float slope, int col,
                                           int pos) {
  return __fadd_rn(s, __fmul_rn(slope, (float)col - (float)pos));
}

// Cache addressing of the attention kernels.  `rows(layer, b, hk)` gives a
// functor that maps a logical cache column c of one (layer, slot, KV head)
// to its physical row: the codes of column c sit at row * D, its scale at
// row.  The contiguous cache [L, B, Hkv, S, D] (scales [L, B, Hkv, S]) keeps
// a (layer, slot, head) run of S rows; the page pool [L, Hkv, P, ps, D]
// (scales [L, Hkv, P, 1, ps]) keeps a (layer, head) run of P * ps rows, in
// which logical block j of slot b is page table[b, j].  Rows hold elements
// of any KVElem type (bf16 and float32 caches have no scales).  The kernels are
// templates over these two addressings and the element type, so paged and
// contiguous do the same arithmetic in the same order.
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
