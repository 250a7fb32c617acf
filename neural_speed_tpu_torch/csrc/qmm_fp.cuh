// Float-compute dequant-matmul templates shared by kernel F (qmatmul_lut.cu),
// kernel P (qmatmul_planar.cuh: its one-plane INT instances also take the
// packs of _gemm_kernel_int that kernel A does not) and their grouped MoE
// instances (qmatmul_grouped_fp.cuh): out[M, N] = x[M, K] @ W, bf16 in and
// out (float32 out for the grouped instances), or float32 in and out (the
// `_f32` entries: the JAX kernels' float32-activation branch, quantized
// Whisper's path).
//
// W is the JAX package's planar pack, read as stored.  A plane of width w
// packs e = 32 / w K sub-bands per uint32 word: word [r, n] of that plane
// carries the codes of rows r + i * (K / e), i = 0..e-1, at bits w*i.  The
// planes of one tensor have different band strides (K/8, K/16, K/32), so the
// bits of one weight sit in words at unrelated rows.  Both routes walk K in
// the order of the narrowest plane (EF bands, KW = K / EF rows): for its word
// row r and band b, k = b * KW + r, and a plane with e_p bands holds that
// weight in word row (b % q) * KW + r, band b / q, q = EF / e_p.  One row r
// therefore needs q words of each wider plane, every bit of which is used:
// the packed bytes are read exactly once.
//
// Formats (template parameter FMT):
//   LUT4           one 4-bit plane, value = table[code] * s  (kernel F)
//   INT1           one 1-bit plane (32 bands), value = s * (2 * code - 1)
//                  whatever the zero points (the port's dequantize)
//   INT2 .. INT7   4/2/1-bit planes, most significant first (INT2 and INT4
//                  one plane); value = s * (code - offset), s * (code -
//                  zp[g, n]) (uint8 zero points) or code * s + m[g, n]
//                  (float offsets, the ggml convention: no scale on the
//                  offset)
//   INT8           one byte per weight ([K, N] rows, read as FP8's), the
//                  same three zero-point rules
//   E4M3, E5M2     one byte per weight, value = float(fp8) * s, converted
//                  with cuda_fp8.h (exact into half for both types)
// Scales are bf16 or float32 (a run-time flag), one row per K group of g.
//
// Two launch shapes, as in kernel A (qmatmul.cu):
//  * GEMV, M <= 32.  Bound: bytes (the packed planes, read once).  x is
//    staged in shared memory as float32, indexed by (band, row); the value is
//    computed in float32 exactly as the plain version does.  K is split
//    across blocks (gridDim.y) and a second kernel sums the float32 partials
//    in order.  One-plane and byte formats: a thread owns four columns and
//    loads 8 rows of 16 bytes (4 for fp8), coalesced along N, before any
//    arithmetic.  Multi-plane formats: a thread owns one column and holds
//    the words of 8 rows of every plane (up to 56 registers), then walks the
//    bands with the band's scale and zero point loaded once per 8 rows: with
//    four columns only 2 rows fit in registers, and the scale loads (one per
//    weight) set the time.
//  * GEMM, M > 32.  Bound: operations (bf16 tensor cores).  128x128 tiles,
//    8 warps of wmma 16x16x16, K steps of 64.  The wrapper hands x with K
//    reordered band-major (k' = r * EF + b), so a K step is 64 / EF word
//    rows of the narrowest plane with all their bands: the x tile is
//    contiguous and no packed word is read twice per output tile.  The
//    dequantized value is computed in float32 and rounded once to bf16, as
//    the plain version (dequantize to bf16, dot with float32 accumulation).
//    The next step's operands are loaded into registers while the current
//    step's MMAs run.  No TMA / wgmma yet.
//
// Float32 activations (`_f32` entries; the output is float32 too):
//  * GEMV: the same kernels with the x pointer's type a template parameter
//    (XT); x is staged as float32 either way, so only the global load
//    differs, and the product is float32 end to end, never rounded to bf16.
//  * GEMM: gemm_f32_kernel, an exact float32 SIMT GEMM (FFMA, float32
//    accumulation).  The bf16 wmma tile would round x and W to bf16, and a
//    TF32 product would round both to 10-bit mantissas; the JAX kernels'
//    float32 branch does neither.  Bound: operations at the float32
//    (non-tensor) rate.  128x128 tiles, K steps of 64 over the same
//    band-major x and the same unpacking of W as the bf16 GEMM, both
//    operands dequantized / staged in shared memory as float32,
//    double-buffered (135 KB: one block of 256 threads per SM), each thread
//    an 8x8 micro-tile.
//
// Grouped instances (GROUPED = true, one-plane and byte formats; float32
// out): experts stacked on a leading axis of the planes, scales and zeros.
// The GEMV takes one row per block row (gridDim.z) and that row's expert
// from a per-row map; the GEMM's M tile is one block of the sorted rows
// (64 * MI = the routing's bm), its expert read from block_expert and only
// its block_rows live rows loaded; a tile with none writes zeros and stops.
// Grouped-only code is compile-time, so the F and P instances are as before.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace nstfp {

using namespace nvcuda;

enum { FMT_LUT4 = 0, FMT_INT1 = 1, FMT_INT2 = 2, FMT_INT3 = 3, FMT_INT4 = 4,
       FMT_INT5 = 5, FMT_INT6 = 6, FMT_INT7 = 7, FMT_E4M3 = 8, FMT_E5M2 = 9,
       FMT_INT8 = 10 };
enum { Z_NONE = 0, Z_SYM = 1, Z_INT = 2, Z_FLOAT = 3 };

struct PackArgs {
  const uint32_t* plane[3];
  const void* scales;   // [K / g, N] bf16 or float32
  const void* zeros;    // [K / g, N] uint8 or float32, or null
  const float* table;   // 16 floats (LUT4) or null
  int scale_bf16;
  int zmode;
};

template <int FMT>
struct Fmt {
  static constexpr bool kFp8 = FMT == FMT_E4M3 || FMT == FMT_E5M2;
  static constexpr bool kByte = kFp8 || FMT == FMT_INT8;  // [K, N] byte rows
  static constexpr bool kLut = FMT == FMT_LUT4;
  static constexpr int kBits = kLut ? 4 : (kByte ? 8 : FMT);
  // plane widths are the binary digits of kBits (3 = 2+1, 7 = 4+2+1)
  static constexpr int kPlanes =
      kByte ? 1 : ((kBits >> 2) & 1) + ((kBits >> 1) & 1) + (kBits & 1);
  static constexpr int kBands = kByte ? 1 : 32 / (kBits & -kBits);  // EF
  // word rows of the wider planes per row of the narrowest, summed
  static constexpr int kSlots = kByte ? 1 : kBits * kBands / 32;

  __host__ __device__ static constexpr int width(int p) {
    int cnt = 0;
    for (int w = 4; w >= 1; w >>= 1)
      if (kBits & w) {
        if (cnt == p) return w;
        ++cnt;
      }
    return 0;
  }
  __host__ __device__ static constexpr int shift(int p) {
    return kBits & (width(p) - 1);
  }
  // word rows of plane p per row of the narrowest plane
  __host__ __device__ static constexpr int q(int p) {
    return kBands * width(p) / 32;
  }
  __host__ __device__ static constexpr int slot0(int p) {
    int off = 0;
    for (int i = 0; i < p; ++i) off += q(i);
    return off;
  }
};

__device__ __forceinline__ uint32_t lane4(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

template <int FMT>
__device__ __forceinline__ float fp8_value(uint32_t byte) {
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(
      (__nv_fp8_storage_t)byte, FMT == FMT_E4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half2float(__half(hr));
}

__device__ __forceinline__ float scale_at(const PackArgs& a, size_t idx) {
  return a.scale_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.scales)[idx])
             : __ldg(static_cast<const float*>(a.scales) + idx);
}

// Four neighbouring scales; idx is a multiple of 4.
__device__ __forceinline__ void scales4(const PackArgs& a, size_t idx, float s[4]) {
  if (a.scale_bf16) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(a.scales) + idx));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    s[0] = __low2float(lo);
    s[1] = __high2float(lo);
    s[2] = __low2float(hi);
    s[3] = __high2float(hi);
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(a.scales) + idx));
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  }
}

// The zero term of one (group, column): an integer to subtract from the code
// (zi) or, for float offsets, a float to add after the scale (zf).
__device__ __forceinline__ void zero_at(const PackArgs& a, size_t idx, int sym_offset,
                                        int& zi, float& zf) {
  zi = 0;
  zf = 0.f;
  if (a.zmode == Z_SYM) zi = sym_offset;
  else if (a.zmode == Z_INT) zi = static_cast<const uint8_t*>(a.zeros)[idx];
  else if (a.zmode == Z_FLOAT) zf = __ldg(static_cast<const float*>(a.zeros) + idx);
}

// s * (code - zi), or code * s + zf rounded after each step as the plain
// version's two float32 operations are; 1-bit codes are s * (2 * code - 1).
template <int FMT>
__device__ __forceinline__ float int_value(const PackArgs& a, uint32_t code, float s,
                                           int zi, float zf) {
  if constexpr (FMT == FMT_INT1) return s * (float)(2 * (int)code - 1);
  if (a.zmode == Z_FLOAT) return __fadd_rn(__fmul_rn((float)code, s), zf);
  return s * (float)((int)code - zi);
}

// The grouped instances: point the pack at expert e of stacks [E, ...].
template <int FMT>
__device__ __forceinline__ void select_expert(PackArgs& a, int e, int K, int N, int g) {
  using F = Fmt<FMT>;
  const size_t ex = (size_t)e, gn = (size_t)(K / g) * N * ex;
#pragma unroll
  for (int p = 0; p < F::kPlanes; ++p) {
    const size_t bytes = F::kByte ? (size_t)K * N : (size_t)K * F::width(p) / 8 * N;
    a.plane[p] = reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const uint8_t*>(a.plane[p]) + bytes * ex);
  }
  a.scales = static_cast<const uint8_t*>(a.scales) + gn * (a.scale_bf16 ? 2 : 4);
  if (a.zeros != nullptr)
    a.zeros = static_cast<const uint8_t*>(a.zeros) + gn * (a.zmode == Z_FLOAT ? 4 : 1);
}

__device__ __forceinline__ float x_value(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ float x_value(const float* x, size_t i) { return x[i]; }

__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }

__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* v) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(o);
  p[0] = __floats2bfloat162_rn(v[0], v[1]);
  p[1] = __floats2bfloat162_rn(v[2], v[3]);
}
__device__ __forceinline__ void store4(float* o, const float* v) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}

// The code of band b from the words of one row of the narrowest plane:
// w[slot] is the word of plane p at row (slot - slot0(p)) * KW + r.
template <int FMT>
__device__ __forceinline__ uint32_t code_of(const uint32_t* w, int b) {
  using F = Fmt<FMT>;
  uint32_t code = 0;
#pragma unroll
  for (int p = 0; p < F::kPlanes; ++p) {
    const int W = F::width(p), q = F::q(p);
    const uint32_t word = w[F::slot0(p) + b % q];
    code |= ((word >> (W * (b / q))) & ((1u << W) - 1u)) << F::shift(p);
  }
  return code;
}

// ---------------------------------------------------------------- GEMV ---
constexpr int GEMV_THREADS = 128;
constexpr int GEMV_COLS = 4;
constexpr int GEMV_BN = GEMV_THREADS * GEMV_COLS;

// One-plane and byte formats: four columns per thread, 8 rows per chunk.
// The grouped instance (MT = 1) takes row m0 + blockIdx.z and its expert.
template <int FMT, int MT, bool GROUPED = false, typename OutT = __nv_bfloat16,
          typename XT = __nv_bfloat16>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kernel(const XT* __restrict__ x, PackArgs a,
            const int* __restrict__ row_expert, float* __restrict__ partial,
            OutT* __restrict__ out, int M, int K, int N, int g, int rows_per_split,
            int m0) {
  using F = Fmt<FMT>;
  static_assert(F::kSlots == 1, "multi-plane formats go through gemv1_kernel");
  static_assert(!GROUPED || MT == 1, "the grouped GEMV takes one row per block row");
  constexpr int EF = F::kBands, R = 8;
  extern __shared__ float xs[];  // [MT][EF][rows_per_split]
  __shared__ float tab[16];
  if constexpr (GROUPED) {
    m0 += blockIdx.z;
    select_expert<FMT>(a, row_expert[m0], K, N, g);
  }
  const int KW = K / EF;
  const int split = blockIdx.y;
  const int kb0 = split * rows_per_split;
  const int nrows = max(0, min(kb0 + rows_per_split, KW) - kb0);
  const int n = (blockIdx.x * GEMV_THREADS + threadIdx.x) * GEMV_COLS;

  for (int idx = threadIdx.x; idx < MT * EF * rows_per_split; idx += GEMV_THREADS) {
    const int r = idx % rows_per_split;
    const int band = (idx / rows_per_split) % EF;
    const int m = idx / (EF * rows_per_split);
    float v = 0.f;
    if (m0 + m < M && r < nrows)
      v = x_value(x, (size_t)(m0 + m) * K + band * KW + kb0 + r);
    xs[idx] = v;
  }
  if (F::kLut && threadIdx.x < 16) tab[threadIdx.x] = a.table[threadIdx.x];
  __syncthreads();
  if (n >= N) return;

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = 0.f;
  const int sym_offset = 1 << (F::kBits - 1);

  for (int c = 0; c < nrows; c += R) {
    const int kb = kb0 + c;
    if constexpr (F::kByte) {
      uint32_t w[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        w[i] = __ldg(reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const uint8_t*>(a.plane[0]) + (size_t)(kb + i) * N + n));
      const size_t sidx = (size_t)(kb / g) * N + n;
      float s[4];
      scales4(a, sidx, s);
      int zi[GEMV_COLS];
      float zf[GEMV_COLS];
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) {
        zi[j] = 0;
        zf[j] = 0.f;
        if constexpr (!F::kFp8) zero_at(a, sidx + j, sym_offset, zi[j], zf[j]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float wv[GEMV_COLS];
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) {
          const uint32_t code = (w[i] >> (8 * j)) & 255u;
          if constexpr (F::kFp8)
            wv[j] = fp8_value<FMT>(code) * s[j];
          else
            wv[j] = int_value<FMT>(a, code, s[j], zi[j], zf[j]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * rows_per_split + c + i];
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
        }
      }
    } else {
      uint4 w[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        w[i] = __ldg(reinterpret_cast<const uint4*>(a.plane[0] + (size_t)(kb + i) * N + n));
#pragma unroll
      for (int b = 0; b < EF; ++b) {
        const size_t sidx = (size_t)((b * KW + kb) / g) * N + n;
        float s[4];
        scales4(a, sidx, s);
        int zi[GEMV_COLS];
        float zf[GEMV_COLS];
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) zero_at(a, sidx + j, sym_offset, zi[j], zf[j]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float wv[GEMV_COLS];
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) {
            const uint32_t code =
                (lane4(w[i], j) >> (F::kBits * b)) & ((1u << F::kBits) - 1u);
            wv[j] = F::kLut ? tab[code] * s[j]
                            : int_value<FMT>(a, code, s[j], zi[j], zf[j]);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xs[(m * EF + b) * rows_per_split + c + i];
#pragma unroll
            for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    if (row >= M) break;
    if (gridDim.y == 1)
      store4(out + (size_t)row * N + n, acc[m]);
    else
      store4(partial + ((size_t)split * M + row) * N + n, acc[m]);
  }
}

// Multi-plane GEMV: one column per thread, 8 rows of every plane in registers.
constexpr int GEMV1_ROWS = 8;

template <int FMT, int MT, int B>
__device__ __forceinline__ void gemv1_band(const uint32_t (&w)[GEMV1_ROWS][Fmt<FMT>::kSlots],
                                           const PackArgs& a, const float* xs,
                                           int rows_per_split, int c, int kb, int KW,
                                           int g, int N, int n, float (&acc)[MT]) {
  using F = Fmt<FMT>;
  const size_t sidx = (size_t)((B * KW + kb) / g) * N + n;
  const float s = scale_at(a, sidx);
  int zi;
  float zf;
  zero_at(a, sidx, 1 << (F::kBits - 1), zi, zf);
  float wv[GEMV1_ROWS];
#pragma unroll
  for (int i = 0; i < GEMV1_ROWS; ++i) {
    uint32_t code = 0;
#pragma unroll
    for (int p = 0; p < F::kPlanes; ++p) {
      const int W = F::width(p), q = F::q(p);  // B is a constant: no local memory
      code |= ((w[i][F::slot0(p) + B % q] >> (W * (B / q))) & ((1u << W) - 1u))
              << F::shift(p);
    }
    wv[i] = int_value<FMT>(a, code, s, zi, zf);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* xp = &xs[(m * F::kBands + B) * rows_per_split + c];
    const float4 x0 = *reinterpret_cast<const float4*>(xp);
    const float4 x1 = *reinterpret_cast<const float4*>(xp + 4);
    float t = acc[m];
    t = fmaf(x0.x, wv[0], t); t = fmaf(x0.y, wv[1], t);
    t = fmaf(x0.z, wv[2], t); t = fmaf(x0.w, wv[3], t);
    t = fmaf(x1.x, wv[4], t); t = fmaf(x1.y, wv[5], t);
    t = fmaf(x1.z, wv[6], t); t = fmaf(x1.w, wv[7], t);
    acc[m] = t;
  }
  if constexpr (B + 1 < F::kBands)
    gemv1_band<FMT, MT, B + 1>(w, a, xs, rows_per_split, c, kb, KW, g, N, n, acc);
}

template <int FMT, int MT, typename XT, typename OutT>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv1_kernel(const XT* __restrict__ x, PackArgs a, float* __restrict__ partial,
             OutT* __restrict__ out, int M, int K, int N, int g, int rows_per_split,
             int m0) {
  using F = Fmt<FMT>;
  constexpr int EF = F::kBands;
  extern __shared__ __align__(16) float xs1[];  // [MT][EF][rows_per_split]
  const int KW = K / EF;
  const int split = blockIdx.y;
  const int kb0 = split * rows_per_split;
  const int nrows = max(0, min(kb0 + rows_per_split, KW) - kb0);
  const int n = blockIdx.x * GEMV_THREADS + threadIdx.x;

  for (int idx = threadIdx.x; idx < MT * EF * rows_per_split; idx += GEMV_THREADS) {
    const int r = idx % rows_per_split;
    const int band = (idx / rows_per_split) % EF;
    const int m = idx / (EF * rows_per_split);
    float v = 0.f;
    if (m0 + m < M && r < nrows)
      v = x_value(x, (size_t)(m0 + m) * K + band * KW + kb0 + r);
    xs1[idx] = v;
  }
  __syncthreads();
  if (n >= N) return;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  for (int c = 0; c < nrows; c += GEMV1_ROWS) {
    const int kb = kb0 + c;
    uint32_t w[GEMV1_ROWS][F::kSlots];
#pragma unroll
    for (int i = 0; i < GEMV1_ROWS; ++i)
#pragma unroll
      for (int p = 0; p < F::kPlanes; ++p)
#pragma unroll
        for (int jq = 0; jq < F::q(p); ++jq)
          w[i][F::slot0(p) + jq] = __ldg(a.plane[p] + (size_t)(jq * KW + kb + i) * N + n);
    gemv1_band<FMT, MT, 0>(w, a, xs1, rows_per_split, c, kb, KW, g, N, n, acc);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    if (row >= M) break;
    if (gridDim.y == 1)
      store1(out + (size_t)row * N + n, acc[m]);
    else
      partial[((size_t)split * M + row) * N + n] = acc[m];
  }
}

template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     OutT* __restrict__ out, int M, int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * total + i];
  store1(out + i, s);
}

template <typename OutT>
cudaError_t launch_reduce(const float* partial, OutT* out, int M, int N, int splits,
                          cudaStream_t st) {
  const size_t total = (size_t)M * N;
  splitk_reduce_kernel<OutT><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      partial, out, M, N, splits);
  return cudaGetLastError();
}

template <int FMT, int MT, typename XT, typename OutT>
cudaError_t launch_gemv(const XT* x, const PackArgs& a, float* partial, OutT* out, int M,
                        int K, int N, int g, int splits, int m0, cudaStream_t stream) {
  const int KW = K / Fmt<FMT>::kBands;
  const int rows = ((KW + splits - 1) / splits + 7) / 8 * 8;
  const size_t smem = (size_t)MT * Fmt<FMT>::kBands * rows * sizeof(float);
  if constexpr (Fmt<FMT>::kSlots > 1) {
    dim3 grid((N + GEMV_THREADS - 1) / GEMV_THREADS, splits);
    gemv1_kernel<FMT, MT, XT, OutT><<<grid, GEMV_THREADS, smem, stream>>>(
        x, a, partial, out, M, K, N, g, rows, m0);
  } else {
    dim3 grid((N + GEMV_BN - 1) / GEMV_BN, splits);
    gemv_kernel<FMT, MT, false, OutT, XT><<<grid, GEMV_THREADS, smem, stream>>>(
        x, a, nullptr, partial, out, M, K, N, g, rows, m0);
  }
  return cudaGetLastError();
}

// bf16 x and out, or float32 x and out (XT = OutT = float)
template <int FMT, typename XT, typename OutT>
cudaError_t run_gemv(const XT* x, const PackArgs& a, float* partial, OutT* out, int M,
                     int K, int N, int g, int splits, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  for (int m0 = 0; m0 < M && err == cudaSuccess; m0 += 8) {
    const int rows = M - m0;
    if (rows > 4 || M > 8)
      err = launch_gemv<FMT, 8, XT, OutT>(x, a, partial, out, M, K, N, g, splits, m0, st);
    else if (rows > 1)
      err = launch_gemv<FMT, 4, XT, OutT>(x, a, partial, out, M, K, N, g, splits, m0, st);
    else
      err = launch_gemv<FMT, 1, XT, OutT>(x, a, partial, out, M, K, N, g, splits, m0, st);
  }
  if (err == cudaSuccess && splits > 1) err = launch_reduce(partial, out, M, N, splits, st);
  return err;
}

// The grouped GEMV: row m of x times expert row_expert[m], float32 out.
template <int FMT>
cudaError_t run_gemv_grouped(const __nv_bfloat16* x, const PackArgs& a,
                             const int* row_expert, float* partial, float* out, int M,
                             int K, int N, int g, int splits, cudaStream_t st) {
  const int KW = K / Fmt<FMT>::kBands;
  const int rows = ((KW + splits - 1) / splits + 7) / 8 * 8;
  const size_t smem = (size_t)Fmt<FMT>::kBands * rows * sizeof(float);
  dim3 grid((N + GEMV_BN - 1) / GEMV_BN, splits, M);
  gemv_kernel<FMT, 1, true, float><<<grid, GEMV_THREADS, smem, st>>>(
      x, a, row_expert, partial, out, M, K, N, g, rows, 0);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1) err = launch_reduce(partial, out, M, N, splits, st);
  return err;
}

// ---------------------------------------------------------------- GEMM ---
constexpr int BN = 128, BK = 64;
constexpr int LDA = BK + 8, LDB = BN + 8;
constexpr int GEMM_THREADS = 256;

template <int MI>
constexpr int gemm_smem_bytes() {
  return (int)(sizeof(__nv_bfloat16) * 2 * (64 * MI * LDA + BK * LDB) +
               sizeof(float) * (GEMM_THREADS / 32) * 16 * 16);
}

// 64 * MI x 128 output tiles (F and P: MI = 2).  The grouped instance takes
// tile i from expert block_expert[i] and loads its block_rows[i] live rows.
template <int FMT, int MI = 2, bool GROUPED = false, typename OutT = __nv_bfloat16>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __nv_bfloat16* __restrict__ xk, PackArgs a,
            const int* __restrict__ block_expert, const int* __restrict__ block_rows,
            OutT* __restrict__ out, int M, int K, int N, int g) {
  using F = Fmt<FMT>;
  constexpr int BM = 64 * MI;
  constexpr int EF = F::kBands;
  constexpr int R = BK / EF;                  // narrowest-plane rows per K step
  constexpr int RH = F::kByte ? 8 : R / 2;    // rows one thread unpacks
  constexpr int NW = F::kByte ? 8 : RH * F::kSlots;  // words it holds
  extern __shared__ __align__(128) unsigned char gsm[];
  __nv_bfloat16* As_all = reinterpret_cast<__nv_bfloat16*>(gsm);
  __nv_bfloat16* Bs_all = As_all + 2 * BM * LDA;
  auto Cs = reinterpret_cast<float(*)[16 * 16]>(Bs_all + 2 * BK * LDB);
  __shared__ float tab[16];
  if (F::kLut && threadIdx.x < 16) tab[threadIdx.x] = a.table[threadIdx.x];

  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  int m_lim = M;
  if constexpr (GROUPED) {
    const int live = block_rows != nullptr ? block_rows[blockIdx.y] : BM;
    if (live <= 0) {  // no assignment in this tile: its rows are zeros
      for (int i = threadIdx.x; i < BM * BN; i += GEMM_THREADS) {
        const int gm = m_blk + i / BN, gn = n_blk + i % BN;
        if (gm < M && gn < N) store1(out + (size_t)gm * N + gn, 0.f);
      }
      return;
    }
    m_lim = min(M, m_blk + live);
    select_expert<FMT>(a, block_expert[blockIdx.y], K, N, g);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: 16 * MI rows x 64 cols
  const int KW = K / EF;
  const int sym_offset = 1 << (F::kBits - 1);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // packed formats: one column, half of the step's rows, every band;
  // byte rows: four columns (one 32-bit load per row), 8 of the step's 64 rows
  const int bc = F::kByte ? (threadIdx.x % 32) * 4 : threadIdx.x % BN;
  const int bh = F::kByte ? threadIdx.x / 32 : threadIdx.x / BN;
  const int bn = n_blk + bc;
  constexpr int A_PER_THREAD = BM * 8 / GEMM_THREADS;

  uint4 a_reg[A_PER_THREAD];
  uint32_t w_reg[NW];
  auto load_step = [&](int k0) {
#pragma unroll
    for (int u = 0; u < A_PER_THREAD; ++u) {
      const int i = threadIdx.x + u * GEMM_THREADS;
      const int row = i / 8, seg = i % 8;
      a_reg[u] = make_uint4(0, 0, 0, 0);
      if (m_blk + row < m_lim && k0 + seg * 8 < K)
        a_reg[u] = *reinterpret_cast<const uint4*>(
            xk + (size_t)(m_blk + row) * K + k0 + seg * 8);
    }
    if constexpr (F::kByte) {
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(a.plane[0]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + bh * 8 + i;
        w_reg[i] = (bn < N && k < K)
                       ? __ldg(reinterpret_cast<const uint32_t*>(bytes + (size_t)k * N + bn))
                       : 0u;
      }
    } else {
      const int r0 = k0 / EF + bh * RH;
#pragma unroll
      for (int ir = 0; ir < RH; ++ir)
#pragma unroll
        for (int p = 0; p < F::kPlanes; ++p)
#pragma unroll
          for (int jq = 0; jq < F::q(p); ++jq)
            w_reg[ir * F::kSlots + F::slot0(p) + jq] =
                bn < N ? __ldg(a.plane[p] + (size_t)(jq * KW + r0 + ir) * N + bn) : 0u;
    }
  };

  auto store_step = [&](int stage, int k0) {
    __nv_bfloat16* As = As_all + stage * BM * LDA;
    __nv_bfloat16* Bs = Bs_all + stage * BK * LDB;
#pragma unroll
    for (int u = 0; u < A_PER_THREAD; ++u) {
      const int i = threadIdx.x + u * GEMM_THREADS;
      *reinterpret_cast<uint4*>(&As[(i / 8) * LDA + (i % 8) * 8]) = a_reg[u];
    }
    if constexpr (F::kByte) {
      const int k = k0 + bh * 8;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      int zi[4] = {0, 0, 0, 0};
      float zf[4] = {0.f, 0.f, 0.f, 0.f};
      if (bn < N && k < K) {
        const size_t sidx = (size_t)(k / g) * N + bn;
        scales4(a, sidx, s);
        if constexpr (!F::kFp8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) zero_at(a, sidx + j, sym_offset, zi[j], zf[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t code = (w_reg[i] >> (8 * j)) & 255u;
          float v;
          if constexpr (F::kFp8)
            v = fp8_value<FMT>(code) * s[j];
          else
            v = int_value<FMT>(a, code, s[j], zi[j], zf[j]);
          Bs[(bh * 8 + i) * LDB + bc + j] = __float2bfloat16_rn(v);
        }
    } else {
      const int r0 = k0 / EF + bh * RH;
#pragma unroll
      for (int b = 0; b < EF; ++b) {
        float s = 0.f, zf = 0.f;
        int zi = 0;
        if (bn < N) {
          const size_t sidx = (size_t)((b * KW + r0) / g) * N + bn;
          s = scale_at(a, sidx);
          zero_at(a, sidx, sym_offset, zi, zf);
        }
#pragma unroll
        for (int ir = 0; ir < RH; ++ir) {
          const uint32_t code = code_of<FMT>(&w_reg[ir * F::kSlots], b);
          const float v = F::kLut ? tab[code] * s : int_value<FMT>(a, code, s, zi, zf);
          Bs[((bh * RH + ir) * EF + b) * LDB + bc] = __float2bfloat16_rn(v);
        }
      }
    }
  };

  __syncthreads();  // the table
  load_step(0);
  store_step(0, 0);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_step(k0 + BK);
    const __nv_bfloat16* As = As_all + stage * BM * LDA;
    const __nv_bfloat16* Bs = Bs_all + stage * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * 16 * MI + i * 16) * LDA + kk * 16], LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &Bs[(kk * 16) * LDB + wn * 64 + j * 16], LDB);
#pragma unroll
        for (int i = 0; i < MI; ++i) wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
      }
    }
    // the other stage was last read before the previous barrier
    if (more) store_step(stage ^ 1, k0 + BK);
    __syncthreads();
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m_blk + wm * 16 * MI + i * 16 + e / 16;
        const int gn = n_blk + wn * 64 + j * 16 + e % 16;
        if (gm < M && gn < N) store1(out + (size_t)gm * N + gn, Cs[warp][e]);
      }
      __syncwarp();
    }
}

template <int FMT, int MI, bool GROUPED, typename OutT>
cudaError_t launch_gemm(const __nv_bfloat16* xk, const PackArgs& a, const int* block_expert,
                        const int* block_rows, OutT* out, int M, int K, int N, int g,
                        cudaStream_t st) {
  constexpr int smem = gemm_smem_bytes<MI>();
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<FMT, MI, GROUPED, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + 64 * MI - 1) / (64 * MI));
  gemm_kernel<FMT, MI, GROUPED, OutT><<<grid, GEMM_THREADS, smem, st>>>(
      xk, a, block_expert, block_rows, out, M, K, N, g);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t run_gemm(const __nv_bfloat16* xk, const PackArgs& a, __nv_bfloat16* out,
                     int M, int K, int N, int g, cudaStream_t st) {
  return launch_gemm<FMT, 2, false>(xk, a, nullptr, nullptr, out, M, K, N, g, st);
}

// The grouped GEMM over sorted rows in blocks of bm (64 or 128) rows.
template <int FMT>
cudaError_t run_gemm_grouped(const __nv_bfloat16* xk, const PackArgs& a,
                             const int* block_expert, const int* block_rows, float* out,
                             int M, int K, int N, int g, int bm, cudaStream_t st) {
  if (bm == 128)
    return launch_gemm<FMT, 2, true>(xk, a, block_expert, block_rows, out, M, K, N, g, st);
  if (bm == 64)
    return launch_gemm<FMT, 1, true>(xk, a, block_expert, block_rows, out, M, K, N, g, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------- float32 GEMM ---
constexpr int F32_BM = 128;
constexpr int F32_LDA = F32_BM + 4, F32_LDB = BN + 4;  // rows 16-byte aligned
constexpr int F32_A_LOADS = F32_BM * BK / 4 / GEMM_THREADS;  // float4s of x a step

constexpr int gemm_f32_smem_bytes() {
  return (int)(sizeof(float) * 2 * BK * (F32_LDA + F32_LDB));
}

// 128x128 tiles of out = xk @ W in exact float32.  Thread (ty, tx) of the
// 16x16 grid owns rows {ty*4, 64 + ty*4} + 0..3 and the same columns from
// tx: per k it reads two float4 of x (one address per half-warp:
// broadcast) and two of W (16 consecutive float4s) for 64 FFMA.  x is
// stored transposed ([k][m]); a warp loads 8 rows x 64 contiguous bytes of
// it, so its transposed stores fall in 16 banks (2-way).  W is unpacked by
// the same threads and in the same order as gemm_kernel's, into float32.
template <int FMT>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_f32_kernel(const float* __restrict__ xk, PackArgs a, float* __restrict__ out,
                int M, int K, int N, int g) {
  using F = Fmt<FMT>;
  constexpr int EF = F::kBands;
  constexpr int R = BK / EF;                  // narrowest-plane rows per K step
  constexpr int RH = F::kByte ? 8 : R / 2;    // rows one thread unpacks
  constexpr int NW = F::kByte ? 8 : RH * F::kSlots;  // words it holds
  extern __shared__ __align__(16) float fsm[];
  float* As_all = fsm;                        // [2][BK][F32_LDA]
  float* Bs_all = fsm + 2 * BK * F32_LDA;     // [2][BK][F32_LDB]
  __shared__ float tab[16];
  if (F::kLut && threadIdx.x < 16) tab[threadIdx.x] = a.table[threadIdx.x];

  const int m_blk = blockIdx.y * F32_BM, n_blk = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int KW = K / EF;
  const int sym_offset = 1 << (F::kBits - 1);
  const int bc = F::kByte ? (threadIdx.x % 32) * 4 : threadIdx.x % BN;
  const int bh = F::kByte ? threadIdx.x / 32 : threadIdx.x / BN;
  const int bn = n_blk + bc;
  // load u of a warp: rows (wc % 16) * 8 + 0..7, float4 segments
  // (wc / 16) * 4 + 0..3 of the step's 16, wc = u * 8 + warp
  auto a_row = [&](int u) { return ((u * 8 + warp) % 16) * 8 + lane % 8; };
  auto a_seg = [&](int u) { return ((u * 8 + warp) / 16) * 4 + lane / 8; };

  float4 a_reg[F32_A_LOADS];
  uint32_t w_reg[NW];
  auto load_step = [&](int k0) {
#pragma unroll
    for (int u = 0; u < F32_A_LOADS; ++u) {
      const int row = m_blk + a_row(u), k = k0 + a_seg(u) * 4;
      a_reg[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < M && k < K)
        a_reg[u] = __ldg(reinterpret_cast<const float4*>(xk + (size_t)row * K + k));
    }
    if constexpr (F::kByte) {
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(a.plane[0]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + bh * 8 + i;
        w_reg[i] = (bn < N && k < K)
                       ? __ldg(reinterpret_cast<const uint32_t*>(bytes + (size_t)k * N + bn))
                       : 0u;
      }
    } else {
      const int r0 = k0 / EF + bh * RH;
#pragma unroll
      for (int ir = 0; ir < RH; ++ir)
#pragma unroll
        for (int p = 0; p < F::kPlanes; ++p)
#pragma unroll
          for (int jq = 0; jq < F::q(p); ++jq)
            w_reg[ir * F::kSlots + F::slot0(p) + jq] =
                bn < N ? __ldg(a.plane[p] + (size_t)(jq * KW + r0 + ir) * N + bn) : 0u;
    }
  };

  auto store_step = [&](int stage, int k0) {
    float* As = As_all + stage * BK * F32_LDA;
    float* Bs = Bs_all + stage * BK * F32_LDB;
#pragma unroll
    for (int u = 0; u < F32_A_LOADS; ++u) {
      float* col = As + a_seg(u) * 4 * F32_LDA + a_row(u);
      col[0] = a_reg[u].x;
      col[F32_LDA] = a_reg[u].y;
      col[2 * F32_LDA] = a_reg[u].z;
      col[3 * F32_LDA] = a_reg[u].w;
    }
    if constexpr (F::kByte) {
      const int k = k0 + bh * 8;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      int zi[4] = {0, 0, 0, 0};
      float zf[4] = {0.f, 0.f, 0.f, 0.f};
      if (bn < N && k < K) {
        const size_t sidx = (size_t)(k / g) * N + bn;
        scales4(a, sidx, s);
        if constexpr (!F::kFp8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) zero_at(a, sidx + j, sym_offset, zi[j], zf[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t code = (w_reg[i] >> (8 * j)) & 255u;
          if constexpr (F::kFp8)
            v[j] = fp8_value<FMT>(code) * s[j];
          else
            v[j] = int_value<FMT>(a, code, s[j], zi[j], zf[j]);
        }
        *reinterpret_cast<float4*>(&Bs[(bh * 8 + i) * F32_LDB + bc]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      const int r0 = k0 / EF + bh * RH;
#pragma unroll
      for (int b = 0; b < EF; ++b) {
        float s = 0.f, zf = 0.f;
        int zi = 0;
        if (bn < N) {
          const size_t sidx = (size_t)((b * KW + r0) / g) * N + bn;
          s = scale_at(a, sidx);
          zero_at(a, sidx, sym_offset, zi, zf);
        }
#pragma unroll
        for (int ir = 0; ir < RH; ++ir) {
          const uint32_t code = code_of<FMT>(&w_reg[ir * F::kSlots], b);
          Bs[((bh * RH + ir) * EF + b) * F32_LDB + bc] =
              F::kLut ? tab[code] * s : int_value<FMT>(a, code, s, zi, zf);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the table
  load_step(0);
  store_step(0, 0);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_step(k0 + BK);
    const float* As = As_all + stage * BK * F32_LDA;
    const float* Bs = Bs_all + stage * BK * F32_LDB;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * F32_LDA + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * F32_LDA + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * F32_LDB + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk * F32_LDB + 64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (more) store_step(stage ^ 1, k0 + BK);
    __syncthreads();
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m_blk + (i / 4) * 64 + ty * 4 + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n_blk + h * 64 + tx * 4;  // N % 8 == 0: whole float4s
      if (gn < N)
        *reinterpret_cast<float4*>(out + (size_t)gm * N + gn) = make_float4(
            acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
    }
  }
}

template <int FMT>
cudaError_t run_gemm_f32(const float* xk, const PackArgs& a, float* out, int M, int K,
                         int N, int g, cudaStream_t st) {
  constexpr int smem = gemm_f32_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(gemm_f32_kernel<FMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + F32_BM - 1) / F32_BM);
  gemm_f32_kernel<FMT><<<grid, GEMM_THREADS, smem, st>>>(xk, a, out, M, K, N, g);
  return cudaGetLastError();
}

}  // namespace nstfp
