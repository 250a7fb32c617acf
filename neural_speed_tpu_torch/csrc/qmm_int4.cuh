// Int4 dequant-matmul GEMVs for Hopper (sm_90a), shared by kernel A
// (qmatmul.cu: one weight, bf16 output) and kernel 11 (qmatmul_grouped.cu:
// experts stacked [E, K/8, N], the expert of each row read on the device,
// float32 output).  Their GEMMs (M > 32) run on qmm_fp.cuh's TMA + wgmma
// template (namespace tc, kernel A's format through its A4 dequantization).
//
// W is the JAX package's planar pack: word [kb, n] (uint32, held as int32 by
// the port) carries the 4-bit codes of rows kb + i*K/8, i = 0..7, at bits
// 4i..4i+3.  Value = s[k / g, n] * (code - 8).
//
// Bound: bytes.  The int4 words are read once (0.5 byte per weight) and
// dominate the traffic.  The math is f32 on exact weights (s * (code - 8)
// is exact there).  When the columns give too few blocks for 132 SMs, K is
// split across blocks (gridDim.y) and a second small kernel sums the f32
// partials in a fixed order (deterministic, no atomics).
//
//  * M <= 8 (gemv_int4_kernel, MT = 1, 2, 4 or 8 rows): each thread owns
//    four columns and reads each word row as one 16-byte load, coalesced
//    along N; it loads 8 word rows before any arithmetic (enough bytes in
//    flight to cover the memory latency), unpacks the 8 codes of each word
//    in registers and multiplies them with x rows staged in shared memory
//    (f32, the slice of K this block covers).  The grouped instance takes
//    MT = 1, one row per block row (gridDim.z), and reads the expert of its
//    row from a per-row map.
//  * 8 < M <= 32 (gemv_mma_kernel): every row in one pass over the words,
//    on the tensor cores in TF32 (note at the kernel): FFMA over 32 rows
//    would take ~90 us at gate/up against a ~13 us bytes bound, and a
//    launch per 8 rows reads the words once per launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nst_int4 {

constexpr int GEMV_THREADS = 128;
constexpr int GEMV_COLS = 4;   // one 16-byte word load per row
constexpr int GEMV_BN = GEMV_THREADS * GEMV_COLS;
constexpr int GEMV_CHUNK = 8;  // word rows loaded before any arithmetic

__device__ __forceinline__ uint32_t word_lane(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

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

// rows_per_split is a multiple of GEMV_CHUNK, and so is K / 8: a chunk of 8
// word rows starting at a multiple of 8 lies inside one scale group of every
// band (g is a multiple of 8), so its scales are loaded once.
template <int MT, bool GROUPED, typename OutT>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_int4_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint32_t* __restrict__ words,
                 const __nv_bfloat16* __restrict__ scales,
                 const int* __restrict__ row_expert,
                 float* __restrict__ partial, OutT* __restrict__ out, int M,
                 int K, int N, int g, int rows_per_split, int m0) {
  extern __shared__ float xs[];  // [MT][8 bands][rows_per_split]
  const int KW = K / 8;
  m0 += blockIdx.z * MT;
  if constexpr (GROUPED) {  // MT == 1: this block's row picks the expert
    const size_t e = (size_t)row_expert[m0];
    words += e * KW * N;
    scales += e * (size_t)(K / g) * N;
  }
  const int split = blockIdx.y;
  const int kb0 = split * rows_per_split;
  const int nrows = max(0, min(kb0 + rows_per_split, KW) - kb0);
  const int n = (blockIdx.x * GEMV_THREADS + threadIdx.x) * GEMV_COLS;

  for (int idx = threadIdx.x; idx < MT * 8 * rows_per_split;
       idx += GEMV_THREADS) {
    const int r = idx % rows_per_split;
    const int band = (idx / rows_per_split) % 8;
    const int m = idx / (8 * rows_per_split);
    float v = 0.f;
    if (m0 + m < M && r < nrows)
      v = __bfloat162float(x[(size_t)(m0 + m) * K + band * KW + kb0 + r]);
    xs[idx] = v;
  }
  __syncthreads();
  if (n >= N) return;

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = 0.f;

  for (int c = 0; c < nrows; c += GEMV_CHUNK) {
    const int kb = kb0 + c;
    uint4 w[GEMV_CHUNK];
#pragma unroll
    for (int r = 0; r < GEMV_CHUNK; ++r)
      w[r] = __ldg(reinterpret_cast<const uint4*>(words + (size_t)(kb + r) * N + n));
    float s[8][GEMV_COLS];
#pragma unroll
    for (int band = 0; band < 8; ++band) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
          scales + (size_t)((band * KW + kb) / g) * N + n));
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      s[band][0] = __low2float(lo);
      s[band][1] = __high2float(lo);
      s[band][2] = __low2float(hi);
      s[band][3] = __high2float(hi);
    }
#pragma unroll
    for (int r = 0; r < GEMV_CHUNK; ++r)
#pragma unroll
      for (int band = 0; band < 8; ++band) {
        float wv[GEMV_COLS];
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j)
          wv[j] = s[band][j] *
                  (float)((int)((word_lane(w[r], j) >> (4 * band)) & 15u) - 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[(m * 8 + band) * rows_per_split + c + r];
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j)
            acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
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

template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     OutT* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * total + i];
  store1(out + i, s);
}

// One GEMV launch over row groups m0, m0 + MT, ... (z_groups of them).
template <int MT, bool GROUPED, typename OutT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const uint32_t* words,
                        const __nv_bfloat16* scales, const int* row_expert,
                        float* partial, OutT* out, int M, int K, int N, int g,
                        int splits, int m0, int z_groups,
                        cudaStream_t stream) {
  const int KW = K / 8;
  const int rows =
      ((KW + splits - 1) / splits + GEMV_CHUNK - 1) / GEMV_CHUNK * GEMV_CHUNK;
  const size_t smem = (size_t)MT * 8 * rows * sizeof(float);
  dim3 grid((N + GEMV_BN - 1) / GEMV_BN, splits, z_groups);
  gemv_int4_kernel<MT, GROUPED, OutT><<<grid, GEMV_THREADS, smem, stream>>>(
      x, words, scales, row_expert, partial, out, M, K, N, g, rows, m0);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_reduce(const float* partial, OutT* out, int M, int N,
                          int splits, cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  splitk_reduce_kernel<OutT><<<(unsigned)((total + 255) / 256), 256, 0,
                               stream>>>(partial, out, M, N, splits);
  return cudaGetLastError();
}

// ------------------------------------------------- GEMV, 8 < M <= 32 ---
// One pass over the words for up to 32 rows: mma.sync m16n8k8 in TF32 with
// float32 accumulation.  Both operands are exact in TF32: x is bf16, and
// s * (code - 8) has at most 8 + 3 significant bits (TF32 keeps 11), so
// every product is exact and only the float32 sums' order differs from the
// M <= 8 bodies.  A warp takes 32 columns and K in steps of 8 word rows
// (64 values of K), one MMA per band, n-tile and m-tile: MMA column j of
// n-tile jn is column c0 + 4j + jn, so a lane's four columns of a word row
// are one 16-byte load; the MMA's k index t / t + 4 is word row 2t / 2t + 1
// of the step, and the wrapper hands x in band-major order (k' = row * 8 +
// band), so a lane's x values of a step are two 16-byte loads per row (the
// 8 bands of its two word rows).  Lane (g, t) then holds output columns
// c0 + 8t .. c0 + 8t + 7 of rows g and g + 8: 16-byte stores.  Each step
// issues the next step's words, then its own scales and x (L1 hits after
// the first step), before any product.  MT16 m-tiles of 16 rows (1 for
// M <= 16, 2 above); K split across blocks as the other GEMVs, the float32
// partials summed by splitk_reduce_kernel.
constexpr int MMA_WARPS = 4;
constexpr int MMA_BN = 32 * MMA_WARPS;  // columns per block

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// code - 8 of band `band` of a word as a float, exactly, without a
// conversion instruction: 2^23 + code as a float's bits, less 2^23 + 8.
__device__ __forceinline__ float code_minus8(uint32_t word, int band) {
  return __int_as_float(((word >> (4 * band)) & 15u) | 0x4B000000u) - 8388616.f;
}

// Band b of 8 bf16 in band order (a uint4) as a TF32 operand.
__device__ __forceinline__ uint32_t band_tf32(const uint4& v, int b) {
  const uint32_t w = word_lane(v, b / 2);
  return b % 2 ? w & 0xFFFF0000u : w << 16;
}

__device__ __forceinline__ void store8(__nv_bfloat16* o, const float* v) {
  __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void store8(float* o, const float* v) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// xk: x [M, K] bf16 with K in band-major order.
template <int MT16, typename OutT>
__global__ void __launch_bounds__(32 * MMA_WARPS)
gemv_mma_kernel(const __nv_bfloat16* __restrict__ xk,
                const uint32_t* __restrict__ words,
                const __nv_bfloat16* __restrict__ scales,
                float* __restrict__ partial, OutT* __restrict__ out, int M,
                int K, int N, int g, int rows_per_split) {
  const int KW = K / 8;
  const int lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * MMA_BN + (threadIdx.x / 32) * 32;
  const int split = blockIdx.y;
  const int kb0 = split * rows_per_split;
  const int kb1 = min(kb0 + rows_per_split, KW);
  const int n4 = c0 + 4 * gq;  // this lane's four columns
  const bool live = n4 < N;

  float acc[MT16][4][4];
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // x rows g and g + 8 of each m-tile (rows past M read nothing)
  const uint4* xr[MT16][2];
  bool xok[MT16][2];
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + gq + 8 * h;
      xok[i][h] = m < M;
      xr[i][h] = reinterpret_cast<const uint4*>(xk + (size_t)min(m, M - 1) * K);
    }

  auto load_words = [&](int kb, uint4 (&w)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      w[r] = live ? __ldg(reinterpret_cast<const uint4*>(
                        words + (size_t)(kb + 2 * t + r) * N + n4))
                  : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 w[2], wn[2];
  if (kb0 < kb1) load_words(kb0, w);
  for (int kb = kb0; kb < kb1; kb += 8) {
    if (kb + 8 < kb1) load_words(kb + 8, wn);
    // the step's scales (one group per band for its 8 rows) and x
    uint2 sr[8];
#pragma unroll
    for (int band = 0; band < 8; ++band)
      sr[band] = live ? __ldg(reinterpret_cast<const uint2*>(
                            scales + (size_t)((band * KW + kb) / g) * N + n4))
                      : make_uint2(0u, 0u);
    uint4 xv[MT16][2][2];  // [m-tile][row g / g + 8][word row 2t / 2t + 1]
#pragma unroll
    for (int i = 0; i < MT16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          xv[i][h][r] = xok[i][h] ? __ldg(xr[i][h] + kb + 2 * t + r)
                                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int band = 0; band < 8; ++band) {
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&sr[band].x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&sr[band].y);
      const float s[4] = {__low2float(lo), __high2float(lo), __low2float(hi),
                          __high2float(hi)};
      uint32_t a[MT16][4];
#pragma unroll
      for (int i = 0; i < MT16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[i][h] = band_tf32(xv[i][h][0], band);      // MMA k index t
          a[i][h + 2] = band_tf32(xv[i][h][1], band);  // MMA k index t + 4
        }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const uint32_t b0 = __float_as_uint(s[jn] * code_minus8(word_lane(w[0], jn), band));
        const uint32_t b1 = __float_as_uint(s[jn] * code_minus8(word_lane(w[1], jn), band));
#pragma unroll
        for (int i = 0; i < MT16; ++i) mma_tf32(acc[i][jn], a[i], b0, b1);
      }
    }
    w[0] = wn[0];
    w[1] = wn[1];
  }
  // lane (g, t): columns c0 + 8t + 4e + jn of rows g (e = 0: acc[.][jn][0],
  // e = 1: [1]) and g + 8 ([2], [3])
  const int n8 = c0 + 8 * t;
  if (n8 >= N) return;
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + gq + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) v[4 * e + jn] = acc[i][jn][2 * h + e];
      if (gridDim.y == 1)
        store8(out + (size_t)m * N + n8, v);
      else
        store8(partial + ((size_t)split * M + m) * N + n8, v);
    }
}

// One launch over M in (8, 32] rows; xk in band-major order.
template <typename OutT>
cudaError_t launch_gemv_mma(const __nv_bfloat16* xk, const uint32_t* words,
                            const __nv_bfloat16* scales, float* partial, OutT* out,
                            int M, int K, int N, int g, int splits,
                            cudaStream_t stream) {
  const int KW = K / 8;
  const int rows = ((KW + splits - 1) / splits + 7) / 8 * 8;
  dim3 grid((N + MMA_BN - 1) / MMA_BN, splits);
  if (M > 16)
    gemv_mma_kernel<2, OutT><<<grid, 32 * MMA_WARPS, 0, stream>>>(
        xk, words, scales, partial, out, M, K, N, g, rows);
  else
    gemv_mma_kernel<1, OutT><<<grid, 32 * MMA_WARPS, 0, stream>>>(
        xk, words, scales, partial, out, M, K, N, g, rows);
  return cudaGetLastError();
}

}  // namespace nst_int4
