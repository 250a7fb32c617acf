// Int4 dequant-matmul bodies for Hopper (sm_90a), shared by kernel A
// (qmatmul.cu: one weight, bf16 output) and kernel 11 (qmatmul_grouped.cu:
// experts stacked [E, K/8, N], the expert of each row block or row read on
// the device, float32 output).
//
// W is the JAX package's planar pack: word [kb, n] (uint32, held as int32 by
// the port) carries the 4-bit codes of rows kb + i*K/8, i = 0..7, at bits
// 4i..4i+3.  Value = s[k / g, n] * (code - 8).
//
//  * GEMV, M <= 32.  Bound: bytes.  The int4 words are read once (0.5 byte
//    per weight) and dominate the traffic.  Design: each thread owns four
//    columns and reads each word row as one 16-byte load, coalesced along
//    N; it loads 8 word rows before any arithmetic (enough bytes in flight
//    to cover the memory latency), unpacks the 8 codes of each word in
//    registers and multiplies them with x rows staged in shared memory
//    (f32, the slice of K this block covers).  The math is f32:
//    s * (code - 8) is exact there.  When the columns give too few blocks
//    for 132 SMs, K is split across blocks (gridDim.y) and a second small
//    kernel sums the f32 partials in a fixed order (deterministic, no
//    atomics).  gridDim.z walks row groups of MT rows; the grouped instance
//    takes MT = 1 and reads the expert of its row from a per-row map.
//
//  * GEMM, M > 32.  Bound: operations (2 M N K on the bf16 tensor cores).
//    Design: BM x 128 output tiles (BM = 64 * MI), 8 warps of nvcuda::wmma
//    bf16 16x16x16 with f32 accumulation.  Each K step takes 8 word rows:
//    the 8 bands of those rows are 64 values of K, so every word is read
//    from memory once per M tile and unpacked into a bf16 tile in shared
//    memory.  Two shared-memory stages: the next step's operands are loaded
//    into registers while the current step's MMAs run, then unpacked into
//    the other stage (one barrier per K step).  The dequantized value is
//    rounded to bf16 before the product, as the JAX package's XLA path does
//    (dequantize(qt, bf16) then a dot with f32 accumulation).  The grouped
//    instance (GROUPED = true) takes M tile i from expert block_expert[i];
//    with a live-row map (block_rows[i] rows of tile i hold assignments, at
//    its head) it loads only those rows of x (the rest of the tile is
//    zeros, as the zero row they read), and a tile with none writes its
//    zeros and stops.  The grouped parts are compile-time: kernel A's
//    instance uses all 128 registers that two blocks per SM allow and
//    spilled once runtime grouped branches were added to it.  The grouped
//    instance holds its expert offsets as 32-bit element offsets and its 8
//    scales as bf16, which cut its spills and its time on the card against
//    64-bit pointer offsets and float scales; skipping the MMAs of warps
//    past the live rows sped up decode steps but slowed prefill more, so
//    it is not done.  No TMA/wgmma yet: that is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace nst_int4 {

using namespace nvcuda;

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

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// ---------------------------------------------------------------- GEMM ---
constexpr int BN = 128, KWT = 8, BK = 8 * KWT;
constexpr int LDA = BK + 8, LDB = BN + 8;
constexpr int GEMM_THREADS = 256;

template <int MI>
constexpr int gemm_smem_bytes() {
  return (int)(sizeof(__nv_bfloat16) * 2 * (64 * MI * LDA + BK * LDB) +
               sizeof(float) * (GEMM_THREADS / 32) * 16 * 16);
}

template <int MI, bool GROUPED, typename OutT>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_int4_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint32_t* __restrict__ words,
                 const __nv_bfloat16* __restrict__ scales,
                 const int* __restrict__ block_expert,
                 const int* __restrict__ block_rows, OutT* __restrict__ out,
                 int M, int K, int N, int g) {
  constexpr int BM = 64 * MI;
  // two stages of the A and B tiles, then the epilogue's per-warp tiles
  extern __shared__ __align__(128) unsigned char gsm[];
  __nv_bfloat16* As_all = reinterpret_cast<__nv_bfloat16*>(gsm);
  __nv_bfloat16* Bs_all = As_all + 2 * BM * LDA;
  auto Cs = reinterpret_cast<float(*)[16 * 16]>(Bs_all + 2 * BK * LDB);

  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: 16*MI rows x 64 cols
  const int KW = K / 8;

  // the grouped instance: the expert's offsets in words and scales (the
  // wrapper keeps E * K/8 * N below 2**32) and the end of the live rows
  uint32_t wofs = 0, sofs = 0;
  int m_lim = M;
  if constexpr (GROUPED) {
    const uint32_t e = (uint32_t)block_expert[blockIdx.y];
    wofs = e * (uint32_t)(KW * N);
    sofs = e * (uint32_t)((K / g) * N);
    const int live = block_rows != nullptr ? block_rows[blockIdx.y] : BM;
    if (live <= 0) {  // no assignment in this tile: its rows are zeros
      for (int i = threadIdx.x; i < BM * BN; i += GEMM_THREADS) {
        const int gm = m_blk + i / BN, gn = n_blk + i % BN;
        if (gm < M && gn < N) store1(out + (size_t)gm * N + gn, 0.f);
      }
      return;
    }
    m_lim = min(M, m_blk + live);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int bc = threadIdx.x % BN;         // B-tile column of this thread
  const int br0 = (threadIdx.x / BN) * 4;  // its 4 word rows
  const int bn = n_blk + bc;
  constexpr int A_PER_THREAD = BM * 8 / GEMM_THREADS;

  // The next K step's operands are loaded into registers while the current
  // step's MMAs run, and unpacked into the other shared-memory stage after.
  using ScaleReg = std::conditional_t<GROUPED, __nv_bfloat16, float>;
  uint4 a_reg[A_PER_THREAD];
  uint32_t w_reg[4];
  ScaleReg s_reg[8];
  auto load_step = [&](int kb0) {
#pragma unroll
    for (int u = 0; u < A_PER_THREAD; ++u) {
      const int i = threadIdx.x + u * GEMM_THREADS;
      const int row = i / 8, band = i % 8;
      a_reg[u] = make_uint4(0, 0, 0, 0);
      if (m_blk + row < (GROUPED ? m_lim : M))
        a_reg[u] = *reinterpret_cast<const uint4*>(
            x + (size_t)(m_blk + row) * K + band * KW + kb0);
    }
    // kernel A's loads are kept apart, as written before the grouped
    // instance existed: a shared form cost its GEMM ~6% (same registers)
    if constexpr (GROUPED) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w_reg[j] = bn < N ? words[wofs + (size_t)(kb0 + br0 + j) * N + bn]
                          : 0u;
#pragma unroll
      for (int band = 0; band < 8; ++band)
        s_reg[band] =
            bn < N ? scales[sofs + (size_t)((band * KW + kb0) / g) * N + bn]
                   : __float2bfloat16_rn(0.f);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w_reg[j] = bn < N ? words[(size_t)(kb0 + br0 + j) * N + bn] : 0u;
#pragma unroll
      for (int band = 0; band < 8; ++band)
        s_reg[band] = bn < N ? __bfloat162float(
                                   scales[(size_t)((band * KW + kb0) / g) * N + bn])
                             : 0.f;
    }
  };

  auto store_step = [&](int stage) {
    __nv_bfloat16* As = As_all + stage * BM * LDA;
    __nv_bfloat16* Bs = Bs_all + stage * BK * LDB;
    // A tile: tile column band*8 + c holds x[:, band*KW + kb0 + c]
#pragma unroll
    for (int u = 0; u < A_PER_THREAD; ++u) {
      const int i = threadIdx.x + u * GEMM_THREADS;
      *reinterpret_cast<uint4*>(&As[(i / 8) * LDA + (i % 8) * 8]) = a_reg[u];
    }
    // B tile: row band*8 + r holds W[band*KW + kb0 + r, :], as bf16
#pragma unroll
    for (int band = 0; band < 8; ++band)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int code = (int)((w_reg[j] >> (4 * band)) & 15u) - 8;
        Bs[(band * 8 + br0 + j) * LDB + bc] =
            __float2bfloat16_rn(as_float(s_reg[band]) * (float)code);
      }
  };

  load_step(0);
  store_step(0);
  __syncthreads();
  int stage = 0;
  for (int kb0 = 0; kb0 < KW; kb0 += KWT) {
    const bool more = kb0 + KWT < KW;
    if (more) load_step(kb0 + KWT);
    const __nv_bfloat16* As = As_all + stage * BM * LDA;
    const __nv_bfloat16* Bs = Bs_all + stage * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        wmma::load_matrix_sync(
            a[i], &As[(wm * 16 * MI + i * 16) * LDA + kk * 16], LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // one B fragment at a time keeps the kernel at two blocks per SM
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[(kk * 16) * LDB + wn * 64 + j * 16],
                               LDB);
#pragma unroll
        for (int i = 0; i < MI; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    // the other stage was last read before the previous barrier
    if (more) store_step(stage ^ 1);
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

// One GEMM launch: ceil(N / 128) x ceil(M / (64 * MI)) tiles.
template <int MI, bool GROUPED, typename OutT>
cudaError_t launch_gemm(const __nv_bfloat16* x, const uint32_t* words,
                        const __nv_bfloat16* scales, const int* block_expert,
                        const int* block_rows, OutT* out, int M, int K, int N,
                        int g, cudaStream_t stream) {
  constexpr int smem = gemm_smem_bytes<MI>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_int4_kernel<MI, GROUPED, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + 64 * MI - 1) / (64 * MI));
  gemm_int4_kernel<MI, GROUPED, OutT><<<grid, GEMM_THREADS, smem, stream>>>(
      x, words, scales, block_expert, block_rows, out, M, K, N, g);
  return cudaGetLastError();
}

}  // namespace nst_int4
