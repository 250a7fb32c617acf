// Int4 dequant-matmul for Hopper (sm_90a): out[M, N] = x[M, K] @ W.
//
// Replaces: neural_speed_tpu/ops/matmul.py, _gemm_kernel_int (launched by
// _qmatmul_pallas_2d from qmatmul) for int4, symmetric, bf16 group scales.
//
// W is the JAX package's planar pack: word [kb, n] (uint32, held as int32 by
// the port) carries the 4-bit codes of rows kb + i*K/8, i = 0..7, at bits
// 4i..4i+3.  Value = s[k / g, n] * (code - 8).
//
// Two launch shapes, as in the TPU kernel's compute-dtype rule:
//
//  * GEMV, M <= 32 (decode, and the LM head at prefill).  Bound: bytes.  The
//    int4 words are read once (0.5 byte per weight) and dominate the traffic:
//    ~3.4 GB per Llama-2-7B decode step, ~1.0 ms at 3.35 TB/s.  Design: each
//    thread owns four columns and reads each word row as one 16-byte load,
//    coalesced along N; it loads 8 word rows before any arithmetic (enough
//    bytes in flight to cover the memory latency), unpacks the 8 codes of
//    each word in registers and multiplies them with x rows staged in shared
//    memory (f32, the slice of K this block covers).  The math is f32:
//    s * (code - 8) is exact there.  At N = 4096 there are only 8 column
//    blocks for 132 SMs, so K is split across blocks (gridDim.y) and a second
//    small kernel sums the f32 partials in a fixed order (deterministic, no
//    atomics).
//
//  * GEMM, M > 32 (prefill projections).  Bound: operations (2 M N K on the
//    bf16 tensor cores; 369 GFLOP for gate/up at M = 2048).  Design: 128x128
//    output tiles, 8 warps of nvcuda::wmma bf16 16x16x16 with f32
//    accumulation.  Each K step takes 8 word rows: the 8 bands of those rows
//    are 64 values of K, so every word is read from memory once per M tile
//    and unpacked into a bf16 tile in shared memory.  Two shared-memory
//    stages: the next step's operands are loaded into registers while the
//    current step's MMAs run, then unpacked into the other stage (one
//    barrier per K step).
//    The dequantized value is rounded to bf16 before the product, as the JAX
//    package's XLA path does (dequantize(qt, bf16) then a dot with f32
//    accumulation).  No TMA/wgmma yet: that is later work.
//
// Host entries return cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int GEMV_THREADS = 128;
constexpr int GEMV_COLS = 4;   // one 16-byte word load per row
constexpr int GEMV_BN = GEMV_THREADS * GEMV_COLS;
constexpr int GEMV_CHUNK = 8;  // word rows loaded before any arithmetic

__device__ __forceinline__ uint32_t word_lane(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// rows_per_split is a multiple of GEMV_CHUNK, and so is K / 8: a chunk of 8
// word rows starting at a multiple of 8 lies inside one scale group of every
// band (g is a multiple of 8), so its scales are loaded once.
template <int MT>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_int4_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint32_t* __restrict__ words,
                 const __nv_bfloat16* __restrict__ scales,
                 float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                 int M, int K, int N, int g, int rows_per_split, int m0) {
  extern __shared__ float xs[];  // [MT][8 bands][rows_per_split]
  const int KW = K / 8;
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
    if (gridDim.y == 1) {
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + n);
      o[0] = __floats2bfloat162_rn(acc[m][0], acc[m][1]);
      o[1] = __floats2bfloat162_rn(acc[m][2], acc[m][3]);
    } else {
      *reinterpret_cast<float4*>(partial + ((size_t)split * M + row) * N + n) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     __nv_bfloat16* __restrict__ out, int M,
                                     int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * total + i];
  out[i] = __float2bfloat16_rn(s);
}

template <int MT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const uint32_t* words,
                        const __nv_bfloat16* scales, float* partial,
                        __nv_bfloat16* out, int M, int K, int N, int g,
                        int splits, int m0, cudaStream_t stream) {
  const int KW = K / 8;
  const int rows =
      ((KW + splits - 1) / splits + GEMV_CHUNK - 1) / GEMV_CHUNK * GEMV_CHUNK;
  const size_t smem = (size_t)MT * 8 * rows * sizeof(float);
  dim3 grid((N + GEMV_BN - 1) / GEMV_BN, splits);
  gemv_int4_kernel<MT><<<grid, GEMV_THREADS, smem, stream>>>(
      x, words, scales, partial, out, M, K, N, g, rows, m0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- GEMM ---
constexpr int BM = 128, BN = 128, KWT = 8, BK = 8 * KWT;
constexpr int LDA = BK + 8, LDB = BN + 8;
constexpr int GEMM_THREADS = 256;

__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_int4_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint32_t* __restrict__ words,
                 const __nv_bfloat16* __restrict__ scales,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N, int g) {
  // two stages of the A and B tiles, then the epilogue's per-warp tiles
  extern __shared__ __align__(128) unsigned char gsm[];
  __nv_bfloat16* As_all = reinterpret_cast<__nv_bfloat16*>(gsm);
  __nv_bfloat16* Bs_all = As_all + 2 * BM * LDA;
  auto Cs = reinterpret_cast<float(*)[16 * 16]>(Bs_all + 2 * BK * LDB);

  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: 32 rows x 64 cols
  const int KW = K / 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int bc = threadIdx.x % BN;         // B-tile column of this thread
  const int br0 = (threadIdx.x / BN) * 4;  // its 4 word rows
  const int bn = n_blk + bc;
  constexpr int A_PER_THREAD = BM * 8 / GEMM_THREADS;

  // The next K step's operands are loaded into registers while the current
  // step's MMAs run, and unpacked into the other shared-memory stage after.
  uint4 a_reg[A_PER_THREAD];
  uint32_t w_reg[4];
  float s_reg[8];
  auto load_step = [&](int kb0) {
#pragma unroll
    for (int u = 0; u < A_PER_THREAD; ++u) {
      const int i = threadIdx.x + u * GEMM_THREADS;
      const int row = i / 8, band = i % 8;
      a_reg[u] = make_uint4(0, 0, 0, 0);
      if (m_blk + row < M)
        a_reg[u] = *reinterpret_cast<const uint4*>(
            x + (size_t)(m_blk + row) * K + band * KW + kb0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w_reg[j] = bn < N ? words[(size_t)(kb0 + br0 + j) * N + bn] : 0u;
#pragma unroll
    for (int band = 0; band < 8; ++band)
      s_reg[band] = bn < N ? __bfloat162float(
                                 scales[(size_t)((band * KW + kb0) / g) * N + bn])
                           : 0.f;
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
            __float2bfloat16_rn(s_reg[band] * (float)code);
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
                     wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * LDA + kk * 16],
                               LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // one B fragment at a time keeps the kernel at two blocks per SM
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[(kk * 16) * LDB + wn * 64 + j * 16],
                               LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b,
                                                   acc[i][j]);
      }
    }
    // the other stage was last read before the previous barrier
    if (more) store_step(stage ^ 1);
    __syncthreads();
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m_blk + wm * 32 + i * 16 + e / 16;
        const int gn = n_blk + wn * 64 + j * 16 + e % 16;
        if (gm < M && gn < N)
          out[(size_t)gm * N + gn] = __float2bfloat16_rn(Cs[warp][e]);
      }
      __syncwarp();
    }
}

}  // namespace

extern "C" int nst_qmatmul_int4_gemv(const void* x, const void* words,
                                     const void* scales, void* partial,
                                     void* out, int M, int K, int N, int g,
                                     int splits, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const uint32_t*>(words);
  auto sp = static_cast<const __nv_bfloat16*>(scales);
  auto pp = static_cast<float*>(partial);
  auto op = static_cast<__nv_bfloat16*>(out);
  cudaError_t err = cudaSuccess;
  for (int m0 = 0; m0 < M && err == cudaSuccess; m0 += 8) {
    const int rows = M - m0;
    if (rows >= 8 || M > 8)
      err = launch_gemv<8>(xp, wp, sp, pp, op, M, K, N, g, splits, m0, st);
    else if (rows > 2)
      err = launch_gemv<4>(xp, wp, sp, pp, op, M, K, N, g, splits, m0, st);
    else if (rows == 2)
      err = launch_gemv<2>(xp, wp, sp, pp, op, M, K, N, g, splits, m0, st);
    else
      err = launch_gemv<1>(xp, wp, sp, pp, op, M, K, N, g, splits, m0, st);
  }
  if (err == cudaSuccess && splits > 1) {
    const size_t total = (size_t)M * N;
    splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        pp, op, M, N, splits);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" int nst_qmatmul_int4_gemm(const void* x, const void* words,
                                     const void* scales, void* out, int M,
                                     int K, int N, int g, void* stream) {
  const int smem = (int)(sizeof(__nv_bfloat16) * 2 * (BM * LDA + BK * LDB) +
                         sizeof(float) * (GEMM_THREADS / 32) * 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_int4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_int4_kernel<<<grid, GEMM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(words),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<__nv_bfloat16*>(out), M, K, N, g);
  return (int)cudaGetLastError();
}
