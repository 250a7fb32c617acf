// int8-compute matmul templates shared by kernel G (qmatmul_int8.cu) and
// kernel H (qmatmul_int8_planar.cu):
//   out[m, n] = sum_groups float(d[m, group, n]) * ascale[m, group] * wscale[group, n]
// with d the exact int32 product of the int8 activations with the integer
// weight values of one K group.  Output float32.
//
// W is the JAX package's planar pack, read as stored: a plane of width w
// packs e = 32 / w K sub-bands per uint32 word (word [r, n] carries rows
// r + i * K / e at bits w*i); 8-bit weights are one byte row per k.
//
// BITS 4 and 8 (kernel G): one plane; the zero point (or the symmetric
// offset 2^(bits-1)) is folded into the int8 weight value, code - zp.
// BITS 2/3/5/6/7 (kernel H): one integer dot per plane over its raw codes,
// shifted by the plane's position; the zero-point term xsum * zp is taken
// once per group, in int32, from the row sum of the quantized activations.
// Either way d is exact, so against the plain version only the float32
// order of the sum over groups differs.
//
// The walk over K: a band of a plane covers a contiguous K range, but the 8
// (16, 32) bands of one word row belong to different groups, and an int32
// accumulator per band would not fit in registers.  So a block takes a chunk
// of word rows (at most 128, inside one group of every band) into shared
// memory once, then for each band unpacks that band's codes into an int8
// tile, multiplies it with the matching slice of xq, and rescales: every
// packed word is read from memory once per output tile, and the float
// rescale runs once per (band, chunk), not per MMA.
//
//  * GEMM, M > 32.  Bound: operations (int8 tensor cores).  128x64 tiles,
//    8 warps of mma.sync m16n8k32 s8 x s8 -> s32 (fragment layouts are
//    architectural, so the rescale runs on the accumulator registers).
//    Single-buffered: loads, unpack and MMAs of one block do not overlap;
//    other blocks on the SM fill the gaps.
//  * GEMV, M <= 32.  Bound: bytes.  A thread owns one column, loads 8 word
//    rows, packs four codes per register and uses dp4a against xq rows that
//    the whole warp reads at the same address (broadcast).  N / 128 column
//    blocks x M / 8 row groups do not fill the card, so the word rows of
//    every plane are split across blocks (gridDim.z) and a second kernel
//    sums the float32 partials in order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nsti8 {

struct I8Args {
  const int8_t* xq;       // [M, K]
  const float* ascale;    // [M, K / g] or null (one scale per token, applied by the caller)
  const uint32_t* plane[3];
  const void* scales;     // [K / g, N] bf16 or float32
  const uint8_t* zeros;   // [K / g, N] or null (symmetric)
  float* out;             // [M, N]
  float* partial;         // [splits, M, N] when the GEMV splits K, else unused
  int splits;
  int M, K, N, g;
  int cr[3];              // chunk rows per plane: divides g and the band's rows, % 8 == 0, <= 128
  int scale_bf16;
};

template <int BITS>
struct Pack {
  static constexpr bool kBytes = BITS == 8;
  static constexpr bool kFold = BITS == 4 || BITS == 8;
  static constexpr int kPlanes =
      kBytes ? 1 : ((BITS >> 2) & 1) + ((BITS >> 1) & 1) + (BITS & 1);
  __host__ __device__ static constexpr int width(int p) {
    if (kBytes) return 8;
    int cnt = 0;
    for (int w = 4; w >= 1; w >>= 1)
      if (BITS & w) {
        if (cnt == p) return w;
        ++cnt;
      }
    return 0;
  }
  __host__ __device__ static constexpr int shift(int p) {
    return kBytes ? 0 : BITS & (width(p) - 1);
  }
};

__device__ __forceinline__ float scale_at(const I8Args& a, size_t idx) {
  return a.scale_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.scales)[idx])
             : __ldg(static_cast<const float*>(a.scales) + idx);
}

__device__ __forceinline__ int bytes_sum(int v) { return __dp4a(v, 0x01010101, 0); }

// D = A (16x32, s8, row) * B (32x8, s8, col) + D
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- GEMM ---
constexpr int BM = 128, BN = 64, GEMM_THREADS = 256;
constexpr int CRMAX = 128;
constexpr int LDS = CRMAX + 16;  // int8 tile row stride: fragment loads hit 32 banks
constexpr int WS = BN + 2;       // word chunk row stride
constexpr int GEMM_SMEM = CRMAX * WS * 4 + BM * LDS + BN * LDS + BM * 4;

template <int BITS>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(I8Args a) {
  using P = Pack<BITS>;
  extern __shared__ __align__(16) unsigned char sm[];
  uint32_t* Wsm = reinterpret_cast<uint32_t*>(sm);            // [CRMAX][WS], or bytes [CRMAX][BN]
  int8_t* As = reinterpret_cast<int8_t*>(sm + CRMAX * WS * 4);  // [BM][LDS]
  uint8_t* Bs = reinterpret_cast<uint8_t*>(As + BM * LDS);      // [BN][LDS]
  int* xsum = reinterpret_cast<int*>(Bs + BN * LDS);            // [BM]

  const int M = a.M, K = a.K, N = a.N, g = a.g;
  const int G = K / g;
  const int tid = threadIdx.x;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: 32 rows x 32 cols
  const int sym_offset = 1 << (BITS - 1);

  float facc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) facc[i][j][c] = 0.f;

#pragma unroll
  for (int p = 0; p < P::kPlanes; ++p) {
    const int W = P::width(p), SH = P::shift(p);
    const int bands = P::kBytes ? 1 : 32 / W;  // K sub-bands per word
    const int kw = K / bands;
    const int CR = a.cr[p];
    const int CRP = (CR + 31) / 32 * 32;
    const bool corr = !P::kFold && p == 0;

    for (int rc = 0; rc < kw; rc += CR) {
      __syncthreads();  // the previous chunk's tiles are no longer read
      if (P::kBytes) {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(a.plane[0]);
        uint8_t* Wb = reinterpret_cast<uint8_t*>(Wsm);
        for (int idx = tid; idx < CR * BN; idx += GEMM_THREADS) {
          const int r = idx / BN, c = idx % BN;
          Wb[idx] = n_blk + c < N ? bytes[(size_t)(rc + r) * N + n_blk + c] : 0;
        }
      } else {
        for (int idx = tid; idx < CR * BN; idx += GEMM_THREADS) {
          const int r = idx / BN, c = idx % BN;
          Wsm[r * WS + c] =
              n_blk + c < N ? __ldg(a.plane[p] + (size_t)(rc + r) * N + n_blk + c) : 0u;
        }
      }
      for (int b = 0; b < bands; ++b) {
        const int k0 = b * kw + rc;
        const int gi = k0 / g;
        if (b > 0) __syncthreads();  // the previous band's tiles are no longer read
        if (tid < BM) xsum[tid] = 0;
        for (int idx = tid; idx < BM * (CRP - CR); idx += GEMM_THREADS)
          As[(idx / (CRP - CR)) * LDS + CR + idx % (CRP - CR)] = 0;
        __syncthreads();
        // xq tile [BM][CR], 8 bytes per piece; its row sums for the correction
        const int ppr = CR / 8;
        for (int idx = tid; idx < BM * ppr; idx += GEMM_THREADS) {
          const int row = idx / ppr, seg = idx % ppr;
          int2 v = make_int2(0, 0);
          if (m_blk + row < M)
            v = *reinterpret_cast<const int2*>(a.xq + (size_t)(m_blk + row) * K + k0 + seg * 8);
          *reinterpret_cast<int2*>(&As[row * LDS + seg * 8]) = v;
          if (corr) atomicAdd(&xsum[row], bytes_sum(v.x) + bytes_sum(v.y));
        }
        // weight tile [BN][CR] int8: band b of the chunk's words
        {
          const int c = tid % BN;
          const int n = n_blk + c;
          int zi = 0;
          if (P::kFold && n < N)
            zi = a.zeros ? (int)a.zeros[(size_t)gi * N + n] : sym_offset;
          for (int r4 = tid / BN; r4 < CR / 4; r4 += GEMM_THREADS / BN) {
            uint32_t packed = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              int code;
              if (P::kBytes)
                code = reinterpret_cast<const uint8_t*>(Wsm)[(4 * r4 + i) * BN + c];
              else
                code = (int)((Wsm[(4 * r4 + i) * WS + c] >> (W * b)) & ((1u << W) - 1u));
              packed |= (uint32_t)((code - zi) & 255) << (8 * i);
            }
            *reinterpret_cast<uint32_t*>(&Bs[c * LDS + 4 * r4]) = packed;
          }
        }
        __syncthreads();

        int acc[2][4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
        for (int kk = 0; kk < CRP; kk += 32) {
          uint32_t af[2][4], bf[4][2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int8_t* base = &As[(wm * 32 + i * 16 + gq) * LDS + kk + t * 4];
            af[i][0] = *reinterpret_cast<const uint32_t*>(base);
            af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
            af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
            af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint8_t* base = &Bs[(wn * 32 + j * 8 + gq) * LDS + kk + t * 4];
            bf[j][0] = *reinterpret_cast<const uint32_t*>(base);
            bf[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
        }

        // rescale this (band, chunk): acc += float(d) * (wscale * ascale)
        float wsv[4][2];
        int zpv[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int n = n_blk + wn * 32 + j * 8 + t * 2 + cc;
            wsv[j][cc] = n < N ? scale_at(a, (size_t)gi * N + n) : 0.f;
            zpv[j][cc] = 0;
            if (corr && n < N)
              zpv[j][cc] = a.zeros ? (int)a.zeros[(size_t)gi * N + n] : sym_offset;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = wm * 32 + i * 16 + gq + hr * 8;
            const int m = m_blk + row;
            const float as = (a.ascale && m < M) ? a.ascale[(size_t)m * G + gi] : 1.f;
            const int xs = corr ? xsum[row] : 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                int d = acc[i][j][hr * 2 + cc];
                if (!P::kFold) d = (d << SH) - xs * zpv[j][cc];
                facc[i][j][hr * 2 + cc] += (float)d * (wsv[j][cc] * as);
              }
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m_blk + wm * 32 + i * 16 + gq + hr * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int n = n_blk + wn * 32 + j * 8 + t * 2 + cc;
          if (n < N) a.out[(size_t)m * N + n] = facc[i][j][hr * 2 + cc];
        }
    }
}

template <int BITS>
cudaError_t run_gemm(const I8Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  gemm_kernel<BITS><<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- GEMV ---
constexpr int GEMV_THREADS = 128;
constexpr int GEMV_MT = 8;

template <int BITS>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kernel(I8Args a) {
  using P = Pack<BITS>;
  const int M = a.M, K = a.K, N = a.N, g = a.g;
  const int G = K / g;
  const int n = blockIdx.x * GEMV_THREADS + threadIdx.x;
  const int m0 = blockIdx.y * GEMV_MT;
  if (n >= N) return;
  const int sym_offset = 1 << (BITS - 1);
  float acc[GEMV_MT];
#pragma unroll
  for (int m = 0; m < GEMV_MT; ++m) acc[m] = 0.f;

#pragma unroll
  for (int p = 0; p < P::kPlanes; ++p) {
    const int W = P::width(p), SH = P::shift(p);
    const int bands = P::kBytes ? 1 : 32 / W;
    const int kw = K / bands;
    const bool corr = !P::kFold && p == 0;
    const int per_split = ((kw / 8 + a.splits - 1) / a.splits) * 8;
    const int r_end = min(kw, ((int)blockIdx.z + 1) * per_split);
    for (int r0 = blockIdx.z * per_split; r0 < r_end; r0 += 8) {
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = P::kBytes
                   ? (uint32_t) reinterpret_cast<const uint8_t*>(a.plane[0])[(size_t)(r0 + i) * N + n]
                   : __ldg(a.plane[p] + (size_t)(r0 + i) * N + n);
      for (int b = 0; b < bands; ++b) {
        const int k0 = b * kw + r0;
        const int gi = k0 / g;
        const float ws = scale_at(a, (size_t)gi * N + n);
        const int zp = a.zeros ? (int)a.zeros[(size_t)gi * N + n] : sym_offset;
        const int zi = P::kFold ? zp : 0;
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c0 = P::kBytes ? (int)w[i] : (int)((w[i] >> (W * b)) & ((1u << W) - 1u));
          const int c1 =
              P::kBytes ? (int)w[i + 4] : (int)((w[i + 4] >> (W * b)) & ((1u << W) - 1u));
          lo |= (uint32_t)((c0 - zi) & 255) << (8 * i);
          hi |= (uint32_t)((c1 - zi) & 255) << (8 * i);
        }
#pragma unroll
        for (int m = 0; m < GEMV_MT; ++m) {
          const int row = m0 + m;
          if (row >= M) break;
          const int2 xv = *reinterpret_cast<const int2*>(a.xq + (size_t)row * K + k0);
          int d = __dp4a(xv.x, (int)lo, __dp4a(xv.y, (int)hi, 0));
          if (!P::kFold) {
            d <<= SH;
            if (corr) d -= (bytes_sum(xv.x) + bytes_sum(xv.y)) * zp;
          }
          const float as = a.ascale ? a.ascale[(size_t)row * G + gi] : 1.f;
          acc[m] += (float)d * (ws * as);
        }
      }
    }
  }
  float* dst = a.splits > 1 ? a.partial + (size_t)blockIdx.z * M * N : a.out;
#pragma unroll
  for (int m = 0; m < GEMV_MT; ++m)
    if (m0 + m < M) dst[(size_t)(m0 + m) * N + n] = acc[m];
}

__global__ void splitk_sum_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t total, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * total + i];
  out[i] = s;
}

template <int BITS>
cudaError_t run_gemv(const I8Args& a, cudaStream_t st) {
  dim3 grid((a.N + GEMV_THREADS - 1) / GEMV_THREADS, (a.M + GEMV_MT - 1) / GEMV_MT,
            a.splits);
  gemv_kernel<BITS><<<grid, GEMV_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && a.splits > 1) {
    const size_t total = (size_t)a.M * a.N;
    splitk_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a.partial, a.out,
                                                                       total, a.splits);
    err = cudaGetLastError();
  }
  return err;
}

inline I8Args make_args(const void* xq, const void* ascale, const void* p0, const void* p1,
                        const void* p2, const void* scales, const void* zeros, void* out,
                        void* partial, int M, int K, int N, int g, int cr0, int cr1,
                        int cr2, int scale_bf16, int splits) {
  I8Args a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.ascale = static_cast<const float*>(ascale);
  a.plane[0] = static_cast<const uint32_t*>(p0);
  a.plane[1] = static_cast<const uint32_t*>(p1);
  a.plane[2] = static_cast<const uint32_t*>(p2);
  a.scales = scales;
  a.zeros = static_cast<const uint8_t*>(zeros);
  a.out = static_cast<float*>(out);
  a.partial = static_cast<float*>(partial);
  a.splits = splits < 1 ? 1 : splits;
  a.M = M; a.K = K; a.N = N; a.g = g;
  a.cr[0] = cr0; a.cr[1] = cr1; a.cr[2] = cr2;
  a.scale_bf16 = scale_bf16;
  return a;
}

}  // namespace nsti8
