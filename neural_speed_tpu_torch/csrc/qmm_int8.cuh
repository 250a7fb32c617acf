// int8-compute matmul templates shared by kernel G (qmatmul_int8.cu) and
// kernel H (qmatmul_int8_planar.cu), for Hopper (sm_90a):
//   out[m, n] = rs[m] * sum_groups float(d[m, group, n]) * ascale[m, group] * wscale[group, n]
// with d the exact int32 product of the int8 activations with the integer
// weight values of one K group, rs the per-token scale (or 1), and the
// output written once in bf16 or float32.
//
// W is the JAX package's planar pack, read as stored: a plane of width w
// packs e = 32 / w K sub-bands per uint32 word (word [r, n] carries rows
// r + i * K / e at bits w*i); 8-bit weights are one byte row per k.
//
// BITS 4 and 8 (kernel G): one plane; the zero point (or the symmetric
// offset 2^(bits-1)) is folded into the int8 weight value, code - zp.
// BITS 2/3/5/6/7 (kernel H): one integer dot per plane over its raw codes,
// shifted by the plane's position; the zero-point term xsum * zp is taken
// once per K range of the most significant plane, in int32, from the row
// sum of the quantized activations.  Either way each partial d is exact
// and becomes a float exactly (|d| < 2^22: exact_float, no conversion
// instruction, which runs at 1/8 of the FMA rate), so against the plain
// version only the float32 order of the sum over groups differs.
//
// An int32 accumulator must not mix K groups (each (row, group) has its
// ascale and each (group, column) its wscale), and the 8-32 bands of one
// word row belong to different groups.  So both bodies walk K plane by
// plane, chunk by chunk (CR word rows, inside one group of every band: CR
// divides g and the band's rows) and, inside a chunk, band by band: each
// packed word is read from memory once per output tile, and a K step (one
// band of one chunk) lies inside one group.
//
//  * GEMM, M > 32.  Bound: operations (int8 tensor cores, 1979 TOP/s).
//    128 x 128 output tiles, one block of 384 threads per SM,
//    warp-specialised on the parts of qmm_fp.cuh's tc template (mbarrier
//    rings, TMA, the 128-byte swizzle):
//      - warp 3, one thread: TMA loads of the packed chunks (CR word rows
//        x 128 columns of one plane, as stored: a 128 KB ring of two
//        64 KB chunks, or eight of byte rows) and of xq's tile of each
//        band step (128 rows x 128 K bytes, 128-byte swizzle, 2 stages),
//        the chunks SW - 1 chunks ahead.  8-bit rows whose stride is not a
//        multiple of 16 bytes cannot be a TMA map: there the transform
//        reads them from global memory (direct);
//      - warps 0-2 (transform): turn the chunk into K-major int8 tiles in
//        the swizzle wgmma reads (a ring of 4), two bands per pass over
//        the chunk's words: one prmt gathers the byte of 2 bands from 4
//        word rows of a column, a shift and two masks give the 4 K values
//        of each band, and G's fold ((code | 0x80) - zp) ^ 0x80 works on
//        the four bytes at once (no borrow between them).  K steps are
//        CR rows padded to a multiple of 32 with zero weight rows.  Warp 0
//        also writes each tile's wscale and zero points beside it;
//      - warps 4-7 and 8-11 (two consumer warpgroups, 64 rows each):
//        wgmma m64n128k32 s8 x s8 -> s32 into a fresh int32 accumulator
//        per step, then the fold into 64 float32 accumulators (the rows'
//        ascale and xsum loaded a step ahead).
//    12 warps, three to a scheduler partition, leave 168 registers a
//    thread for 64 int32 + 64 float32 accumulators (no setmaxnreg; 13
//    warps would leave 128, and the consumers spilled).  Measured levers
//    not kept (PERF.md, PR 16): the warpgroups taking turns at the
//    tensor cores, xq multicast over 2-block clusters, deeper xq rings.
//    H runs one pass per plane (the JAX kernel's order): each packed word
//    is still read once.
//  * GEMV, M <= 32.  Bound: bytes.  mma.sync m16n8k32 s8 with the M rows as
//    A (one m16 tile up to 16 rows, two up to 32, padded rows zero) and the
//    weights as B: a lane's B fragment is 4 consecutive K of one column, so
//    it loads 8 word rows of 4 columns (16 bytes each) once per 32-row step
//    and builds the fragments of every band from them: every row in one
//    pass over the words.  128 columns a block; K is split across the
//    blocks of a thread-block cluster (gridDim.y = cluster size), whose
//    float32 partials are summed in a fixed order through distributed
//    shared memory (no second kernel, no partials in device memory).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "qmm_fp.cuh"

namespace nsti8 {

namespace cg = cooperative_groups;
using nstfp::tc::bar_arrive;
using nstfp::tc::bar_expect;
using nstfp::tc::bar_init;
using nstfp::tc::bar_wait;
using nstfp::tc::pick4;
using nstfp::tc::sw128_chunk;
using nstfp::tc::sw128_desc;
using nstfp::tc::tma_2d;

struct I8Args {
  const int8_t* xq;       // [M, K], rows ldx bytes apart
  const float* ascale;    // [M, K / g] or null (one scale per token)
  const float* rscale;    // [M] or null: the per-token scale, applied before the one rounding
  const int* xsum;        // [M, K / cr[0]] row sums of xq per chunk (H's GEMM), or null
  const uint32_t* plane[3];
  const void* scales;     // [K / g, N] bf16 or float32
  const uint8_t* zeros;   // [K / g, N] or null (symmetric)
  void* out;              // [M, N] bf16 or float32
  int M, K, N, g, ldx;
  int cr[3];              // chunk rows per plane: divides g and the band's rows, % 8 == 0, <= 128
  int scale_bf16, out_bf16;
  int splits;             // the GEMV's K splits (its cluster size)
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
  __host__ __device__ static constexpr int bands(int p) { return kBytes ? 1 : 32 / width(p); }
};

// a.cr[p] without indexing the parameter at run time (which would copy it
// to the stack)
__device__ __forceinline__ int chunk_rows(const I8Args& a, int p) {
  return p == 0 ? a.cr[0] : p == 1 ? a.cr[1] : a.cr[2];
}

// f(plane) for each plane, the plane a compile-time constant
// (std::integral_constant), so that widths and shifts are template
// arguments.
template <int PLANES, typename F>
__device__ __forceinline__ void for_planes(F&& f) {
  f(std::integral_constant<int, 0>{});
  if constexpr (PLANES > 1) f(std::integral_constant<int, 1>{});
  if constexpr (PLANES > 2) f(std::integral_constant<int, 2>{});
}

// v exactly as a float for |v| < 2^22: the bits of 1.5 * 2^23 + v, less
// 1.5 * 2^23 (both steps exact).
__device__ __forceinline__ float exact_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.f;
}

// Byte j of each of four words, in order, as one word.
__device__ __forceinline__ uint32_t gather4(uint32_t w0, uint32_t w1, uint32_t w2,
                                           uint32_t w3, uint32_t sel) {
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// Four int8 weights code - zp from four codes (bytes of c, each < 128) and
// the zero point repeated in each byte: no borrow crosses a byte.
__device__ __forceinline__ uint32_t fold4(uint32_t c, uint32_t zp4) {
  return ((c | 0x80808080u) - zp4) ^ 0x80808080u;
}

__device__ __forceinline__ void scale4(const I8Args& a, size_t idx, float (&s)[4]) {
  if (a.scale_bf16) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(a.scales) + idx));
    s[0] = __uint_as_float(v.x << 16);
    s[1] = __uint_as_float(v.x & 0xFFFF0000u);
    s[2] = __uint_as_float(v.y << 16);
    s[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.scales) + idx));
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  }
}

// The zero points of four neighbouring columns (idx % 4 == 0), one per byte.
__device__ __forceinline__ uint32_t zeros4(const I8Args& a, size_t idx, uint32_t sym) {
  return a.zeros ? __ldg(reinterpret_cast<const unsigned int*>(a.zeros + idx)) : sym * 0x01010101u;
}

__device__ __forceinline__ uint32_t byte_x4(uint32_t z, int j) {
  return ((z >> (8 * j)) & 255u) * 0x01010101u;
}

// ---------------------------------------------------------------- GEMM ---
namespace g8 {

constexpr int BM = 128, BN = 128, BK = 128;  // BK: bytes of K in a tile row
constexpr int SX = 2, SB = 4;                // ring stages: xq, int8 W
// the packed chunks' ring: 128 KB, two chunks of 128 word rows or eight of
// 128 byte rows (one step each: a deeper ring keeps their loads ahead)
constexpr int W_RING = 2 * 128 * 128 * 4;
// warps 0-2 transform, warp 3 produces, warps 4-11 consume (two warpgroups):
// 12 warps, 3 a scheduler partition, leave 168 registers a thread
constexpr int TWARPS = 3, TRANSFORM = 32 * TWARPS, PRODUCER = 32, CONSUMER = 256;
constexpr int THREADS = TRANSFORM + PRODUCER + CONSUMER;
constexpr int X_STAGE = BM * BK, B_STAGE = BN * BK;
constexpr int SW_MAX = W_RING / (128 * BN);
constexpr int X_OFF = 0, B_OFF = X_OFF + SX * X_STAGE, W_OFF = B_OFF + SB * B_STAGE;
// the fold's factors of each int8 W tile: wscale (float) and zero point
// (byte) of its 128 columns, written by the transform beside the tile
constexpr int FW_OFF = W_OFF + W_RING, FZ_OFF = FW_OFF + SB * BN * 4;
constexpr int BAR_OFF = FZ_OFF + SB * BN;
constexpr int SMEM = BAR_OFF + 8 * 2 * (SX + SB + SW_MAX);

}  // namespace g8

// m64n128k32, s8 x s8 -> s32, A and B K-major in shared memory; `acc` 0
// starts a fresh accumulator.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
        "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void keep_iregs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Warp 0 of the transform: the fold's factors of the step's tile(s), the
// wscale of columns n0..n0+3 as floats and their zero points as bytes.
// Loaded as a pass starts and stored as it ends, so that the loads' latency
// runs beside the pass's work.
struct Factors {
  float s0[4], s1[4];
};

__device__ __forceinline__ void load_factors(const I8Args& a, Factors& f, bool pair, int gi0,
                                             int gi1, int n0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) f.s0[j] = f.s1[j] = 0.f;
  if (n0 < a.N) {
    scale4(a, (size_t)gi0 * a.N + n0, f.s0);
    if (pair) scale4(a, (size_t)gi1 * a.N + n0, f.s1);
  }
}

__device__ __forceinline__ void store_factors(const Factors& f, float* fw0, float* fw1,
                                              uint32_t* fz0, uint32_t* fz1, uint32_t z0,
                                              uint32_t z1) {
  const int l = threadIdx.x % 32;
  *reinterpret_cast<float4*>(fw0 + 4 * l) = make_float4(f.s0[0], f.s0[1], f.s0[2], f.s0[3]);
  fz0[l] = z0;
  if (fw1) {
    *reinterpret_cast<float4*>(fw1 + 4 * l) = make_float4(f.s1[0], f.s1[1], f.s1[2], f.s1[3]);
    fz1[l] = z1;
  }
}

// Transform, packed planes: bands b and b + 1 of the chunk's words (in
// shared memory, [CR][BN]) into two K-major int8 tiles.  Thread (warp wq,
// lane l) takes columns 4l..4l+3 and the 16-row blocks wq, wq + 4, ...; a
// 4-row unit is four 16-byte loads, and each of its columns gives 4 K values
// of each band.  The 16-byte chunks are stored in a lane-rotated column
// order so that a warp's stores spread over the banks.
template <int BITS, int W>
__device__ __forceinline__ void transform_pair(const I8Args& a, const uint32_t* wt,
                                               unsigned char* t0, unsigned char* t1,
                                               float* fw0, float* fw1, uint32_t* fz0,
                                               uint32_t* fz1, int b, int CR, int CRP,
                                               int gi0, int gi1, int n0) {
  using P = Pack<BITS>;
  const int wq = threadIdx.x / 32, l = threadIdx.x % 32;
  const int rot = (l >> 1) & 3;
  const int bit = W * b, byte = bit >> 3, sh = bit & 7;
  const uint32_t sel = (uint32_t)(byte | ((byte + 4) << 4));
  const uint32_t mask = ((1u << W) - 1u) * 0x01010101u;
  const uint32_t sym = 1u << (BITS - 1);
  uint32_t z0 = 0, z1 = 0;
  if (P::kFold || wq == 0) {
    z0 = n0 < a.N ? zeros4(a, (size_t)gi0 * a.N + n0, sym) : 0u;
    z1 = n0 < a.N ? zeros4(a, (size_t)gi1 * a.N + n0, sym) : 0u;
  }
  Factors fac;
  if (wq == 0) load_factors(a, fac, true, gi0, gi1, n0);
  for (int jb = wq; jb < CRP / 16; jb += g8::TWARPS) {
    uint32_t o0[4][4], o1[4][4];  // [column][unit]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = jb * 16 + 4 * u;
      const bool live = row < CR;
      uint4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = live ? *reinterpret_cast<const uint4*>(wt + (row + i) * g8::BN + 4 * l)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t v = gather4(nstfp::lane4(w[0], c), nstfp::lane4(w[1], c),
                                   nstfp::lane4(w[2], c), nstfp::lane4(w[3], c), sel) >> sh;
        uint32_t c0 = v & mask, c1 = (v >> W) & mask;
        if constexpr (P::kFold) {
          c0 = fold4(c0, byte_x4(z0, c));
          c1 = fold4(c1, byte_x4(z1, c));
        }
        o0[c][u] = live ? c0 : 0u;
        o1[c][u] = live ? c1 : 0u;
      }
    }
    uint4 q0[4], q1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q0[c] = make_uint4(o0[c][0], o0[c][1], o0[c][2], o0[c][3]);
      q1[c] = make_uint4(o1[c][0], o1[c][1], o1[c][2], o1[c][3]);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = cc ^ rot;
      *reinterpret_cast<uint4*>(t0 + sw128_chunk(4 * l + c, jb)) = pick4(q0, c);
      *reinterpret_cast<uint4*>(t1 + sw128_chunk(4 * l + c, jb)) = pick4(q1, c);
    }
  }
  if (wq == 0) store_factors(fac, fw0, fw1, fz0, fz1, z0, z1);
}

// Transform, 8-bit rows (one band): the chunk's bytes ([CR][BN] in shared
// memory, or from global memory when `direct`) transposed into a K-major
// tile, code - 128 as code ^ 0x80.
__device__ __forceinline__ void transform_bytes(const I8Args& a, const uint32_t* wt,
                                                unsigned char* t0, float* fw, uint32_t* fz,
                                                int r0, int CR, int CRP, int gi, int n0,
                                                int direct) {
  const int wq = threadIdx.x / 32, l = threadIdx.x % 32;
  const int rot = (l >> 1) & 3;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(a.plane[0]);
  Factors fac;
  if (wq == 0) load_factors(a, fac, false, gi, gi, n0);
  for (int jb = wq; jb < CRP / 16; jb += g8::TWARPS) {
    uint32_t o[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = jb * 16 + 4 * u;
      const bool live = row < CR;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!live) w[i] = 0u;
        else if (direct)
          w[i] = n0 < a.N ? __ldg(reinterpret_cast<const unsigned int*>(
                                bytes + (size_t)(r0 + row + i) * a.N + n0))
                          : 0u;
        else
          w[i] = wt[(row + i) * (g8::BN / 4) + l];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t sel = (uint32_t)(c | ((c + 4) << 4));
        o[c][u] = live ? gather4(w[0], w[1], w[2], w[3], sel) ^ 0x80808080u : 0u;
      }
    }
    uint4 q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = make_uint4(o[c][0], o[c][1], o[c][2], o[c][3]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = cc ^ rot;
      *reinterpret_cast<uint4*>(t0 + sw128_chunk(4 * l + c, jb)) = pick4(q, c);
    }
  }
  if (wq == 0) store_factors(fac, fw, nullptr, fz, nullptr, 0u, 0u);
}

// The fold of one step's int32 products into the float32 accumulators:
// facc += float(d') * (wscale * ascale), d' = d (G), (d << SH) - xsum * zp
// (H, most significant plane) or d << SH (H, the others).  wscale and the
// zero points come from the tile's factors in shared memory; the rows'
// ascale (and xsum) were loaded while the products ran.
template <int BITS, bool CORR, int SH>
__device__ __forceinline__ void fold_step(const I8Args& a, const int (&acc)[64],
                                          float (&facc)[64], const float* fw,
                                          const uint32_t* fz, float as_a, float as_b,
                                          int xs_a, int xs_b) {
  const int l = threadIdx.x % 32;
  const unsigned char* zb = reinterpret_cast<const unsigned char*>(fz);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * (l % 4);
    const float2 ws = *reinterpret_cast<const float2*>(fw + c);
    int v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if constexpr (SH > 0) {
      v0 <<= SH; v1 <<= SH; v2 <<= SH; v3 <<= SH;
    }
    if constexpr (CORR) {
      const int z0 = zb[c], z1 = zb[c + 1];
      v0 -= xs_a * z0; v1 -= xs_a * z1; v2 -= xs_b * z0; v3 -= xs_b * z1;
    }
    facc[4 * j] += exact_float(v0) * (ws.x * as_a);
    facc[4 * j + 1] += exact_float(v1) * (ws.y * as_a);
    facc[4 * j + 2] += exact_float(v2) * (ws.x * as_b);
    facc[4 * j + 3] += exact_float(v3) * (ws.y * as_b);
  }
}

// The first K of flat step s of the walk (plane by plane; in a plane,
// chunk by chunk, band by band) and its plane.
template <int BITS>
__device__ __forceinline__ int step_k0(const I8Args& a, int s, int& p) {
  using P = Pack<BITS>;
  for (p = 0; p < P::kPlanes - 1; ++p) {
    const int n = a.K / chunk_rows(a, p);
    if (s < n) break;
    s -= n;
  }
  const int e = P::bands(p);
  return (s % e) * (a.K / e) + (s / e) * chunk_rows(a, p);
}

// A consumer thread's row factors of a step: ascale of rows row_a and
// row_a + 8 at the step's group, and (H, most significant plane) their
// xq sums over the step's K.
struct RowFactors {
  float as_a, as_b;
  int xs_a, xs_b;
};

template <int BITS>
__device__ __forceinline__ RowFactors row_factors(const I8Args& a, int s, int row_a) {
  int p;
  const int k0 = step_k0<BITS>(a, s, p);
  const int M = a.M, row_b = row_a + 8;
  RowFactors f{1.f, 1.f, 0, 0};
  if (a.ascale) {
    const int G = a.K / a.g, gi = k0 / a.g;
    f.as_a = row_a < M ? __ldg(a.ascale + (size_t)row_a * G + gi) : 0.f;
    f.as_b = row_b < M ? __ldg(a.ascale + (size_t)row_b * G + gi) : 0.f;
  }
  if (!Pack<BITS>::kFold && p == 0) {
    const int XG = a.K / a.cr[0], xi = k0 / a.cr[0];
    f.xs_a = row_a < M ? __ldg(a.xsum + (size_t)row_a * XG + xi) : 0;
    f.xs_b = row_b < M ? __ldg(a.xsum + (size_t)row_b * XG + xi) : 0;
  }
  return f;
}

template <int BITS>
__global__ void __launch_bounds__(g8::THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap wmap0,
            const __grid_constant__ CUtensorMap wmap1,
            const __grid_constant__ CUtensorMap wmap2, I8Args a, int direct) {
  using P = Pack<BITS>;
  using namespace g8;
  constexpr int W_STAGE = P::kBytes ? 128 * BN : 128 * BN * 4, SW = W_RING / W_STAGE;
  extern __shared__ __align__(1024) unsigned char gsm[];
  unsigned char* xs = gsm + X_OFF;
  unsigned char* bs = gsm + B_OFF;
  uint32_t* ws = reinterpret_cast<uint32_t*>(gsm + W_OFF);
  float* fws = reinterpret_cast<float*>(gsm + FW_OFF);
  uint32_t* fzs = reinterpret_cast<uint32_t*>(gsm + FZ_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(gsm + BAR_OFF);
  uint64_t* x_full = bars;
  uint64_t* x_empty = x_full + SX;
  uint64_t* b_full = x_empty + SX;
  uint64_t* b_empty = b_full + SB;
  uint64_t* w_full = b_empty + SB;
  uint64_t* w_empty = w_full + SW;

  const int K = a.K, g = a.g;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  if (threadIdx.x == 0) {
    if (nstfp::tc::smem_addr(gsm) & 1023) __trap();  // the 128-byte swizzle's atoms
    for (int i = 0; i < SX; ++i) {
      bar_init(&x_full[i], 1);
      bar_init(&x_empty[i], CONSUMER / 128);
    }
    for (int i = 0; i < SB; ++i) {
      bar_init(&b_full[i], TWARPS);
      bar_init(&b_empty[i], CONSUMER / 128);
    }
    for (int i = 0; i < SW; ++i) {
      bar_init(&w_full[i], 1);
      bar_init(&w_empty[i], TWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == TWARPS) {
    // ---- producer: one thread, the chunks' loads SW - 1 chunks ahead of
    // the xq tiles
    if (threadIdx.x % 32 == 0) {
    auto chunk = [&](int c, int& p, int& r0) {
      for (p = 0; p < P::kPlanes - 1; ++p) {
        const int n = K / P::bands(p) / chunk_rows(a, p);
        if (c < n) break;
        c -= n;
      }
      r0 = c * chunk_rows(a, p);
    };
    int nch = 0;
    for (int p = 0; p < P::kPlanes; ++p) nch += K / P::bands(p) / chunk_rows(a, p);
    auto load_w = [&](int c) {
      int p, r0;
      chunk(c, p, r0);
      const int wsl = c % SW;
      bar_wait(&w_empty[wsl], ((c / SW) & 1) ^ 1);
      if (direct) {
        bar_arrive(&w_full[wsl]);
        return;
      }
      bar_expect(&w_full[wsl], chunk_rows(a, p) * BN * (P::kBytes ? 1 : 4));
      // each map's address taken apart: a map picked at run time would be
      // copied to the stack
      uint32_t* dst = ws + wsl * (W_STAGE / 4);
      if (p == 0) tma_2d(dst, &wmap0, &w_full[wsl], n_blk, r0);
      else if (p == 1) tma_2d(dst, &wmap1, &w_full[wsl], n_blk, r0);
      else tma_2d(dst, &wmap2, &w_full[wsl], n_blk, r0);
    };
    // chunk c + SW - 1 is loaded before chunk c's xq tiles: its slot held
    // chunk c - 1, which the transform leaves without waiting for them
    for (int c = 0; c + 1 < SW && c < nch; ++c) load_w(c);
    int s = 0;
    for (int c = 0; c < nch; ++c) {
      if (c + SW - 1 < nch) load_w(c + SW - 1);
      int p, r0;
      chunk(c, p, r0);
      const int e = P::bands(p), KW = K / e;
      for (int b = 0; b < e; ++b, ++s) {
        const int xsl = s % SX;
        bar_wait(&x_empty[xsl], ((s / SX) & 1) ^ 1);
        bar_expect(&x_full[xsl], X_STAGE);
        tma_2d(xs + xsl * X_STAGE, &xmap, &x_full[xsl], b * KW + r0, m_blk);
      }
    }
    }
  } else if (warp < TWARPS) {
    // ---- transform: packed chunk -> K-major int8 tiles, two bands a pass
    const int n0 = n_blk + 4 * (threadIdx.x % 32);
    int s = 0, c = 0;
    for_planes<P::kPlanes>([&](auto pc) {
      constexpr int p = decltype(pc)::value;
      const int e = P::bands(p), KW = K / e, CR = a.cr[p], CRP = (CR + 31) / 32 * 32;
      for (int r0 = 0; r0 < KW; r0 += CR, ++c) {
        const int wsl = c % SW;
        bar_wait(&w_full[wsl], (c / SW) & 1);
        const uint32_t* wt = ws + wsl * (W_STAGE / 4);
        if constexpr (P::kBytes) {
          const int bst = s % SB;
          bar_wait(&b_empty[bst], ((s / SB) & 1) ^ 1);
          transform_bytes(a, wt, bs + bst * B_STAGE, fws + bst * BN, fzs + bst * (BN / 4),
                          r0, CR, CRP, r0 / g, n0, direct);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (threadIdx.x % 32 == 0) bar_arrive(&b_full[bst]);
          ++s;
        } else {
          for (int b = 0; b < e; b += 2, s += 2) {
            const int bs0 = s % SB, bs1 = (s + 1) % SB;
            bar_wait(&b_empty[bs0], ((s / SB) & 1) ^ 1);
            bar_wait(&b_empty[bs1], (((s + 1) / SB) & 1) ^ 1);
            const int gi0 = (b * KW + r0) / g, gi1 = ((b + 1) * KW + r0) / g;
            transform_pair<BITS, P::width(p)>(
                a, wt, bs + bs0 * B_STAGE, bs + bs1 * B_STAGE, fws + bs0 * BN,
                fws + bs1 * BN, fzs + bs0 * (BN / 4), fzs + bs1 * (BN / 4), b, CR, CRP,
                gi0, gi1, n0);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
            if (threadIdx.x % 32 == 0) {
              bar_arrive(&b_full[bs0]);
              bar_arrive(&b_full[bs1]);
            }
          }
        }
        __syncwarp();
        if (threadIdx.x % 32 == 0) bar_arrive(&w_empty[wsl]);
      }
    });
  } else {
    // ---- consumers: wgmma per step, then the fold
    const int cw = (warp - TWARPS - 1) / 4;
    const int row_off = 64 * cw;
    const int tl = threadIdx.x % 128;
    const int M = a.M;
    const int row_a = m_blk + row_off + 16 * (tl / 32) + (tl % 32) / 4, row_b = row_a + 8;
    float facc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) facc[i] = 0.f;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    int n_steps = 0;
    for (int p = 0; p < P::kPlanes; ++p) n_steps += K / chunk_rows(a, p);
    RowFactors next = row_factors<BITS>(a, 0, row_a);
    int s = 0;
    for_planes<P::kPlanes>([&](auto pc) {
      constexpr int p = decltype(pc)::value;
      constexpr bool corr = !P::kFold && p == 0;
      const int e = P::bands(p), KW = K / e, CR = a.cr[p], CRP = (CR + 31) / 32 * 32;
      for (int r0 = 0; r0 < KW; r0 += CR) {
        for (int b = 0; b < e; ++b, ++s) {
          const int xsl = s % SX, bst = s % SB;
          bar_wait(&x_full[xsl], (s / SX) & 1);
          bar_wait(&b_full[bst], (s / SB) & 1);
          const uint64_t da = sw128_desc(xs + xsl * X_STAGE + row_off * BK);
          const uint64_t db = sw128_desc(bs + bst * B_STAGE);
          keep_iregs(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          for (int kk = 0; kk < CRP / 32; ++kk)  // 32 bytes of K: 2 in 16-byte units
            wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kk);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // this step's row factors were loaded a step ahead; the next
          // step's load while the products run
          const RowFactors rf = next;
          if (s + 1 < n_steps) next = row_factors<BITS>(a, s + 1, row_a);
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          keep_iregs(acc);
          if (tl == 0) bar_arrive(&x_empty[xsl]);  // the products have read xq's tile
          fold_step<BITS, corr, P::shift(p)>(a, acc, facc, fws + bst * BN,
                                             fzs + bst * (BN / 4), rf.as_a, rf.as_b,
                                             rf.xs_a, rf.xs_b);
          // the W tile's factors are read by every warp of the warpgroup
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
          if (tl == 0) bar_arrive(&b_empty[bst]);
        }
      }
    });
    if (a.rscale) {
      const float ra = row_a < M ? __ldg(a.rscale + row_a) : 0.f;
      const float rb = row_b < M ? __ldg(a.rscale + row_b) : 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        facc[4 * j] *= ra;
        facc[4 * j + 1] *= ra;
        facc[4 * j + 2] *= rb;
        facc[4 * j + 3] *= rb;
      }
    }
    if (a.out_bf16)
      nstfp::tc::store_tile<128>(facc, static_cast<__nv_bfloat16*>(a.out),
                                 m_blk + row_off, n_blk, M, M, a.N);
    else
      nstfp::tc::store_tile<128>(facc, static_cast<float*>(a.out), m_blk + row_off,
                                 n_blk, M, M, a.N);
  }
}

// xq [M, K] int8 (rows ldx bytes apart) in boxes of 128 K x 128 rows,
// 128-byte swizzled (the wgmma A layout).
inline bool x_map(CUtensorMap* m, const int8_t* xq, int M, int K, int ldx) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldx};
  const cuuint32_t box[2] = {(cuuint32_t)g8::BK, (cuuint32_t)g8::BM};
  const cuuint32_t el[2] = {1, 1};
  return nstfp::tc::encoder()(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(xq),
                              dims, strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A plane as stored, [rows][N] 32-bit words (or bytes), in boxes of 128
// columns x `box_rows` rows (one chunk).
inline bool chunk_map(CUtensorMap* m, const void* p, bool bytes, int N, int rows,
                      int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N * (bytes ? 1 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)g8::BN, (cuuint32_t)box_rows};
  const cuuint32_t el[2] = {1, 1};
  return nstfp::tc::encoder()(
             m, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
             const_cast<void*>(p), dims, strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BITS>
cudaError_t run_gemm(const I8Args& a, cudaStream_t st) {
  using P = Pack<BITS>;
  if (nstfp::tc::encoder() == nullptr) return cudaErrorNotSupported;
  // byte rows need a 16-byte row stride for TMA; else the transform reads
  // them from global memory (direct)
  const int direct = P::kBytes && a.N % 16 != 0;
  CUtensorMap xm, wm[3];
  memset(wm, 0, sizeof(wm));
  bool ok = x_map(&xm, a.xq, a.M, a.K, a.ldx);
#pragma unroll
  for (int p = 0; p < P::kPlanes; ++p)
    if (!direct)
      ok = ok && chunk_map(&wm[p], a.plane[p], P::kBytes, a.N, a.K / P::bands(p), a.cr[p]);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, g8::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + g8::BN - 1) / g8::BN, (a.M + g8::BM - 1) / g8::BM);
  gemm_kernel<BITS><<<grid, g8::THREADS, g8::SMEM, st>>>(xm, wm[0], wm[1], wm[2], a, direct);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- GEMV ---
constexpr int GEMV_THREADS = 128;
constexpr int GEMV_COLS = 128;  // 32 a warp: lane (gq, t) loads columns 4 gq .. 4 gq + 3

// D = A (16x32, s8, row) * B (32x8, s8, col), fresh
__device__ __forceinline__ void mma_m16n8k32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// The row sum of four int8 values.
__device__ __forceinline__ int bytes_sum(uint32_t v) { return __dp4a((int)v, 0x01010101, 0); }

// cp.async of 4 or 16 bytes; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   nstfp::tc::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   nstfp::tc::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One buffer of a GEMV step in shared memory: xq's 32 K values of every
// band for every row (rows padded by 16 bytes: the fragment loads of 8 rows
// fall in distinct banks), and each band's first group's wscale (as
// stored), zero points and the rows' ascale.
template <int EMAX, int MT16>
struct GvBuf {
  static constexpr int XROW = EMAX * 32 + 16;
  static constexpr int X = 0, S = X + MT16 * 16 * XROW, Z = S + EMAX * GEMV_COLS * 4;
  static constexpr int A = Z + EMAX * GEMV_COLS, BYTES = A + EMAX * 32 * 4;
};

// The factors of one band's group for the lane: wscale of its accumulator
// columns (nc + jn, nc + 4 + jn), their zero points (H's correction), the
// zero points of its B columns (n4 + jn, G's fold) and its rows' ascale.
template <int MT16>
struct GvFac {
  float ws[2][4];
  uint32_t zc[2], zb;
  float as[MT16][2];
};

template <int BITS, int MT16>
__device__ __forceinline__ void gv_fac_global(const I8Args& a, GvFac<MT16>& f, int gg,
                                              int nc, int n4) {
  const int l = threadIdx.x % 32, gq = l / 4;
  const int N = a.N, M = a.M, G = a.K / a.g;
  const uint32_t sym = 1u << (BITS - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = nc + 4 * h;
    if (c < N) {
      scale4(a, (size_t)gg * N + c, f.ws[h]);
      f.zc[h] = zeros4(a, (size_t)gg * N + c, sym);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) f.ws[h][e] = 0.f;
      f.zc[h] = 0u;
    }
  }
  f.zb = n4 < N ? zeros4(a, (size_t)gg * N + n4, sym) : 0u;
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + gq + 8 * h;
      f.as[i][h] = !a.ascale ? 1.f : m < M ? __ldg(a.ascale + (size_t)m * G + gg) : 0.f;
    }
}

template <int BITS, int EMAX, int MT16>
__device__ __forceinline__ void gv_fac_shared(const I8Args& a, const unsigned char* buf,
                                              GvFac<MT16>& f, int b, int ncl, int n4l) {
  using B = GvBuf<EMAX, MT16>;
  const int l = threadIdx.x % 32, gq = l / 4;
  const uint32_t sym4 = (1u << (BITS - 1)) * 0x01010101u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = ncl + 4 * h;
    if (a.scale_bf16) {
      const uint2 v = *reinterpret_cast<const uint2*>(buf + B::S + b * GEMV_COLS * 4 + c * 2);
      f.ws[h][0] = __uint_as_float(v.x << 16);
      f.ws[h][1] = __uint_as_float(v.x & 0xFFFF0000u);
      f.ws[h][2] = __uint_as_float(v.y << 16);
      f.ws[h][3] = __uint_as_float(v.y & 0xFFFF0000u);
    } else {
      const float4 v = *reinterpret_cast<const float4*>(buf + B::S + b * GEMV_COLS * 4 + c * 4);
      f.ws[h][0] = v.x; f.ws[h][1] = v.y; f.ws[h][2] = v.z; f.ws[h][3] = v.w;
    }
    f.zc[h] = a.zeros ? *reinterpret_cast<const uint32_t*>(buf + B::Z + b * GEMV_COLS + c)
                      : sym4;
  }
  f.zb = a.zeros ? *reinterpret_cast<const uint32_t*>(buf + B::Z + b * GEMV_COLS + n4l) : sym4;
  const float* as = reinterpret_cast<const float*>(buf + B::A) + b * 32;
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) f.as[i][h] = a.ascale ? as[16 * i + gq + 8 * h] : 1.f;
}

// One band of one 32-row step: the A fragments from the staged xq, the B
// fragments from the lane's codes cw[unit][tile] (4 K values of one column
// each, raw), the products for each group the step meets (one, but where g
// or the band's rows are not a multiple of 32) and their fold into facc.
template <int BITS, bool CORR, int SH, int EMAX, int MT16>
__device__ __forceinline__ void gemv_band(const I8Args& a, const unsigned char* buf,
                                          const uint32_t (&cw)[2][4],
                                          float (&facc)[MT16][4][4], int b, int k0,
                                          int kend, bool u0, bool u1, int nw) {
  using P = Pack<BITS>;
  using B = GvBuf<EMAX, MT16>;
  const int l = threadIdx.x % 32, gq = l / 4, t = l % 4;
  const int M = a.M, g = a.g;
  const int n4 = nw + 4 * gq;  // the lane's B columns (tile jn: n4 + jn)
  const int nc = nw + 8 * t;   // its accumulator columns: nc + jn and nc + 4 + jn
  const int nwl = nw % GEMV_COLS;
  uint32_t af[MT16][4];
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + gq + 8 * h;
      const unsigned char* xr = buf + B::X + m * B::XROW + b * 32 + 4 * t;
      af[i][h] = m < M ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
      af[i][h + 2] = m < M ? *reinterpret_cast<const uint32_t*>(xr + 16) : 0u;
    }
  const int ga = (k0 + 4 * t) / g, gb = (k0 + 16 + 4 * t) / g;
  const int gf = k0 / g;
  for (int gg = gf; gg <= (kend - 1) / g; ++gg) {
    GvFac<MT16> f;
    if (gg == gf) gv_fac_shared<BITS, EMAX, MT16>(a, buf, f, b, nwl + 8 * t, nwl + 4 * gq);
    else gv_fac_global<BITS, MT16>(a, f, gg, nc, n4);
    const bool in0 = u0 && ga == gg, in1 = u1 && gb == gg;
    uint32_t b0[4], b1[4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      uint32_t c0 = cw[0][jn], c1 = cw[1][jn];
      if constexpr (P::kBytes) {
        c0 ^= 0x80808080u;
        c1 ^= 0x80808080u;
      } else if constexpr (P::kFold) {
        c0 = fold4(c0, byte_x4(f.zb, jn));
        c1 = fold4(c1, byte_x4(f.zb, jn));
      }
      b0[jn] = in0 ? c0 : 0u;
      b1[jn] = in1 ? c1 : 0u;
    }
#pragma unroll
    for (int i = 0; i < MT16; ++i) {
      // (H, most significant plane) the rows' sums over this group's K in
      // the step, reduced over the quad
      int xs[2] = {0, 0};
      if constexpr (CORR) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v = (in0 ? bytes_sum(af[i][h]) : 0) + (in1 ? bytes_sum(af[i][h + 2]) : 0);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          xs[h] = v;
        }
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        int d[4];
        mma_m16n8k32(d, af[i], b0[jn], b1[jn]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // rows gq (e < 2), gq + 8; columns nc + jn, nc + 4 + jn
          const int h = e >> 1, col = e & 1;
          int v = d[e] << SH;
          if constexpr (CORR) v -= xs[h] * (int)((f.zc[col] >> (8 * jn)) & 255u);
          facc[i][jn][e] += exact_float(v) * (f.ws[col][jn] * f.as[i][h]);
        }
      }
    }
  }
}

// Rows [rlo, rhi) of plane p for split `split` of S: 32-row steps.
template <int BITS>
__device__ __forceinline__ void gv_rows(const I8Args& a, int p, int split, int& rlo, int& rhi) {
  using P = Pack<BITS>;
  const int KW = a.K / P::bands(p), S = a.splits;
  const int RS = ((KW + S - 1) / S + 31) / 32 * 32;
  rlo = min(split * RS, KW);
  rhi = min(rlo + RS, KW);
}

// cp.async of step (plane p, rows r0..r0+31) into `buf`: xq's 32 K values
// of each band for each row, each band's first group's factors.
template <int BITS, int EMAX, int MT16>
__device__ __forceinline__ void gv_stage(const I8Args& a, unsigned char* buf, int p, int r0,
                                         int rhi, int ncb) {
  using P = Pack<BITS>;
  using B = GvBuf<EMAX, MT16>;
  const int E = P::bands(p), KW = a.K / E, M = a.M, N = a.N, g = a.g, G = a.K / a.g;
  for (int idx = threadIdx.x; idx < M * E * 8; idx += GEMV_THREADS) {
    const int m = idx / (E * 8), b = (idx / 8) % E, q = idx % 8;
    const int r = r0 + 4 * q;
    const bool ok = r < rhi;
    cp4(buf + B::X + m * B::XROW + b * 32 + 4 * q,
        ok ? (const void*)(a.xq + (size_t)m * a.ldx + b * KW + r) : (const void*)a.xq,
        ok ? 4 : 0);
  }
  const int es = a.scale_bf16 ? 2 : 4, per = GEMV_COLS * es / 16;
  for (int idx = threadIdx.x; idx < E * per; idx += GEMV_THREADS) {
    const int b = idx / per, q = idx % per;
    const int gg = (b * KW + r0) / g, c = ncb + q * (16 / es);
    const bool ok = c < N;
    cp16(buf + B::S + b * GEMV_COLS * 4 + q * 16,
         ok ? (const void*)(static_cast<const unsigned char*>(a.scales) +
                            ((size_t)gg * N + c) * es)
            : a.scales,
         ok ? 16 : 0);
  }
  if (a.zeros)
    for (int idx = threadIdx.x; idx < E * (GEMV_COLS / 4); idx += GEMV_THREADS) {
      const int b = idx / (GEMV_COLS / 4), q = idx % (GEMV_COLS / 4);
      const int gg = (b * KW + r0) / g, c = ncb + 4 * q;
      const bool ok = c < N;
      cp4(buf + B::Z + b * GEMV_COLS + 4 * q, ok ? (const void*)(a.zeros + (size_t)gg * N + c)
                                                 : (const void*)a.zeros,
          ok ? 4 : 0);
    }
  if (a.ascale)
    for (int idx = threadIdx.x; idx < E * M; idx += GEMV_THREADS) {
      const int b = idx / M, m = idx % M;
      const int gg = (b * KW + r0) / g;
      cp4(buf + B::A + (b * 32 + m) * 4, a.ascale + (size_t)m * G + gg, 4);
    }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int BITS, int MT16>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kernel(I8Args a) {
  using P = Pack<BITS>;
  constexpr int EMAX = P::bands(P::kPlanes - 1);
  using B = GvBuf<EMAX, MT16>;
  extern __shared__ __align__(16) unsigned char gvsm[];  // 2 step buffers, then the partials
  float* part = reinterpret_cast<float*>(gvsm + 2 * B::BYTES);  // [MT16 * 16][GEMV_COLS]
  const int K = a.K, N = a.N, S = a.splits, split = blockIdx.y;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32, gq = l / 4, t = l % 4;
  const int ncb = blockIdx.x * GEMV_COLS;
  const int nw = ncb + 32 * warp;
  const int n4 = nw + 4 * gq;
  const bool live = n4 < N;
  float facc[MT16][4][4];
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[i][j][e] = 0.f;

  // the block's steps, plane by plane; step `it`'s buffer is it % 2, and
  // step it + 1 is staged while step it computes
  auto step_at = [&](int it, int& p, int& r0, int& rhi) {
    for (p = 0; p < P::kPlanes; ++p) {
      int rlo;
      gv_rows<BITS>(a, p, split, rlo, rhi);
      const int n = (rhi - rlo + 31) / 32;
      if (it < n) {
        r0 = rlo + 32 * it;
        return true;
      }
      it -= n;
    }
    return false;
  };
  int it = 0;
  {
    int p, r0, rhi;
    if (step_at(0, p, r0, rhi)) gv_stage<BITS, EMAX, MT16>(a, gvsm, p, r0, rhi, ncb);
  }
  for_planes<P::kPlanes>([&](auto pc) {
    constexpr int p = decltype(pc)::value;
    constexpr int W = P::width(p), SH = P::shift(p), E = P::bands(p);
    constexpr bool corr = !P::kFold && p == 0;
    const int KW = K / E;
    int rlo, rhi;
    gv_rows<BITS>(a, p, split, rlo, rhi);
    // the lane's 8 word rows of a step: 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3
    auto load = [&](int r0, uint32_t (&w)[2][4][4]) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 16 * u + 4 * t + i;
          const bool ok = live && r < rhi;
          if constexpr (P::kBytes) {
            w[u][i][0] = ok ? __ldg(reinterpret_cast<const unsigned int*>(
                                  reinterpret_cast<const uint8_t*>(a.plane[0]) +
                                  (size_t)r * N + n4))
                            : 0u;
          } else {
            const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(a.plane[p] + (size_t)r * N + n4))
                               : make_uint4(0u, 0u, 0u, 0u);
            w[u][i][0] = v.x; w[u][i][1] = v.y; w[u][i][2] = v.z; w[u][i][3] = v.w;
          }
        }
    };
    uint32_t w[2][4][4], wn[2][4][4];
    if (rlo < rhi) load(rlo, w);
    for (int r0 = rlo; r0 < rhi; r0 += 32, ++it) {
      if (r0 + 32 < rhi) load(r0 + 32, wn);
      int np, nr0, nrhi;
      if (step_at(it + 1, np, nr0, nrhi)) {
        gv_stage<BITS, EMAX, MT16>(a, gvsm + ((it + 1) % 2) * B::BYTES, np, nr0, nrhi, ncb);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const unsigned char* buf = gvsm + (it % 2) * B::BYTES;
      const bool u0 = r0 + 4 * t < rhi, u1 = r0 + 16 + 4 * t < rhi;
      const int rend = min(r0 + 32, rhi);
      if constexpr (P::kBytes) {
        uint32_t cw[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
            cw[u][jn] = gather4(w[u][0][0], w[u][1][0], w[u][2][0], w[u][3][0],
                                (uint32_t)(jn | ((jn + 4) << 4)));
        gemv_band<BITS, false, 0, EMAX, MT16>(a, buf, cw, facc, 0, r0, rend, u0, u1, nw);
      } else {
        constexpr uint32_t mask = ((1u << W) - 1u) * 0x01010101u;
        for (int b = 0; b < E; b += 2) {  // two bands from one gather
          const int bit = W * b, byte = bit >> 3, sh = bit & 7;
          const uint32_t sel = (uint32_t)(byte | ((byte + 4) << 4));
          uint32_t c0[2][4], c1[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) {
              const uint32_t v = gather4(w[u][0][jn], w[u][1][jn], w[u][2][jn], w[u][3][jn], sel) >> sh;
              c0[u][jn] = v & mask;
              c1[u][jn] = (v >> W) & mask;
            }
          gemv_band<BITS, corr, SH, EMAX, MT16>(a, buf, c0, facc, b, b * KW + r0, b * KW + rend,
                                                u0, u1, nw);
          gemv_band<BITS, corr, SH, EMAX, MT16>(a, buf, c1, facc, b + 1, (b + 1) * KW + r0,
                                                (b + 1) * KW + rend, u0, u1, nw);
        }
      }
      __syncthreads();  // the buffer is free for step it + 2
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[u][i][j] = wn[u][i][j];
    }
  });

  // this split's partials to shared memory: [row][column of the block]
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * i + gq + 8 * (e >> 1);
        const int col = 32 * warp + 8 * t + 4 * (e & 1) + jn;
        part[row * GEMV_COLS + col] = facc[i][jn][e];
      }
  // the cluster's splits summed in rank order, each block taking a slice of
  // the columns
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int M = a.M;
  const int cols = GEMV_COLS / S, c_lo = split * cols;
  for (int idx = threadIdx.x; idx < M * cols; idx += GEMV_THREADS) {
    const int row = idx / cols, col = c_lo + idx % cols;
    const int n = ncb + col;
    float v = 0.f;
    for (int r = 0; r < S; ++r) v += cl.map_shared_rank(part, r)[row * GEMV_COLS + col];
    if (n < N) {
      if (a.rscale) v *= __ldg(a.rscale + row);
      if (a.out_bf16)
        static_cast<__nv_bfloat16*>(a.out)[(size_t)row * N + n] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(a.out)[(size_t)row * N + n] = v;
    }
  }
  cl.sync();  // no block leaves while another reads its partials
}

template <int BITS, int MT16>
cudaError_t launch_gemv(const I8Args& a, cudaStream_t st) {
  using P = Pack<BITS>;
  constexpr int EMAX = P::bands(P::kPlanes - 1);
  const int smem = 2 * GvBuf<EMAX, MT16>::BYTES + MT16 * 16 * GEMV_COLS * 4;
  auto kernel = gemv_kernel<BITS, MT16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + GEMV_COLS - 1) / GEMV_COLS, a.splits, 1);
  cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BITS>
cudaError_t run_gemv(const I8Args& a, cudaStream_t st) {
  if (a.splits < 1 || a.splits > 8 || (a.splits & (a.splits - 1)) || a.M > 32)
    return cudaErrorInvalidValue;
  return a.M > 16 ? launch_gemv<BITS, 2>(a, st) : launch_gemv<BITS, 1>(a, st);
}

inline I8Args make_args(const void* xq, const void* ascale, const void* rscale,
                        const void* xsum, const void* p0, const void* p1, const void* p2,
                        const void* scales, const void* zeros, void* out, int M, int K,
                        int N, int g, int ldx, int cr0, int cr1, int cr2, int scale_bf16,
                        int out_bf16, int splits) {
  I8Args a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.ascale = static_cast<const float*>(ascale);
  a.rscale = static_cast<const float*>(rscale);
  a.xsum = static_cast<const int*>(xsum);
  a.plane[0] = static_cast<const uint32_t*>(p0);
  a.plane[1] = static_cast<const uint32_t*>(p1);
  a.plane[2] = static_cast<const uint32_t*>(p2);
  a.scales = scales;
  a.zeros = static_cast<const uint8_t*>(zeros);
  a.out = out;
  a.M = M; a.K = K; a.N = N; a.g = g; a.ldx = ldx;
  a.cr[0] = cr0; a.cr[1] = cr1; a.cr[2] = cr2;
  a.scale_bf16 = scale_bf16;
  a.out_bf16 = out_bf16;
  a.splits = splits;
  return a;
}

}  // namespace nsti8
