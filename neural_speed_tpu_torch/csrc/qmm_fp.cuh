// Float-compute dequant-matmul templates shared by kernel F (qmatmul_lut.cu),
// kernel P (qmatmul_planar.cuh: its one-plane INT instances also take the
// packs of _gemm_kernel_int that kernel A does not) and their grouped MoE
// instances (qmatmul_grouped_fp.cuh): out[M, N] = x[M, K] @ W, bf16 in and
// out (float32 out for the grouped instances), or float32 in and out (the
// `_f32` entries: the JAX kernels' float32-activation branch, quantized
// Whisper's path).  Its bf16 GEMM (namespace tc) is also the GEMM of kernel
// A (qmatmul.cu) and kernel 11 (qmatmul_grouped.cu), with A4 = true: their
// format (int4, the symmetric offset, bf16 scales) dequantized in bf16x2
// (a4_chunk).
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
// Launch shapes:
//  * GEMV, M <= 32.  Bound: bytes (the packed planes, read once; their
//    scales and zero terms beside them).  One GEMV launch per call at any
//    M, every packed word read once per call (per 8 rows with float32 x).
//    - Decode, both bodies: an integer code becomes a float by the exponent
//      trick, magic(c) = 2^23 + c as a float's bits, less zsub = magic(z)
//      (the symmetric offset or the uint8 zero point: the zero term sits in
//      the subtrahend, so c - z is exact), a byte by one prmt; fp8 codes by
//      a paired conversion (exact into half); no integer-to-float
//      conversion instruction per weight.
//    - M <= 8 with bf16 x, and every M with float32 x (blocks of 8 rows in
//      gridDim.z): CUDA cores, x staged in shared memory as float32 and the
//      value computed in float32 exactly as the plain version does (s * t,
//      or t * s + m rounded after each step for float offsets, a template
//      flag); K split across blocks (gridDim.y), the float32 partials summed
//      in order by a second kernel (splitk_reduce_kernel).  One-plane and
//      byte formats: a thread owns four columns (a 16-byte word row, 4
//      bytes of a byte row), 8 rows a chunk, each band's scales and zero
//      terms loaded once a chunk for the 4 columns.  Multi-plane formats:
//      a thread owns one column, holds R1 rows of every plane (8, or 4 at
//      more than 3 words a row) and the scale and zero term of each band in
//      registers until the band's group changes (`next_any`).
//    - 8 < M <= 32 with bf16 x: tensor cores, every row in one pass
//      (gemv_mma_kernel: mma.sync m16n8k8 in TF32, one or two m16 tiles of
//      rows as A, the weights as B; notes at the kernel).  Numerics: x is
//      bf16 and every B term is exact in TF32 (c - z with |c - z| <= 255;
//      2c - 1; fp8 values), so each MMA forms exact products over 8 rows of
//      one band inside one group, summed in float32; the group's scale then
//      multiplies that float32 partial, and float offsets add m * (the
//      rows' sum of x over the k-step, by an MMA with B = 1).  Table formats
//      (NF4 / FP4 / a converter's table) take each float32 entry as a bf16
//      hi + lo pair (two MMAs; within 2^-17 of the entry).  So no weight is
//      rounded to bf16: only the order and place of the float32 roundings
//      differ from the plain version's.  K is split over the blocks of a
//      thread-block cluster (at most 8) whose partials are summed in rank
//      order through distributed shared memory: no second kernel.
//  * GEMM, M > 32.  Bound: operations (bf16 tensor cores).  The wrapper
//    hands x with K reordered band-major (k' = r * EF + b), so a K step of
//    64 is 64 / EF word rows of the narrowest plane with all their bands:
//    x's tile is a plain [BM, 64] box and no packed word is read twice per
//    output tile.  Each weight is computed in float32 exactly as the plain
//    version does (int_value / fp8_value / the table, times its scale) and
//    rounded once to bf16; only the order of the float32 sums differs.
//    One block of 640 threads per SM takes a 128 x 128 tile (64 x 128 for
//    the grouped bm = 64), warp-specialised:
//      - warpgroup 0: two threads keep TMA loads in flight into rings in
//        shared memory, one for x (bf16 [M, K], 128-byte swizzle, 5
//        stages), one for the packed planes as stored (each a 4-D map over
//        (N, rows of a band block, band blocks, experts) of uint32 words or
//        bytes, 6 stages, so W runs ahead of x), completion on mbarriers.
//        Byte rows whose stride is not a multiple of 16 bytes (N % 16 != 0)
//        cannot be a TMA map: there the dequantizing threads read their
//        words from global memory;
//      - warpgroups 1-2 dequantize: each thread turns 32 codes of a stage
//        into bf16 and writes them, 16 bytes at a time, into a 4-stage
//        ring of W tiles in the 128-byte-swizzled K-major layout that
//        wgmma reads (a transposed tile of 128 columns x 64 k').  Each
//        thread holds the scale and zero term of its (group, column)s in
//        registers and reloads one only when its band's group changes
//        (once per group: at Llama's K = 4096 and g = 128 a 32-band pack
//        loads each band's scale once for the whole K loop), issued after
//        the previous step's stores so the load's latency is hidden; no
//        load per weight remains.  Each thread takes 32 codes a step (8 or
//        16 bands of 4 or 2 rows): with 16 the per-band state is all the
//        registers the 640-thread block allows (96), so nothing else per
//        band is kept.  Integer codes become floats by an exponent trick,
//        fp8 pairs by one paired conversion, not one instruction each;
//      - warpgroups 3-4 multiply: wgmma m64n128k16 (m64n64k16 at bm = 64)
//        from both tiles in shared memory into float32 registers, one
//        group in flight while the next stage is awaited; the output goes
//        from the accumulators to global memory 16 bytes per store after
//        a shuffle within each lane quad (bf16, or float32 for the grouped
//        instances).
//    Dequantization is off the MMA's critical path by a transform
//    warpgroup pair rather than by the mixed-input scheme (out^T = W^T x^T
//    with W as wgmma's register operand): the pack is read as stored, and
//    a thread's natural unit is one word = 8-32 consecutive k' of one
//    column, which is a 16-byte row chunk of the K-major tile but would
//    have to be scattered over the register fragment's k pairs.  The
//    transform and MMA warps overlap through the W ring; loads, dequant
//    and products of different steps run at once.
//
// Float32 activations (`_f32` entries; the output is float32 too):
//  * GEMV: the CUDA-core body at every M <= 32 (x's pointer type a template
//    parameter, XT); x is staged as float32 either way, so only the global
//    load differs, and the product is float32 end to end, never rounded to
//    bf16 and never on the tensor cores.
//  * GEMM (M > 32): tc::gemm_tf32x3_kernel, 3xTF32 on the tensor cores,
//    within float32-level error (chip_smoke.py's check_f32_formats: 256
//    float32 ulps of the largest output against a float64 product of the
//    same weight, which a single TF32 product fails).  Each operand v is
//    split into TF32 hi = rna(v) and lo = rna(v - hi) (hi + lo is v or one
//    float32 ulp away) and each k8 step forms lo_x hi_w + hi_x lo_w +
//    hi_x hi_w, small terms first (lo_x lo_w, below 2^-22 of a product, is
//    left out).  The tensor cores truncate each wgmma's sum into the
//    accumulator (chip_levers.py --acc: 0.75 ulp of 1.0 added is dropped),
//    so over a whole K the sum drifts toward zero by about half an ulp per
//    wgmma (1.0-1.4 tolerances at K = 4096-5120); each K step of 32 k'
//    therefore starts a fresh accumulator and adds it into a float32 total
//    (to nearest), which keeps the error near 0.02 tolerances.  Bound:
//    operations at three TF32 products (the bf16 peak / 6).  128 x 128
//    tiles, K steps of 32 k' over the same band-major x as the bf16 GEMM
//    (one 128-byte swizzle row of float32), 384 threads (12 warps leave 168
//    registers a thread: the accumulator and the total take 64 each):
//      - warpgroup 0 dequantizes with the bf16 GEMM's transforms (`Ring`:
//        one warpgroup takes every band and row of a step) and writes each
//        weight as a TF32 pair into K-major 128-byte-swizzled hi and lo
//        tiles (wgmma cannot transpose 32-bit operands); its thread 0 keeps
//        the packs' TMA loads 4 steps ahead on the bf16 GEMM's plane maps;
//      - warpgroups 1-2 take 64 rows each: each loads its own rows of x
//        (TMA, float32 boxes of 32 x 64 in the 128-byte swizzle, 4 steps
//        ahead), reads a k8 step's A fragment from them, splits it in
//        registers and issues the three m64n128k8 products with A from
//        registers and W's pair from shared memory, one k8 step's group in
//        flight while the next is read.
//    Shared memory: x 4 x 16 KB, W pairs 4 x 32 KB, packs 6 x 4 KB (217
//    KB, one block per SM).  Each output is written once by one thread and
//    its sums run in a fixed order: the same inputs give the same bytes.
//
// Grouped instances (GROUPED = true, one-plane and byte formats; float32
// out): experts stacked on a leading axis of the planes, scales and zeros.
// The GEMV takes one row per block row (gridDim.z) and that row's expert
// from a per-row map; the GEMM's M tile is one block of the sorted rows
// (64 * MI = the routing's bm), its expert read from block_expert and its
// planes' boxes taken at that expert's coordinate; rows past its live ones
// are written as zeros, and a tile with none writes zeros and stops.
// Grouped-only code is compile-time, so the F and P instances are as before.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <climits>
#include <cooperative_groups.h>
#include <type_traits>

namespace nstfp {

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

// fn(std::integral_constant<int, I>) for I = I0 .. N - 1: a loop whose index
// is a constant expression (plane indices: a slot index computed in a
// runtime loop can leave a word array in local memory).
template <int I, int N, typename Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (I < N) {
    fn(std::integral_constant<int, I>{});
    static_for<I + 1, N>(fn);
  }
}

// The code of band b from the words of one row of the narrowest plane:
// w[slot] is the word of plane p at row (slot - slot0(p)) * KW + r.
template <int FMT, int P = 0>
__device__ __forceinline__ uint32_t code_of(const uint32_t* w, int b) {
  using F = Fmt<FMT>;
  if constexpr (P >= F::kPlanes) {
    return 0u;
  } else {
    constexpr int W = F::width(P), q = F::q(P), s0 = F::slot0(P), sh = F::shift(P);
    const uint32_t word = w[s0 + b % q];
    return (((word >> (W * (b / q))) & ((1u << W) - 1u)) << sh) | code_of<FMT, P + 1>(w, b);
  }
}

// The same for a band b known only at run time but with b % 4 == BI (every
// plane's q divides 4): the word's slot stays a constant.
template <int FMT, int BI, int P = 0>
__device__ __forceinline__ uint32_t code_of_rt(const uint32_t* w, int b) {
  using F = Fmt<FMT>;
  if constexpr (P >= F::kPlanes) {
    return 0u;
  } else {
    constexpr int W = F::width(P), q = F::q(P), s0 = F::slot0(P), sh = F::shift(P);
    static_assert(4 % q == 0, "a plane's q divides 4");
    const uint32_t word = w[s0 + BI % q];
    return (((word >> (W * (b / q))) & ((1u << W) - 1u)) << sh) |
           code_of_rt<FMT, BI, P + 1>(w, b);
  }
}

// ---------------------------------------------------------------- GEMV ---
// Decode shared by the GEMV bodies (see the note at the top of the file).

// 2^23 + c as a float (c < 2^23): an integer code as a float without a
// conversion instruction; magic(c) - magic(z) is c - z exactly.
__device__ __forceinline__ float magic(uint32_t c) {
  return __int_as_float(0x4B000000u | c);
}

// The term of an integer code that its scale multiplies: code - z as
// magic(code) - zsub, zsub = magic(z) (z the symmetric offset or the uint8
// zero point; 0 for float offsets, whose term is the code), or 2 * code - 1
// for INT1 whatever the zero points.  Exact: |term| <= 255.
template <int FMT>
__device__ __forceinline__ float int_term(uint32_t code, float zsub) {
  if constexpr (FMT == FMT_INT1) return magic(code << 1) - 8388609.f;
  else return magic(code) - zsub;
}

// Byte j of w as magic(byte): one prmt.
__device__ __forceinline__ float magic_byte(uint32_t w, int j) {
  return __int_as_float(__byte_perm(w, 0x4B00u, 0x5440u | (uint32_t)j));
}

// The zero term of a (group, column): zsub for int_term (Z_NONE, Z_SYM,
// Z_INT) or the float offset m (Z_FLOAT).
__device__ __forceinline__ float zero_term_of(const PackArgs& a, size_t idx, uint32_t sym) {
  if (a.zmode == Z_FLOAT) return __ldg(static_cast<const float*>(a.zeros) + idx);
  if (a.zmode == Z_INT) return magic(static_cast<const uint8_t*>(a.zeros)[idx]);
  return magic(a.zmode == Z_SYM ? sym : 0u);
}

// Four neighbouring columns' zero terms (idx % 4 == 0), one load.
__device__ __forceinline__ void zero_terms4(const PackArgs& a, size_t idx, uint32_t sym,
                                            float z[4]) {
  if (a.zmode == Z_FLOAT) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.zeros) + idx));
    z[0] = v.x; z[1] = v.y; z[2] = v.z; z[3] = v.w;
  } else if (a.zmode == Z_INT) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
        static_cast<const uint8_t*>(a.zeros) + idx));
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = magic_byte(v, j);
  } else {
    z[0] = z[1] = z[2] = z[3] = magic(a.zmode == Z_SYM ? sym : 0u);
  }
}

// A weight from its term t, scale s and zero term z: s * t, or with float
// offsets t * s + m rounded after each step, as the plain version's two
// float32 operations are.
template <bool ZF>
__device__ __forceinline__ float dq_value(float t, float s, float z) {
  if constexpr (ZF) return __fadd_rn(__fmul_rn(t, s), z);
  else return s * t;
}

// Two fp8 codes (the low 16 bits of v) as floats, one paired conversion
// (exact into half, then into float).
template <int FMT>
__device__ __forceinline__ float2 fp8x2_value(uint32_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(v & 0xFFFFu),
                                                   FMT == FMT_E4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// The group row of band b's word row r: b * KW / g + r / g when g divides
// KW (rq = r / g, one division per row step), else (b * KW + r) / g.
__device__ __forceinline__ int group_of(int b, int r, int rq, int KW, int kwg, int g) {
  return kwg >= 0 ? b * kwg + rq : (b * KW + r) / g;
}

// ------------------------------------------------- GEMV, CUDA cores ---
// M <= 8 (bf16 x), or any M <= 32 with float32 x: one launch, MT rows per
// block row (gridDim.z blocks of rows); K split across blocks (gridDim.y),
// partials summed by splitk_reduce_kernel.
constexpr int GEMV_THREADS = 128;
constexpr int GEMV_COLS = 4;
constexpr int GEMV_BN = GEMV_THREADS * GEMV_COLS;
constexpr int GEMV_SIMT_MAX_M = 8;

// Blocks an SM gemv1_kernel is built for: register caps of 128 (one row)
// and 170 (more; 255 for int7 at 8 rows, which spilled at 170: a cap of 255
// for the others took every register and lost occupancy).
__host__ __device__ constexpr int simt1_min_blocks(int fmt, int mt) {
  return mt == 1 ? 4 : mt == 8 && fmt == FMT_INT7 ? 2 : 3;
}

// x rows m0.. of the split's K range into shared memory as float32,
// [MT][EF][rows_per_split] (band b, row r: x[m][b * KW + kb0 + r]).
template <int MT, int EF, typename XT>
__device__ __forceinline__ void stage_x(const XT* x, float* xs, int m0, int M, int K, int KW,
                                        int kb0, int nrows, int rows_per_split) {
  for (int idx = threadIdx.x; idx < MT * EF * rows_per_split; idx += GEMV_THREADS) {
    const int r = idx % rows_per_split;
    const int band = (idx / rows_per_split) % EF;
    const int m = idx / (EF * rows_per_split);
    float v = 0.f;
    if (m0 + m < M && r < nrows) v = x_value(x, (size_t)(m0 + m) * K + band * KW + kb0 + r);
    xs[idx] = v;
  }
}

// One-plane and byte formats: four columns per thread (a 16-byte word row,
// or 4 bytes of a byte row), 8 rows per chunk, the chunk's scales and zero
// terms of each band loaded once (4 columns per load).  The grouped
// instance (MT = 1) takes row m0 + blockIdx.z and its expert.
template <int FMT, int MT, bool GROUPED, typename OutT, typename XT, bool ZF>
__device__ __forceinline__ void gemv_body(const XT* __restrict__ x, PackArgs a,
                                          const int* __restrict__ row_expert,
                                          float* __restrict__ partial, OutT* __restrict__ out,
                                          int M, int K, int N, int g, int rows_per_split,
                                          int m0) {
  using F = Fmt<FMT>;
  static_assert(F::kSlots == 1, "multi-plane formats go through gemv1_kernel");
  static_assert(!GROUPED || MT == 1, "the grouped GEMV takes one row per block row");
  constexpr int EF = F::kBands, R = MT == 8 ? 4 : 8;
  extern __shared__ float xs[];  // [MT][EF][rows_per_split]
  __shared__ float tab[16];
  m0 += blockIdx.z * MT;
  if constexpr (GROUPED) select_expert<FMT>(a, row_expert[m0], K, N, g);
  const int KW = K / EF;
  const int kwg = KW % g == 0 ? KW / g : -1;
  const int split = blockIdx.y;
  const int kb0 = split * rows_per_split;
  const int nrows = max(0, min(kb0 + rows_per_split, KW) - kb0);
  const int n = (blockIdx.x * GEMV_THREADS + threadIdx.x) * GEMV_COLS;

  stage_x<MT, EF>(x, xs, m0, M, K, KW, kb0, nrows, rows_per_split);
  if (F::kLut && threadIdx.x < 16) tab[threadIdx.x] = a.table[threadIdx.x];
  __syncthreads();
  if (n >= N) return;

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = 0.f;
  const uint32_t sym = 1u << (F::kBits - 1);
  constexpr bool zf = ZF;

  for (int c = 0; c < nrows; c += R) {
    const int kb = kb0 + c;
    const int rq = kb / g;
    if constexpr (F::kByte) {
      uint32_t w[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        w[i] = __ldg(reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const uint8_t*>(a.plane[0]) + (size_t)(kb + i) * N + n));
      const size_t sidx = (size_t)rq * N + n;
      float s[4], z[4], zs[4];
      scales4(a, sidx, s);
      if constexpr (!F::kFp8) {
        zero_terms4(a, sidx, sym, z);
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) zs[j] = zf ? 8388608.f : z[j];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float wv[GEMV_COLS];
        if constexpr (F::kFp8) {
          const float2 lo = fp8x2_value<FMT>(w[i]), hi = fp8x2_value<FMT>(w[i] >> 16);
          wv[0] = lo.x * s[0];
          wv[1] = lo.y * s[1];
          wv[2] = hi.x * s[2];
          wv[3] = hi.y * s[3];
        } else {
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j)
            wv[j] = dq_value<ZF>(magic_byte(w[i], j) - zs[j], s[j], z[j]);
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
        const size_t sidx = (size_t)group_of(b, kb, rq, KW, kwg, g) * N + n;
        float s[4], z[4] = {0.f, 0.f, 0.f, 0.f}, zs[4] = {0.f, 0.f, 0.f, 0.f};
        scales4(a, sidx, s);
        if constexpr (!F::kLut && FMT != FMT_INT1) {  // INT1: 2c - 1 whatever the zeros
          zero_terms4(a, sidx, sym, z);
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) zs[j] = zf ? 8388608.f : z[j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float wv[GEMV_COLS];
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) {
            const uint32_t code =
                (lane4(w[i], j) >> (F::kBits * b)) & ((1u << F::kBits) - 1u);
            if constexpr (F::kLut)
              wv[j] = tab[code] * s[j];
            else if constexpr (FMT == FMT_INT1)  // s * (2c - 1): s, its sign flipped at c = 0
              wv[j] = __uint_as_float(__float_as_uint(s[j]) ^
                                      ((~lane4(w[i], j) << (31 - b)) & 0x80000000u));
            else
              wv[j] = dq_value<ZF>(int_term<FMT>(code, zs[j]), s[j], z[j]);
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

// Register caps (blocks an SM): 128 (4) at one row and at 8 rows (4-row
// chunks), at 4 rows 102 (5) for the table and 170 (3) for the rest.
// Without a cap ptxas took 64-80 registers and spilled INT1 / INT8 at one
// row, and 218-224 at 8 rows (8-row chunks: 2 blocks an SM); at a cap of
// 102 the 4-row INT1 / INT2 / INT4 instances spilled.  `matmul.fp_gemv_simt_per_sm` sizes the grid to the
// same counts.
__host__ __device__ constexpr int simt_min_blocks(int fmt, int mt) {
  return mt == 4 ? (fmt == FMT_LUT4 ? 5 : 3) : 4;
}
template <int FMT, int MT, bool GROUPED = false, typename OutT = __nv_bfloat16,
          typename XT = __nv_bfloat16, bool ZF = false>
__global__ void __launch_bounds__(GEMV_THREADS, 4)
gemv_row_kernel(const XT* __restrict__ x, PackArgs a, const int* __restrict__ row_expert,
                float* __restrict__ partial, OutT* __restrict__ out, int M, int K, int N,
                int g, int rows_per_split, int m0) {
  gemv_body<FMT, MT, GROUPED, OutT, XT, ZF>(x, a, row_expert, partial, out, M, K, N, g,
                                            rows_per_split, m0);
}
template <int FMT, int MT, typename OutT, typename XT, bool ZF>
__global__ void __launch_bounds__(GEMV_THREADS, simt_min_blocks(FMT, MT))
gemv_kernel(const XT* __restrict__ x, PackArgs a, float* __restrict__ partial,
            OutT* __restrict__ out, int M, int K, int N, int g, int rows_per_split, int m0) {
  gemv_body<FMT, MT, false, OutT, XT, ZF>(x, a, nullptr, partial, out, M, K, N, g,
                                          rows_per_split, m0);
}

// Multi-plane GEMV: one column per thread, R1 rows of every plane in
// registers a chunk (8 at one row of x and at most 3 words a row, else 4),
// and the scale and zero term of each band held in registers until the
// band's group changes: a band is reloaded at the first row of its group
// (`next_any`: the first row at which any band enters a new group).
template <int FMT, int MT, typename XT, typename OutT, bool ZF>
__global__ void __launch_bounds__(GEMV_THREADS, simt1_min_blocks(FMT, MT))
gemv1_kernel(const XT* __restrict__ x, PackArgs a, float* __restrict__ partial,
             OutT* __restrict__ out, int M, int K, int N, int g, int rows_per_split,
             int m0) {
  using F = Fmt<FMT>;
  constexpr int EF = F::kBands, R1 = F::kSlots > 3 || MT > 1 ? 4 : 8;
  extern __shared__ __align__(16) float xs1[];  // [MT][EF][rows_per_split]
  m0 += blockIdx.z * MT;
  const int KW = K / EF;
  const int kwg = KW % g == 0 ? KW / g : -1;
  const int split = blockIdx.y;
  const int kb0 = split * rows_per_split;
  const int nrows = max(0, min(kb0 + rows_per_split, KW) - kb0);
  const int n = blockIdx.x * GEMV_THREADS + threadIdx.x;

  stage_x<MT, EF>(x, xs1, m0, M, K, KW, kb0, nrows, rows_per_split);
  __syncthreads();
  if (n >= N) return;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  const uint32_t sym = 1u << (F::kBits - 1);
  constexpr bool zf = ZF;
  float sc[EF], zt[EF];
  int next_any = 0;
  auto reload = [&](int kb, bool first) {
    const int rq = kb / g;
    int nxt = INT_MAX;
#pragma unroll
    for (int b = 0; b < EF; ++b) {
      const int G = group_of(b, kb, rq, KW, kwg, g);
      const int start = G * g - b * KW;  // the group's first row in band b
      if (first || start == kb) {
        sc[b] = scale_at(a, (size_t)G * N + n);
        zt[b] = zero_term_of(a, (size_t)G * N + n, sym);
      }
      nxt = min(nxt, start + g);
    }
    next_any = nxt;
  };
  // the R1 word rows of every plane from kb
  auto load = [&](int kb, uint32_t (&w)[R1][F::kSlots]) {
#pragma unroll
    for (int i = 0; i < R1; ++i)
      static_for<0, F::kPlanes>([&](auto pc) {
        constexpr int p = decltype(pc)::value;
#pragma unroll
        for (int jq = 0; jq < F::q(p); ++jq)
          w[i][F::slot0(p) + jq] = __ldg(a.plane[p] + (size_t)(jq * KW + kb + i) * N + n);
      });
  };
  for (int c = 0; c < nrows; c += R1) {
    const int kb = kb0 + c;
    uint32_t w[R1][F::kSlots];
    load(kb, w);
    if (c == 0 || kb >= next_any) reload(kb, c == 0);
#pragma unroll
    for (int b = 0; b < EF; ++b) {
      const float zs = zf ? 8388608.f : zt[b];
      float wv[R1];
#pragma unroll
      for (int i = 0; i < R1; ++i)
        wv[i] = dq_value<ZF>(int_term<FMT>(code_of<FMT>(w[i], b), zs), sc[b], zt[b]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* xp = &xs1[(m * EF + b) * rows_per_split + c];
        float t = acc[m];
#pragma unroll
        for (int i4 = 0; i4 < R1; i4 += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xp + i4);
          t = fmaf(xv.x, wv[i4], t);
          t = fmaf(xv.y, wv[i4 + 1], t);
          t = fmaf(xv.z, wv[i4 + 2], t);
          t = fmaf(xv.w, wv[i4 + 3], t);
        }
        acc[m] = t;
      }
    }
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

// Formats whose packs may carry float offsets (w = code * s + m).
template <int FMT>
constexpr bool takes_offsets() {
  return FMT != FMT_INT1 && !Fmt<FMT>::kLut && !Fmt<FMT>::kFp8;
}

// One launch over every row: MT rows per block row, (M + MT - 1) / MT block
// rows.
template <int FMT, int MT, typename XT, typename OutT, bool ZF>
cudaError_t launch_gemv_zf(const XT* x, const PackArgs& a, float* partial, OutT* out, int M,
                           int K, int N, int g, int splits, cudaStream_t stream) {
  const int KW = K / Fmt<FMT>::kBands;
  const int rows = ((KW + splits - 1) / splits + 7) / 8 * 8;
  const size_t smem = (size_t)MT * Fmt<FMT>::kBands * rows * sizeof(float);
  const int zg = (M + MT - 1) / MT;
  if constexpr (Fmt<FMT>::kSlots > 1) {
    dim3 grid((N + GEMV_THREADS - 1) / GEMV_THREADS, splits, zg);
    gemv1_kernel<FMT, MT, XT, OutT, ZF><<<grid, GEMV_THREADS, smem, stream>>>(
        x, a, partial, out, M, K, N, g, rows, 0);
  } else {
    dim3 grid((N + GEMV_BN - 1) / GEMV_BN, splits, zg);
    if constexpr (MT == 1)
      gemv_row_kernel<FMT, MT, false, OutT, XT, ZF><<<grid, GEMV_THREADS, smem, stream>>>(
          x, a, nullptr, partial, out, M, K, N, g, rows, 0);
    else
      gemv_kernel<FMT, MT, OutT, XT, ZF><<<grid, GEMV_THREADS, smem, stream>>>(
          x, a, partial, out, M, K, N, g, rows, 0);
  }
  return cudaGetLastError();
}

template <int FMT, int MT, typename XT, typename OutT>
cudaError_t launch_gemv(const XT* x, const PackArgs& a, float* partial, OutT* out, int M,
                        int K, int N, int g, int splits, cudaStream_t stream) {
  if constexpr (takes_offsets<FMT>()) {
    if (a.zmode == Z_FLOAT)
      return launch_gemv_zf<FMT, MT, XT, OutT, true>(x, a, partial, out, M, K, N, g, splits,
                                                     stream);
  }
  return launch_gemv_zf<FMT, MT, XT, OutT, false>(x, a, partial, out, M, K, N, g, splits,
                                                  stream);
}

// ------------------------------------------------ GEMV, tensor cores ---
// 8 < M <= 32, bf16 x: every row in one pass over the pack, mma.sync
// m16n8k8 in TF32 on exact operands (note at the top of the file).  A warp
// takes 32 columns, MMA column j of n-tile jn being column c0 + 4j + jn, so
// a lane's four B columns of a word row are one 16-byte load (4 bytes for
// byte rows); a step is SR word rows of the narrowest plane with all their
// bands, SR / 8 k-steps of 8 rows each, the MMA's k index t / t + 4 being
// word row 2t / 2t + 1 of the k-step.  Lane (gq, t) then holds output
// columns c0 + 8t .. c0 + 8t + 7 of rows gq and gq + 8 of each m-tile.
// x's step (the SR rows of every band, rows past M zero) and the scale and
// zero rows of the groups the step's rows lie in are staged in shared
// memory by cp.async, double-buffered (per-lane loads of each band's
// factors took about 44% of the body's time on an H100, PERF.md §6); the
// lane's packed words of the next step are loaded while this one is
// computed.  K is split over the blocks of a thread-block cluster
// (gridDim.y = cluster size <= 8), whose float32 partials are summed in
// rank order through distributed shared memory.
constexpr int MMA_WARPS = 4;
constexpr int MMA_BN = 32 * MMA_WARPS;  // columns per block
constexpr int MMA_MAX_SPLITS = 8;

template <int FMT>
struct MmaStep {
  static constexpr int EF = Fmt<FMT>::kBands;
  static constexpr int SR = EF >= 16 ? 8 : 128 / EF;  // word rows per step
  static constexpr int SUB = SR / 8;                   // k-steps per step
};

// A stage: x's SR word rows of every band (rows past M zero), then the
// scale rows and zero rows of the groups each band's rows of the step lie
// in (at most SR / 8 a band: row b * SR / 8 + i holds band b's i-th group
// of the step) for the block's columns, as stored (bf16 or float32
// scales; uint8 zero points, or float offsets with ZF), then after both
// stages the split's partials.
template <int FMT, int MT16, bool ZF, bool SBF>
struct MmaSmem {
  static constexpr int EF = Fmt<FMT>::kBands, SR = MmaStep<FMT>::SR;
  static constexpr int MP = 16 * MT16;  // rows of the m-tiles
  // one row's x, [EF][SR] bf16, padded by 16 bytes so that the 8 rows a
  // warp reads at once fall in different banks
  static constexpr int XROW = EF * SR * 2 + 16;
  static constexpr int ROWS = EF * (SR / 8);  // factor rows: SR / 8 a band
  static constexpr int ES = SBF ? 2 : 4, EZ = ZF ? 4 : 1;
  static constexpr int S = MP * XROW;
  static constexpr int Z = S + ROWS * MMA_BN * ES;
  static constexpr int STAGE = Z + ROWS * MMA_BN * EZ;
  static constexpr int PART = MP * MMA_BN * 4;  // the split's partials
  static constexpr int BYTES = 2 * STAGE + PART;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// d += a * b: m16n8k8, TF32 operands, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ZF: float offsets (w = code * s + m): the MMA takes the codes, and
// m * (the rows' sums of x over the k-step) is added beside s * product.
// SBF: bf16 scales (else float32).
template <int FMT, int MT16, bool ZF, bool SBF>
__global__ void __launch_bounds__(32 * MMA_WARPS, 1)
gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, PackArgs a,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int g) {
  using F = Fmt<FMT>;
  using L = MmaSmem<FMT, MT16, ZF, SBF>;
  constexpr int EF = F::kBands, SR = MmaStep<FMT>::SR, SUB = MmaStep<FMT>::SUB;
  constexpr int NS = F::kSlots, NW = F::kByte ? 1 : 4;  // words of a row / columns a word
  extern __shared__ __align__(16) unsigned char msm[];
  float* part = reinterpret_cast<float*>(msm + 2 * L::STAGE);  // [MP][MMA_BN]
  __shared__ uint32_t tab_hl[16];  // LUT4: each entry as bf16 hi (low half) + lo
  const int S = gridDim.y, split = blockIdx.y;
  const int KW = K / EF;
  const int kwg = KW % g == 0 ? KW / g : -1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int ncb = blockIdx.x * MMA_BN, c0 = ncb + 32 * warp;
  const int n4 = c0 + 4 * gq;  // B columns n4 + jn
  const int n8 = c0 + 8 * t;   // C columns n8 + 4e + jn
  const bool live4 = n4 < N;
  const bool zint = a.zmode == Z_INT;
  const int RS = ((KW + S - 1) / S + 7) / 8 * 8;
  const int rlo = min(split * RS, KW), rhi = min(rlo + RS, KW);
  const int steps = (rhi - rlo + SR - 1) / SR;
  const uint32_t sym = 1u << (F::kBits - 1);

  // rows M.. of both stages stay zero; cp.async fills rows < M
  for (int i = threadIdx.x; i < 2 * L::STAGE / 16; i += 32 * MMA_WARPS) {
    const int off = i * 16 % L::STAGE;
    if (off < L::S && off / L::XROW >= M)
      reinterpret_cast<uint4*>(msm)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (F::kLut) {
    if (threadIdx.x < 16) {
      const float v = a.table[threadIdx.x];
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
      tab_hl[threadIdx.x] = (uint32_t)__bfloat16_as_ushort(hi) |
                            ((uint32_t)__bfloat16_as_ushort(lo) << 16);
    }
  }
  // the step at word row r0 into stage `buf`: x (16 bytes = 8 rows of a
  // band), then each k-step's scale and zero rows of the block's columns
  auto stage = [&](int r0, int buf) {
    unsigned char* st = msm + buf * L::STAGE;
    constexpr int CH = SR / 8;
    for (int idx = threadIdx.x; idx < M * EF * CH; idx += 32 * MMA_WARPS) {
      const int m = idx / (EF * CH), b = (idx / CH) % EF, q = idx % CH;
      const int r = r0 + 8 * q;
      const bool ok = r < rhi;
      cp_async16(st + m * L::XROW + (b * SR + 8 * q) * 2,
                 ok ? (const void*)(x + (size_t)m * K + b * KW + r) : (const void*)x,
                 ok ? 16 : 0);
    }
    const unsigned char* sc = static_cast<const unsigned char*>(a.scales);
    const unsigned char* zp = static_cast<const unsigned char*>(a.zeros);
    const int rend = min(r0 + SR, rhi), rq0 = r0 / g, rq1 = (rend - 1) / g;
    // factor row b * SUB + i: group G0(b) + i, up to band b's last group
    // of the step
    auto row_group = [&](int idx, int per, int& slot) {
      const int b = idx / (SUB * per), i = (idx / per) % SUB;
      const int G0 = group_of(b, r0, rq0, KW, kwg, g);
      slot = b * SUB + i;
      return G0 + i <= group_of(b, rend - 1, rq1, KW, kwg, g) ? G0 + i : -1;
    };
    constexpr int SQ = MMA_BN * L::ES / 16;  // 16-byte chunks of a scale row
    for (int idx = threadIdx.x; idx < EF * SUB * SQ; idx += 32 * MMA_WARPS) {
      int slot;
      const int G = row_group(idx, SQ, slot), q = idx % SQ, c = ncb + q * (16 / L::ES);
      if (G < 0) continue;
      const bool ok = c < N;
      cp_async16(st + L::S + slot * MMA_BN * L::ES + q * 16,
                 ok ? (const void*)(sc + ((size_t)G * N + c) * L::ES) : a.scales, ok ? 16 : 0);
    }
    if constexpr (ZF) {
      constexpr int ZQ = MMA_BN * 4 / 16;
      for (int idx = threadIdx.x; idx < EF * SUB * ZQ; idx += 32 * MMA_WARPS) {
        int slot;
        const int G = row_group(idx, ZQ, slot), c = ncb + 4 * (idx % ZQ);
        if (G < 0) continue;
        const bool ok = c < N;
        cp_async16(st + L::Z + slot * MMA_BN * 4 + 16 * (idx % ZQ),
                   ok ? (const void*)(zp + ((size_t)G * N + c) * 4) : a.zeros, ok ? 16 : 0);
      }
    } else if (zint) {
      constexpr int ZQ = MMA_BN / 4;  // 4 zero points a copy
      for (int idx = threadIdx.x; idx < EF * SUB * ZQ; idx += 32 * MMA_WARPS) {
        int slot;
        const int G = row_group(idx, ZQ, slot), c = ncb + 4 * (idx % ZQ);
        if (G < 0) continue;
        const bool ok = c < N;
        cp_async4(st + L::Z + slot * MMA_BN + 4 * (idx % ZQ),
                  ok ? (const void*)(zp + (size_t)G * N + c) : a.zeros, ok ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the lane's words of the step at r0: k-step j, word row 2t + u
  auto load = [&](int r0, uint32_t (&w)[SUB][2][NS][NW]) {
#pragma unroll
    for (int j = 0; j < SUB; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + 8 * j + 2 * t + u;
        const bool ok = live4 && r0 + 8 * j < rhi;
        if constexpr (F::kByte) {
          w[j][u][0][0] = ok ? __ldg(reinterpret_cast<const uint32_t*>(
                                   reinterpret_cast<const uint8_t*>(a.plane[0]) +
                                   (size_t)r * N + n4))
                             : 0u;
        } else {
          static_for<0, F::kPlanes>([&](auto pc) {
            constexpr int p = decltype(pc)::value;
#pragma unroll
            for (int jq = 0; jq < F::q(p); ++jq) {
              const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(
                                       a.plane[p] + (size_t)(jq * KW + r) * N + n4))
                                 : make_uint4(0u, 0u, 0u, 0u);
              uint32_t* d = w[j][u][F::slot0(p) + jq];
              d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
            }
          });
        }
      }
  };

  float acc[MT16][4][4];
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;
  uint32_t w[SUB][2][NS][NW], wn[SUB][2][NS][NW];
  __syncthreads();  // the zeroed rows and the table, before any cp.async lands
  if (steps > 0) {
    stage(rlo, 0);
    load(rlo, w);
  }
  for (int s = 0; s < steps; ++s) {
    const int r0 = rlo + s * SR;
    if (s + 1 < steps) {
      stage(r0 + SR, (s + 1) & 1);
      load(r0 + SR, wn);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const unsigned char* xs = msm + (s & 1) * L::STAGE;
    const float zconst = magic(a.zmode == Z_SYM ? sym : 0u);
    // the stage row of k-step j's group, counted from the step's first
    // group: where g divides the band rows (or one band), the same for
    // every band, by a countdown
    int offj[SUB];
    {
      int off = 0, left = g - r0 % g;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (8 * j >= left) {
          ++off;
          left += g;
        }
        offj[j] = off;
      }
    }
    // bands in blocks of BU, the block loop not unrolled: a word's slot
    // stays a constant (b % BU), and the live registers are one block's (32
    // bands unrolled took 255 registers and spilled)
    constexpr int BU = EF < 4 ? EF : 4;
#pragma unroll 1
    for (int b0 = 0; b0 < EF; b0 += BU) {
      static_for<0, BU>([&](auto bc) {
        constexpr int BI = decltype(bc)::value;
        const int b = b0 + BI;
        // the stage row of k-step J's group
        auto row_of = [&](auto jc) {
          constexpr int J = decltype(jc)::value;
          int row = b * SUB;
          if constexpr (SUB > 1)
            row += kwg >= 0 || EF == 1 ? offj[J] : ((b * KW + r0) % g + 8 * J) / g;
          return row;
        };
        // the scales of the C columns n8 .. n8 + 7 of a stage row
        auto scales_of = [&](int row, float (&s8)[8]) {
          if constexpr (SBF) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                xs + L::S + (row * MMA_BN + n8 - ncb) * 2);
            const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s8[2 * e] = __uint_as_float(w4[e] << 16);
              s8[2 * e + 1] = __uint_as_float(w4[e] & 0xFFFF0000u);
            }
          } else {
            const float4* sp = reinterpret_cast<const float4*>(
                xs + L::S + (row * MMA_BN + n8 - ncb) * 4);
            const float4 v0 = sp[0], v1 = sp[1];
            s8[0] = v0.x; s8[1] = v0.y; s8[2] = v0.z; s8[3] = v0.w;
            s8[4] = v1.x; s8[5] = v1.y; s8[6] = v1.z; s8[7] = v1.w;
          }
        };
        // ZF: the float offsets of the C columns of a stage row
        auto offsets_of = [&](int row, float (&m8)[8]) {
          const float4* mp = reinterpret_cast<const float4*>(
              xs + L::Z + (row * MMA_BN + n8 - ncb) * 4);
          const float4 v0 = mp[0], v1 = mp[1];
          m8[0] = v0.x; m8[1] = v0.y; m8[2] = v0.z; m8[3] = v0.w;
          m8[4] = v1.x; m8[5] = v1.y; m8[6] = v1.z; m8[7] = v1.w;
        };
        // k-step J's operands: B the terms of word rows 2t (k index t) and
        // 2t + 1 (t + 4) of the B columns n4 .. n4 + 3 (bl: the table's lo),
        // A x rows gq and gq + 8 of each m-tile
        auto operands = [&](auto jc, int row, uint32_t (&bt)[2][4], uint32_t (&bl)[2][4],
                            uint32_t (&af)[MT16][4]) {
          constexpr int J = decltype(jc)::value;
          float zs[4];
          if constexpr (!F::kLut && !F::kFp8) {
            if constexpr (ZF) {
              zs[0] = zs[1] = zs[2] = zs[3] = 8388608.f;
            } else {
              const uint32_t zb = zint ? *reinterpret_cast<const uint32_t*>(
                                             xs + L::Z + row * MMA_BN + n4 - ncb)
                                       : 0u;
#pragma unroll
              for (int jn = 0; jn < 4; ++jn) zs[jn] = zint ? magic_byte(zb, jn) : zconst;
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if constexpr (F::kFp8) {
              const float2 lo = fp8x2_value<FMT>(w[J][u][0][0]);
              const float2 hi = fp8x2_value<FMT>(w[J][u][0][0] >> 16);
              bt[u][0] = __float_as_uint(lo.x);
              bt[u][1] = __float_as_uint(lo.y);
              bt[u][2] = __float_as_uint(hi.x);
              bt[u][3] = __float_as_uint(hi.y);
            } else {
#pragma unroll
              for (int jn = 0; jn < 4; ++jn) {
                if constexpr (F::kByte) {
                  bt[u][jn] = __float_as_uint(magic_byte(w[J][u][0][0], jn) - zs[jn]);
                } else {
                  uint32_t cw[NS];
#pragma unroll
                  for (int q = 0; q < NS; ++q) cw[q] = w[J][u][q][jn];
                  const uint32_t code = code_of_rt<FMT, BI>(cw, b);
                  if constexpr (F::kLut) {  // one 4-byte read: both halves
                    const uint32_t hl = tab_hl[code];
                    bt[u][jn] = hl << 16;
                    bl[u][jn] = hl & 0xFFFF0000u;
                  } else {
                    bt[u][jn] = __float_as_uint(int_term<FMT>(code, zs[jn]));
                  }
                }
              }
            }
          }
#pragma unroll
          for (int i = 0; i < MT16; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t v = *reinterpret_cast<const uint32_t*>(
                  xs + (16 * i + gq + 8 * h) * L::XROW + (b * SR + 8 * J + 2 * t) * 2);
              af[i][h] = v << 16;
              af[i][h + 2] = v & 0xFFFF0000u;
            }
        };
        // each k-step's product times its group's scale (and offset)
        static_for<0, SUB>([&](auto jc) {
          constexpr int J = decltype(jc)::value;
          if (r0 + 8 * J < rhi) {
            const int row = row_of(jc);
            float s8[8];
            scales_of(row, s8);
            uint32_t bt[2][4], bl[2][4], af[MT16][4];
            operands(jc, row, bt, bl, af);
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
#pragma unroll
              for (int i = 0; i < MT16; ++i) {
                float dd[4] = {0.f, 0.f, 0.f, 0.f};
                mma_tf32(dd, af[i], bt[0][jn], bt[1][jn]);
                if constexpr (F::kLut) mma_tf32(dd, af[i], bl[0][jn], bl[1][jn]);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[i][jn][e] = fmaf(s8[4 * (e & 1) + jn], dd[e], acc[i][jn][e]);
              }
            if constexpr (ZF) {  // m * the sums of x, by an MMA with B = 1
              float m8[8];
              offsets_of(row, m8);
#pragma unroll
              for (int i = 0; i < MT16; ++i) {
                float dd[4] = {0.f, 0.f, 0.f, 0.f};
                mma_tf32(dd, af[i], 0x3F800000u, 0x3F800000u);
#pragma unroll
                for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    acc[i][jn][e] = fmaf(m8[4 * (e & 1) + jn], dd[e & 2], acc[i][jn][e]);
              }
            }
          }
        });
      });
    }
    __syncthreads();  // the stage is free for step s + 2
#pragma unroll
    for (int j = 0; j < SUB; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int q = 0; q < NS; ++q)
#pragma unroll
          for (int c = 0; c < NW; ++c) w[j][u][q][c] = wn[j][u][q][c];
  }

  // this split's partials: [row][column of the block]
#pragma unroll
  for (int i = 0; i < MT16; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(16 * i + gq + 8 * (e >> 1)) * MMA_BN + 32 * warp + 8 * t + 4 * (e & 1) + jn] =
            acc[i][jn][e];
  // the cluster's splits summed in rank order, each block a slice of the
  // columns
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int cols = MMA_BN / S, c_lo = split * cols;
  for (int idx = threadIdx.x; idx < M * cols; idx += 32 * MMA_WARPS) {
    const int row = idx / cols, col = c_lo + idx % cols;
    float v = 0.f;
    for (int rk = 0; rk < S; ++rk) v += cl.map_shared_rank(part, rk)[row * MMA_BN + col];
    if (ncb + col < N) out[(size_t)row * N + ncb + col] = __float2bfloat16_rn(v);
  }
  cl.sync();  // no block leaves while another reads its partials
}

template <int FMT, int MT16, bool ZF, bool SBF>
cudaError_t launch_gemv_mma(const __nv_bfloat16* x, const PackArgs& a, __nv_bfloat16* out,
                            int M, int K, int N, int g, int splits, cudaStream_t st) {
  constexpr int smem = MmaSmem<FMT, MT16, ZF, SBF>::BYTES;
  auto kernel = gemv_mma_kernel<FMT, MT16, ZF, SBF>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + MMA_BN - 1) / MMA_BN, splits, 1);
  cfg.blockDim = dim3(32 * MMA_WARPS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, a, out, M, K, N, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int FMT, int MT16, bool SBF>
cudaError_t launch_gemv_mma_z(const __nv_bfloat16* x, const PackArgs& a, __nv_bfloat16* out,
                              int M, int K, int N, int g, int splits, cudaStream_t st) {
  if constexpr (takes_offsets<FMT>()) {
    if (a.zmode == Z_FLOAT)
      return launch_gemv_mma<FMT, MT16, true, SBF>(x, a, out, M, K, N, g, splits, st);
  }
  return launch_gemv_mma<FMT, MT16, false, SBF>(x, a, out, M, K, N, g, splits, st);
}

template <int FMT, int MT16>
cudaError_t launch_gemv_mma_s(const __nv_bfloat16* x, const PackArgs& a, __nv_bfloat16* out,
                              int M, int K, int N, int g, int splits, cudaStream_t st) {
  return a.scale_bf16 ? launch_gemv_mma_z<FMT, MT16, true>(x, a, out, M, K, N, g, splits, st)
                      : launch_gemv_mma_z<FMT, MT16, false>(x, a, out, M, K, N, g, splits, st);
}

// bf16 x and out, or float32 x and out (XT = OutT = float): one GEMV launch
// per call (plus the reduce of the CUDA-core body's splits).  `splits`: the
// CUDA-core body's K splits, or the tensor-core body's cluster size (a power
// of 2 up to 8; 8 < M <= 32 with bf16 x).
template <int FMT, typename XT, typename OutT>
cudaError_t run_gemv(const XT* x, const PackArgs& a, float* partial, OutT* out, int M,
                     int K, int N, int g, int splits, cudaStream_t st) {
  if (M < 1 || M > 32) return cudaErrorInvalidValue;
  if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
    if (M > GEMV_SIMT_MAX_M) {
      if (splits < 1 || splits > MMA_MAX_SPLITS || (splits & (splits - 1)))
        return cudaErrorInvalidValue;
      return M > 16 ? launch_gemv_mma_s<FMT, 2>(x, a, out, M, K, N, g, splits, st)
                    : launch_gemv_mma_s<FMT, 1>(x, a, out, M, K, N, g, splits, st);
    }
  }
  cudaError_t err;
  if (M > 4)
    err = launch_gemv<FMT, 8, XT, OutT>(x, a, partial, out, M, K, N, g, splits, st);
  else if (M > 1)
    err = launch_gemv<FMT, 4, XT, OutT>(x, a, partial, out, M, K, N, g, splits, st);
  else
    err = launch_gemv<FMT, 1, XT, OutT>(x, a, partial, out, M, K, N, g, splits, st);
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
  gemv_row_kernel<FMT, 1, true, float><<<grid, GEMV_THREADS, smem, st>>>(
      x, a, row_expert, partial, out, M, K, N, g, rows, 0);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1) err = launch_reduce(partial, out, M, N, splits, st);
  return err;
}

// ---------------------------------------------------------------- GEMM ---
// The bf16 tensor-core GEMM (M > 32): TMA loads, a dequantizing warpgroup
// pair and wgmma; design in the note at the top of this file.
namespace tc {

constexpr int BN = 128, BK = 64;               // output columns, K per step
constexpr int SX = 5, SW = 6, SB = 4;          // ring stages: x, packed, bf16 W
constexpr int PRODUCER = 128, TRANSFORM = 256, CONSUMER = 256;
constexpr int THREADS = PRODUCER + TRANSFORM + CONSUMER;
constexpr int TWARPS = TRANSFORM / 32;
constexpr int MAX_EXPERTS = 1024;              // the expert axis of a plane's map

// Packed bytes of one step's tile of W (KB x BN weights).
template <int FMT, int KB = BK>
__host__ __device__ constexpr int w_stage_bytes() {
  return KB * BN * Fmt<FMT>::kBits / 8;
}

template <int MI>
struct Layout {
  static constexpr int BM = 64 * MI;
  static constexpr int x_stage = BM * BK * 2;  // bf16, 128-byte swizzled rows
  static constexpr int b_stage = BN * BK * 2;
  static constexpr int w_stage = 8192;         // the widest pack (bytes)
  static constexpr int x_off = 0;
  static constexpr int b_off = x_off + SX * x_stage;
  static constexpr int w_off = b_off + SB * b_stage;
  static constexpr int bar_off = w_off + SW * w_stage;
  static constexpr int tab_off = bar_off + 8 * 2 * (SX + SW + SB);
  static constexpr int bytes = tab_off + 16 * 4 + 1024;  // + the 1024 alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Waits for the phase of `parity` to complete; a wait that never ends (a
// protocol fault) traps after ~2^34 clocks (~10 s) instead of hanging the
// card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (tries == 0) t0 = clock64();
    else if ((tries & 1023) == 0 && clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// The wgmma operand descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (8-row atoms of 1024 bytes; the leading offset is unused).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
// Byte offset of the 16-byte chunk `ch` (8 bf16 along K) of row `row` in such
// a tile: what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and wgmma reads.
__device__ __forceinline__ int sw128_chunk(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

template <int N>
struct Wgmma;
// m64nNk16, bf16 x bf16 -> float32, A and B K-major in shared memory,
// accumulating into d.
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
        "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
          "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
          "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

// v rounded to TF32 (10-bit mantissa, to nearest, ties away), as a float's
// bits with the low 13 bits zero: cvt.rna.tf32.f32's value for every finite
// v (the magnitude's bits rounded up at bit 12, a carry moving into the
// exponent), in two integer operations instead of a conversion.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

template <int R>
__device__ __forceinline__ void keep_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// An unsigned code below 2^23 as a float, exactly, without a conversion
// instruction (the dequantization runs beside the tensor cores).
__device__ __forceinline__ float code_float(uint32_t c) {
  return __int_as_float(0x4B000000u | c) - 8388608.f;
}

// The dequantized weight of `code` with its (group, column)'s scale s and
// zero term z: z is the integer zero point or symmetric offset as a float
// (value s * (code - z), the subtraction exact) or, with float offsets, the
// offset (value code * s + z, each step rounded as the plain version's).
template <int FMT>
__device__ __forceinline__ float weight_value(uint32_t code, float s, float z,
                                              bool float_zero, const float* tab) {
  using F = Fmt<FMT>;
  if constexpr (F::kLut) return tab[code] * s;
  if constexpr (F::kFp8) return fp8_value<FMT>(code) * s;
  const float c = code_float(code);
  if constexpr (FMT == FMT_INT1) return s * (2.f * c - 1.f);
  return float_zero ? __fadd_rn(__fmul_rn(c, s), z) : s * (c - z);
}

// The zero term of (group, column) idx, as weight_value takes it.
__device__ __forceinline__ float zero_term(const PackArgs& a, size_t idx, float sym) {
  return a.zmode == Z_SYM     ? sym
         : a.zmode == Z_INT   ? (float)static_cast<const uint8_t*>(a.zeros)[idx]
         : a.zmode == Z_FLOAT ? __ldg(static_cast<const float*>(a.zeros) + idx)
                              : 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}
__device__ __forceinline__ uint4 pick4(const uint4 (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Kernel A's format (A4: int4, the symmetric offset, bf16 scales): the 8
// codes of one word as 8 bf16 weights in band order, about 2 instructions a
// weight.  Byte j of the word holds the codes of bands 2j (low nibble) and
// 2j + 1 (high): one prmt puts byte j of the word and of the word >> 4 in
// the two halves, one lop3 keeps their low nibbles and ors in 0x4300 (bf16
// 128), giving the pair (128 + c, 128 + c'); hsub2 of 136 leaves c - 8
// exactly and hmul2 by the bands' bf16 scale pair rounds s * (c - 8) once,
// the value float32 s * (c - 8) rounds to.
__device__ __forceinline__ uint4 a4_chunk(uint32_t w, const __nv_bfloat162 (&sp)[4]) {
  const uint32_t w4 = w >> 4;
  const __nv_bfloat162 k136 = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t pk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = __byte_perm(w, w4, (j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)));
    const uint32_t v = (t & 0x000F000Fu) | 0x43004300u;
    const __nv_bfloat162 h =
        __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), k136), sp[j]);
    pk[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(pk[0], pk[1], pk[2], pk[3]);
}

// Where the transform warpgroups work: K per step, the packed ring's and the
// W ring's stages and stage bytes, the number of transform warpgroups (two
// in the bf16 GEMM, which split a step's bands or rows between them; one in
// the float32 GEMM), the first transform thread, and the W tiles written:
// bf16, or TF32 hi + lo pairs (store_tf32x8).
template <int BK_, int SW_, int SB_, int W_STAGE_, int B_STAGE_, int NH_, int T0_,
          bool TF32_>
struct Ring {
  static constexpr int kBK = BK_, kSW = SW_, kSB = SB_, kWStage = W_STAGE_,
                       kBStage = B_STAGE_, kNH = NH_, kT0 = T0_;
  static constexpr bool kTf32 = TF32_;
};
using Bf16Ring = Ring<BK, SW, SB, Layout<1>::w_stage, Layout<1>::b_stage, 2, PRODUCER, false>;

// The float32 GEMM's W stage: a hi and a lo tile of BN columns x 32 k' in
// TF32, each column one 128-byte swizzled row (the K-major layout wgmma reads
// for 32-bit operands).
constexpr int TF32_TILE = BN * 32 * 4;

// Eight consecutive k' of one W column (octet c of the step) as TF32 pairs,
// hi = rna(v) and lo = rna(v - hi): hi + lo is v or one float32 ulp of v
// away (v - hi has up to 12 significant bits, lo keeps 11).  Chunks 2c and
// 2c + 1 of its row in the hi tile at bt and in the lo tile after it.
__device__ __forceinline__ void store_tf32x8(unsigned char* bt, int row, int c,
                                             const float (&v)[8]) {
  uint32_t h[8], l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    h[e] = tf32_rna(v[e]);
    l[e] = tf32_rna(v[e] - __uint_as_float(h[e]));
  }
  const int c0 = sw128_chunk(row, 2 * c), c1 = sw128_chunk(row, 2 * c + 1);
  *reinterpret_cast<uint4*>(bt + c0) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(bt + c1) = make_uint4(h[4], h[5], h[6], h[7]);
  *reinterpret_cast<uint4*>(bt + TF32_TILE + c0) = make_uint4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<uint4*>(bt + TF32_TILE + c1) = make_uint4(l[4], l[5], l[6], l[7]);
}

// A transform's hook at the top of each step (the float32 GEMM's loads); the
// bf16 GEMM has none.
struct NoHook {
  __device__ __forceinline__ void operator()(int) const {}
};

// Transform warpgroups, packed formats (EF >= 8 bands): thread (warpgroup
// H, column tl) dequantizes BPT bands x RPT word rows of the step (32 weights, four
// 16-byte chunks of 8 consecutive k' = row * EF + band) and holds the scale
// and zero term of each of its bands until the band's group changes (A4:
// kernel A's format through a4_chunk, the scales held as bf16 pairs).  One
// warpgroup (the float32 GEMM: steps of 32 k') takes every band and row.
template <int FMT, int H, bool A4, typename RG = Bf16Ring, typename Hook = NoHook>
__device__ __forceinline__ void transform_packed(
    const PackArgs& a, const uint32_t* ws_all, __nv_bfloat16* bs_all,
    uint64_t* w_full, uint64_t* w_empty, uint64_t* b_full, uint64_t* b_empty,
    const float* tab, int n_blk, int K, int N, int g, int steps, Hook hook = Hook{}) {
  using F = Fmt<FMT>;
  static_assert(!A4 || FMT == FMT_INT4, "A4 is kernel A's int4 format");
  static_assert(!A4 || !RG::kTf32, "A4 writes bf16 tiles");
  constexpr int EF = F::kBands, R = RG::kBK / EF;
  constexpr bool split = RG::kNH == 2;
  constexpr int BPT = split && EF >= 16 ? EF / 2 : EF;  // bands per thread
  constexpr int RPT = split && EF < 16 ? R / 2 : R;     // word rows per thread
  constexpr int OCT = BPT / 8;                 // chunks per row
  // the bands are compile-time: code_of then shifts by constants
  constexpr int band0 = split && EF >= 16 ? H * BPT : 0;
  constexpr int row0 = split && EF < 16 ? H * RPT : 0;
  const int tl = threadIdx.x % 128, lane = tl % 32;
  const int n = n_blk + tl;
  const int KW = K / EF;
  const bool float_zero = a.zmode == Z_FLOAT;
  const float sym = (float)(1 << (F::kBits - 1));
  float sc[BPT], zt[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) sc[j] = zt[j] = 0.f;
  __nv_bfloat162 sp[4];  // A4: the scales of bands (2j, 2j + 1)
  // The terms of step s's groups, loaded once per group: reload(s) runs
  // after step s - 1's stores, so the loads' latency hides behind the next
  // waits.  `next_any` is the first band row at which any of the thread's
  // bands enters a new group (the same for the whole warp), so most steps
  // test one number; a band is reloaded at the first row of its group.
  int next_any = 0;
  auto reload = [&](int s) {
    const int rb = s * R;  // the step's first row in band coordinates
    if (rb < next_any) return;
    int nxt = INT_MAX;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int b = band0 + j;
      const int G = (b * KW + rb) / g;
      if ((s == 0 || b * KW + rb - G * g < R) && n < N) {
        sc[j] = scale_at(a, (size_t)G * N + n);
        zt[j] = zero_term(a, (size_t)G * N + n, sym);
      }
      nxt = min(nxt, (G + 1) * g - b * KW);
    }
    next_any = nxt;
    if constexpr (A4) {  // bf16 scales: the pairs are exact
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[j] = __floats2bfloat162_rn(sc[2 * j], sc[2 * j + 1]);
    }
  };
  reload(0);
  for (int s = 0; s < steps; ++s) {
    hook(s);
    const int ws = s % RG::kSW;
    bar_wait(&w_full[ws], (s / RG::kSW) & 1);
    const uint32_t* wt = ws_all + ws * (RG::kWStage / 4);
    uint32_t w[RPT][F::kSlots];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int p = 0; p < F::kPlanes; ++p) {
        // the step's boxes lie plane after plane, each [q][R][BN] words
        int off = 0;
#pragma unroll
        for (int pp = 0; pp < p; ++pp) off += F::q(pp) * R * BN;
#pragma unroll
        for (int jq = 0; jq < F::q(p); ++jq)
          w[i][F::slot0(p) + jq] = wt[off + (jq * R + row0 + i) * BN + tl];
      }
    __syncwarp();
    if (lane == 0) bar_arrive(&w_empty[ws]);
    // the W ring runs SB steps ahead of the products, so this wait is
    // short; each chunk is stored as soon as it is made (few live registers)
    const int bst = s % RG::kSB;
    bar_wait(&b_empty[bst], ((s / RG::kSB) & 1) ^ 1);
    unsigned char* bt = reinterpret_cast<unsigned char*>(bs_all) + bst * RG::kBStage;
    if constexpr (A4) {  // one word row = one 16-byte chunk (EF = 8)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        *reinterpret_cast<uint4*>(bt + sw128_chunk(tl, row0 + i)) = a4_chunk(w[i][0], sp);
    } else if constexpr (RG::kTf32) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int o = 0; o < OCT; ++o) {
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = weight_value<FMT>(code_of<FMT>(w[i], band0 + o * 8 + e), sc[o * 8 + e],
                                     zt[o * 8 + e], float_zero, tab);
          store_tf32x8(bt, tl, ((row0 + i) * EF + band0) / 8 + o, v);
        }
    } else {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int o = 0; o < OCT; ++o) {
          uint32_t pk[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j0 = o * 8 + 2 * e, b0 = band0 + j0;
            const float v0 = weight_value<FMT>(code_of<FMT>(w[i], b0), sc[j0], zt[j0],
                                               float_zero, tab);
            const float v1 = weight_value<FMT>(code_of<FMT>(w[i], b0 + 1), sc[j0 + 1],
                                               zt[j0 + 1], float_zero, tab);
            pk[e] = pack_bf16(v0, v1);
          }
          const int c = ((row0 + i) * EF + band0) / 8 + o;  // chunk of k'
          *reinterpret_cast<uint4*>(bt + sw128_chunk(tl, c)) =
              make_uint4(pk[0], pk[1], pk[2], pk[3]);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) bar_arrive(&b_full[bst]);
    if (s + 1 < steps) reload(s + 1);
  }
}

// Transform warpgroups, byte rows (INT8, FP8: EF = 1): warp `oct` takes rows
// 8 * oct + 0..7 of the step, lane cq columns 4 * cq + 0..3 (one 32-bit word
// per row); the four 8-k chunks are written in a lane-rotated order so that
// a warp's 16-byte stores spread over the banks.  `direct`: N % 16 != 0,
// where TMA cannot take the rows' stride; the words are then read from
// global memory.
template <int FMT, typename RG = Bf16Ring, typename Hook = NoHook>
__device__ __forceinline__ void transform_bytes(
    const PackArgs& a, const uint32_t* ws_all, __nv_bfloat16* bs_all,
    uint64_t* w_full, uint64_t* w_empty, uint64_t* b_full, uint64_t* b_empty,
    int n_blk, int K, int N, int g, int steps, int direct, Hook hook = Hook{}) {
  using F = Fmt<FMT>;
  const int t = threadIdx.x - RG::kT0;
  const int oct = t / 32, cq = t % 32, lane = cq;
  const int col = 4 * cq, n = n_blk + col;
  const bool float_zero = a.zmode == Z_FLOAT;
  const float sym = (float)(1 << (F::kBits - 1));
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(a.plane[0]);
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, zt[4] = {0.f, 0.f, 0.f, 0.f};
  int next = 0;
  const int rot = (cq >> 1) & 3;
  // as transform_packed: the next step's group terms load after this
  // step's dequantization
  auto reload = [&](int s) {
    const int k0 = s * RG::kBK + 8 * oct;
    if (k0 < K && k0 >= next) {
      const int G = k0 / g;
      next = (G + 1) * g;
      if (n < N) {
        const size_t idx = (size_t)G * N + n;
        scales4(a, idx, sc);
        if constexpr (!F::kFp8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) zt[j] = zero_term(a, idx + j, sym);
        }
      }
    }
  };
  reload(0);
  for (int s = 0; s < steps; ++s) {
    hook(s);
    const int k0 = s * RG::kBK + 8 * oct;
    const bool live = k0 < K;
    const int ws = s % RG::kSW;
    bar_wait(&w_full[ws], (s / RG::kSW) & 1);
    uint32_t w[8];
    if (direct) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = (n < N && k0 + i < K)
                   ? __ldg(reinterpret_cast<const uint32_t*>(bytes + (size_t)(k0 + i) * N + n))
                   : 0u;
    } else {
      const uint32_t* wt = ws_all + ws * (RG::kWStage / 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = wt[(8 * oct + i) * (BN / 4) + cq];
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&w_empty[ws]);
    if constexpr (RG::kTf32) {
      // the W ring runs SB steps ahead of the products, so this wait is
      // short; each column's 8 rows are split and stored as they are made
      const int bst = s % RG::kSB;
      bar_wait(&b_empty[bst], ((s / RG::kSB) & 1) ^ 1);
      unsigned char* bt = reinterpret_cast<unsigned char*>(bs_all) + bst * RG::kBStage;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = jj ^ rot;
        const float s_j = j == 0 ? sc[0] : j == 1 ? sc[1] : j == 2 ? sc[2] : sc[3];
        const float z_j = j == 0 ? zt[0] : j == 1 ? zt[1] : j == 2 ? zt[2] : zt[3];
        float v[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // column j's bytes of rows 2e and 2e + 1 in the low half
          const uint32_t pair =
              __byte_perm(w[2 * e], w[2 * e + 1], (uint32_t)j | ((4u + j) << 4));
          if constexpr (F::kFp8) {
            const float2 f = fp8x2_value<FMT>(pair);
            v[2 * e] = f.x * s_j;
            v[2 * e + 1] = f.y * s_j;
          } else {
            v[2 * e] = weight_value<FMT>(pair & 255u, s_j, z_j, float_zero, nullptr);
            v[2 * e + 1] = weight_value<FMT>((pair >> 8) & 255u, s_j, z_j, float_zero, nullptr);
          }
          if (!live) v[2 * e] = v[2 * e + 1] = 0.f;
        }
        store_tf32x8(bt, col + j, oct, v);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) bar_arrive(&b_full[bst]);
      if (s + 1 < steps) reload(s + 1);
      continue;
    }
    uint4 ch[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // column j's bytes of rows 2e and 2e + 1 in the low half
        const uint32_t pair = __byte_perm(w[2 * e], w[2 * e + 1], j | ((4 + j) << 4));
        float v0, v1;
        if constexpr (F::kFp8) {  // two codes per conversion, exact into half
          const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
              (__nv_fp8x2_storage_t)pair, FMT == FMT_E4M3 ? __NV_E4M3 : __NV_E5M2);
          const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
          v0 = f.x * sc[j];
          v1 = f.y * sc[j];
        } else {
          v0 = weight_value<FMT>(pair & 255u, sc[j], zt[j], float_zero, nullptr);
          v1 = weight_value<FMT>((pair >> 8) & 255u, sc[j], zt[j], float_zero, nullptr);
        }
        pk[e] = live ? pack_bf16(v0, v1) : 0u;
      }
      ch[j] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
    const int bst = s % RG::kSB;
    bar_wait(&b_empty[bst], ((s / RG::kSB) & 1) ^ 1);
    unsigned char* bt = reinterpret_cast<unsigned char*>(bs_all) + bst * RG::kBStage;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = jj ^ rot;
      *reinterpret_cast<uint4*>(bt + sw128_chunk(col + j, oct)) = pick4(ch, j);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) bar_arrive(&b_full[bst]);
    if (s + 1 < steps) reload(s + 1);
  }
}

// The consumer warpgroup's 64 x WN accumulator to global memory, 16 bytes
// per store: lanes of a quad swap their pieces with shuffles so that each
// holds 8 bf16 (or 4 float32) consecutive columns of one row.  Rows from
// m_lim on (a grouped tile's rows past its live ones) are written as zeros.
template <int WN>
__device__ __forceinline__ void store_tile(const float (&acc)[WN / 2],
                                           __nv_bfloat16* out, int row0, int col0,
                                           int M, int m_lim, int N) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32, q = l % 4;
  const int r = row0 + 16 * w + l / 4;
#pragma unroll
  for (int j = 0; j < WN / 8; j += 2) {
    const uint32_t X[4] = {pack_bf16(acc[4 * j], acc[4 * j + 1]),
                           pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                           pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                           pack_bf16(acc[4 * j + 6], acc[4 * j + 7])};
    uint32_t Y[4] = {X[0], X[1], X[2], X[3]};
#pragma unroll
    for (int d = 1; d < 4; ++d) {
      const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(X, q ^ d), d);
      const int slot = q ^ d;
      Y[0] = slot == 0 ? got : Y[0];
      Y[1] = slot == 1 ? got : Y[1];
      Y[2] = slot == 2 ? got : Y[2];
      Y[3] = slot == 3 ? got : Y[3];
    }
    const int gm = r + 8 * (q & 1), gn = col0 + 8 * (j + (q >> 1));
    if (gm < M && gn < N) {
      const uint4 v = gm < m_lim ? make_uint4(Y[0], Y[1], Y[2], Y[3]) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(out + (size_t)gm * N + gn) = v;
    }
  }
}

template <int WN>
__device__ __forceinline__ void store_tile(const float (&acc)[WN / 2], float* out,
                                           int row0, int col0, int M, int m_lim, int N) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32, q = l % 4;
  const int r = row0 + 16 * w + l / 4;
  const bool odd = q & 1;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    // even lanes keep row r, odd lanes row r + 8; each sends the other row
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const int gm = r + (odd ? 8 : 0), gn = col0 + 8 * j + 2 * (q & 2);
    if (gm < M && gn < N) {
      float4 v = odd ? make_float4(g0, g1, acc[4 * j + 2], acc[4 * j + 3])
                     : make_float4(acc[4 * j], acc[4 * j + 1], g0, g1);
      if (gm >= m_lim) v = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(out + (size_t)gm * N + gn) = v;
    }
  }
}

// 64 * MI x 128 output tiles (F and P: MI = 2).  Warpgroup 0 produces (one
// thread issues the TMA loads of x and of the packed planes), warpgroups 1-2
// dequantize, 3-4 multiply: with MI = 2 each takes 64 rows x 128 columns,
// with MI = 1 (the grouped bm = 64) each 64 rows x 64 columns.  The grouped
// instance takes tile i from expert block_expert[i]; rows of the tile past
// its block_rows[i] live ones are written as zeros, a tile with none is
// written as zeros and stops.  A4: kernel A's format (transform_packed).
template <int FMT, int MI, bool GROUPED, typename OutT, bool A4>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap wmap0,
            const __grid_constant__ CUtensorMap wmap1,
            const __grid_constant__ CUtensorMap wmap2, PackArgs a,
            const int* __restrict__ block_expert, const int* __restrict__ block_rows,
            OutT* __restrict__ out, int M, int K, int N, int g, int direct) {
  using F = Fmt<FMT>;
  using L = Layout<MI>;
  constexpr int BM = L::BM;
  constexpr int WN = MI == 2 ? BN : BN / 2;  // columns per consumer warpgroup
  extern __shared__ unsigned char gsm_raw[];
  unsigned char* gsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gsm_raw) + 1023) & ~(uintptr_t)1023);
  auto xs = reinterpret_cast<__nv_bfloat16*>(gsm + L::x_off);
  auto bs = reinterpret_cast<__nv_bfloat16*>(gsm + L::b_off);
  auto ws = reinterpret_cast<uint32_t*>(gsm + L::w_off);
  auto bars = reinterpret_cast<uint64_t*>(gsm + L::bar_off);
  uint64_t* x_full = bars;
  uint64_t* x_empty = x_full + SX;
  uint64_t* w_full = x_empty + SX;
  uint64_t* w_empty = w_full + SW;
  uint64_t* b_full = w_empty + SW;
  uint64_t* b_empty = b_full + SB;
  auto tab = reinterpret_cast<float*>(gsm + L::tab_off);

  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  int m_lim = M, expert = 0;
  if constexpr (GROUPED) {
    const int live = block_rows != nullptr ? block_rows[blockIdx.y] : BM;
    if (live <= 0) {  // no assignment in this tile: its rows are zeros
      for (int i = threadIdx.x; i < BM * BN / 4; i += THREADS) {
        const int gm = m_blk + i / (BN / 4), gn = n_blk + (i % (BN / 4)) * 4;
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        if (gm < M && gn < N) store4(out + (size_t)gm * N + gn, zero);
      }
      return;
    }
    m_lim = min(M, m_blk + live);
    expert = block_expert[blockIdx.y];
    select_expert<FMT>(a, expert, K, N, g);
  }
  const int steps = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < SX; ++i) {
      bar_init(&x_full[i], 1);
      bar_init(&x_empty[i], CONSUMER / 128);
    }
    for (int i = 0; i < SW; ++i) {
      bar_init(&w_full[i], 1);
      bar_init(&w_empty[i], TWARPS);
    }
    for (int i = 0; i < SB; ++i) {
      bar_init(&b_full[i], TWARPS);
      bar_init(&b_empty[i], CONSUMER / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (F::kLut && threadIdx.x < 16) tab[threadIdx.x] = a.table[threadIdx.x];
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producers: one thread keeps x's TMA loads in flight, another
    // the planes' (so W runs ahead of x by its own ring)
    if (threadIdx.x == 0) {
      for (int s = 0; s < steps; ++s) {
        const int xst = s % SX;
        bar_wait(&x_empty[xst], ((s / SX) & 1) ^ 1);
        bar_expect(&x_full[xst], L::x_stage);
        tma_2d(reinterpret_cast<unsigned char*>(xs) + xst * L::x_stage, &xmap,
               &x_full[xst], s * BK, m_blk);
      }
    } else if (threadIdx.x == 32) {
      constexpr int R = BK / F::kBands;
      for (int s = 0; s < steps; ++s) {
        const int wst = s % SW;
        bar_wait(&w_empty[wst], ((s / SW) & 1) ^ 1);
        if (direct) {
          bar_arrive(&w_full[wst]);
          continue;
        }
        bar_expect(&w_full[wst], w_stage_bytes<FMT>());
        unsigned char* wt = reinterpret_cast<unsigned char*>(ws) + wst * L::w_stage;
        if constexpr (F::kByte) {
          tma_4d(wt, &wmap0, &w_full[wst], n_blk, s * BK, 0, expert);
        } else {
          const CUtensorMap* maps[3] = {&wmap0, &wmap1, &wmap2};
          int off = 0;
#pragma unroll
          for (int p = 0; p < F::kPlanes; ++p) {
            tma_4d(wt + off, maps[p], &w_full[wst], n_blk, s * R, 0, expert);
            off += F::q(p) * R * BN * 4;
          }
        }
      }
    }
  } else if (wg <= 2) {
    // ---- transform: packed codes -> bf16 W tiles in the wgmma layout
    if constexpr (F::kByte)
      transform_bytes<FMT>(a, ws, bs, w_full, w_empty, b_full, b_empty, n_blk, K, N, g,
                           steps, direct);
    else if (wg == 1)
      transform_packed<FMT, 0, A4>(a, ws, bs, w_full, w_empty, b_full, b_empty, tab,
                                   n_blk, K, N, g, steps);
    else
      transform_packed<FMT, 1, A4>(a, ws, bs, w_full, w_empty, b_full, b_empty, tab,
                                   n_blk, K, N, g, steps);
  } else {
    // ---- consumers: wgmma over the x and W tiles as they arrive
    const int c = wg - 3;
    const int row_off = MI == 2 ? 64 * c : 0, col_off = MI == 2 ? 0 : WN * c;
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int xst = s % SX, bst = s % SB;
      bar_wait(&x_full[xst], (s / SX) & 1);
      bar_wait(&b_full[bst], (s / SB) & 1);
      const uint64_t da = sw128_desc(reinterpret_cast<unsigned char*>(xs) +
                                     xst * L::x_stage + row_off * 128);
      const uint64_t db = sw128_desc(reinterpret_cast<unsigned char*>(bs) +
                                     bst * L::b_stage + col_off * 128);
      keep_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 32 bytes along K: 2 in 16-byte units
        Wgmma<WN>::mma(acc, da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      keep_regs(acc);
      if (s > 0 && threadIdx.x % 128 == 0) {  // step s - 1's products are done
        bar_arrive(&x_empty[(s - 1) % SX]);
        bar_arrive(&b_empty[(s - 1) % SB]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep_regs(acc);
    store_tile<WN>(acc, out, m_blk + row_off, n_blk + col_off, M, m_lim, N);
  }
}

// ------------------------------------------------ float32 GEMM (3xTF32) ---
// float32 x and out, M > 32 (design in the note at the top of this file):
// 128 x 128 output tiles, K steps of 32 k' (one 128-byte swizzle row of
// float32), 384 threads: warpgroup 0 dequantizes (its thread 0 also issues
// the packs' TMA loads), warpgroups 1-2 load their own 64 rows of x and
// multiply.
namespace f32 {
constexpr int BK = 32, SX = 4, SW = 6, SB = 4;  // ring stages: x, packed, W pairs
constexpr int BM = 128, THREADS = 384;
constexpr int x_tile = BM * BK * 4;            // float32, 128-byte swizzled rows
constexpr int b_stage = 2 * TF32_TILE;         // W: hi + lo
constexpr int w_stage = BK * BN;               // the widest pack (bytes)
constexpr int x_off = 0;
constexpr int b_off = x_off + SX * x_tile;
constexpr int w_off = b_off + SB * b_stage;
constexpr int bar_off = w_off + SW * w_stage;
constexpr int tab_off = bar_off + 8 * (2 * SX + 2 * SW + 2 * SB);
constexpr int smem = tab_off + 16 * 4 + 1024;  // + the 1024 alignment
}  // namespace f32
using Tf32Ring = Ring<f32::BK, f32::SW, f32::SB, f32::w_stage, f32::b_stage, 1, 0, true>;

// m64n128k8, tf32 x tf32 -> float32: A (4 TF32 words a thread, the
// mma.sync m16n8k8 layout per warp: (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4), g = lane / 4, t = lane % 4) from registers, B K-major in
// shared memory; d = A B + d, or A B when scale_d is 0.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int FMT>
__global__ void __launch_bounds__(f32::THREADS, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap0,
                   const __grid_constant__ CUtensorMap wmap1,
                   const __grid_constant__ CUtensorMap wmap2, PackArgs a,
                   float* __restrict__ out, int M, int K, int N, int g, int direct) {
  using F = Fmt<FMT>;
  // this kernel's ring (tc's own BK, SX, SW, SB are the bf16 GEMM's)
  constexpr int BK = f32::BK, SX = f32::SX, SW = f32::SW, SB = f32::SB;
  constexpr int BM = f32::BM, x_tile = f32::x_tile;
  constexpr int b_stage = f32::b_stage, w_stage = f32::w_stage;
  extern __shared__ unsigned char gsm_raw[];
  unsigned char* gsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gsm_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* xs = gsm + f32::x_off;
  unsigned char* bs = gsm + f32::b_off;
  auto ws = reinterpret_cast<uint32_t*>(gsm + f32::w_off);
  auto bars = reinterpret_cast<uint64_t*>(gsm + f32::bar_off);
  uint64_t* x_full = bars;  // [SX][2]: each consumer warpgroup's rows
  uint64_t* w_full = x_full + 2 * SX;
  uint64_t* w_empty = w_full + SW;
  uint64_t* b_full = w_empty + SW;
  uint64_t* b_empty = b_full + SB;
  auto tab = reinterpret_cast<float*>(gsm + f32::tab_off);

  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int steps = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * SX; ++i) bar_init(&x_full[i], 1);
    for (int i = 0; i < SW; ++i) {
      bar_init(&w_full[i], 1);
      bar_init(&w_empty[i], 4);  // one per transform warp
    }
    for (int i = 0; i < SB; ++i) {
      bar_init(&b_full[i], 4);
      bar_init(&b_empty[i], 2);  // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (F::kLut && threadIdx.x < 16) tab[threadIdx.x] = a.table[threadIdx.x];
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- transform: packed codes -> TF32 hi + lo W tiles.  Thread 0 also
    // keeps the packs' loads SW - 2 steps ahead: at the top of step s, the
    // tile of step s + SW - 2 (its slot held step s - 2, released by now).
    auto load_w = [&](int j) {
      const int wst = j % SW;
      bar_wait(&w_empty[wst], ((j / SW) & 1) ^ 1);
      if (direct) {
        bar_arrive(&w_full[wst]);
        return;
      }
      bar_expect(&w_full[wst], w_stage_bytes<FMT, BK>());
      unsigned char* wt = reinterpret_cast<unsigned char*>(ws) + wst * w_stage;
      if constexpr (F::kByte) {
        tma_4d(wt, &wmap0, &w_full[wst], n_blk, j * BK, 0, 0);
      } else {
        constexpr int R = BK / F::kBands;
        int off = 0;
        static_for<0, F::kPlanes>([&](auto p) {
          const CUtensorMap* m = p.value == 0 ? &wmap0 : p.value == 1 ? &wmap1 : &wmap2;
          tma_4d(wt + off, m, &w_full[wst], n_blk, j * R, 0, 0);
          off += F::q(p.value) * R * BN * 4;
        });
      }
    };
    auto hook = [&](int s) {
      if (threadIdx.x != 0) return;
      if (s == 0) {
        for (int j = 0; j < SW - 1 && j < steps; ++j) load_w(j);
      } else if (s + SW - 2 < steps) {
        load_w(s + SW - 2);
      }
    };
    auto bs16 = reinterpret_cast<__nv_bfloat16*>(bs);
    if constexpr (F::kByte)
      transform_bytes<FMT, Tf32Ring>(a, ws, bs16, w_full, w_empty, b_full, b_empty, n_blk,
                                     K, N, g, steps, direct, hook);
    else
      transform_packed<FMT, 0, false, Tf32Ring>(a, ws, bs16, w_full, w_empty, b_full,
                                                b_empty, tab, n_blk, K, N, g, steps, hook);
  } else {
    // ---- consumers, 64 rows each: a warpgroup loads its own rows of x
    // (TMA, SX steps ahead), reads each k8 step's A fragment from them,
    // splits it into TF32 hi + lo in registers, and multiplies by W's pair
    // from shared memory: lo_x hi_w, hi_x lo_w, hi_x hi_w (the small terms
    // first) into a fresh accumulator, added into a float32 total once the
    // step's products are done.  A k8 step's products form one group; one
    // group stays in flight while the next k8 step's x is read and split
    // (two register sets).
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int lane = t % 32, q = lane % 4;
    const int rows = 64 * c * 128;             // this warpgroup's rows in an x tile
    const int r0 = 16 * (t / 32) + lane / 4;   // A rows r0 and r0 + 8 of them
    const int sw = r0 & 7;
    auto load_x = [&](int j) {
      uint64_t* full = &x_full[(j % SX) * 2 + c];
      bar_expect(full, x_tile / 2);
      tma_2d(xs + (j % SX) * x_tile + rows, &xmap, full, j * BK, m_blk + 64 * c);
    };
    if (t == 0)
      for (int j = 0; j < SX && j < steps; ++j) load_x(j);
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
    uint32_t xh[2][4], xl[2][4];
    for (int s = 0; s < steps; ++s) {
      const int xst = s % SX, bst = s % SB;
      bar_wait(&b_full[bst], (s / SB) & 1);
      bar_wait(&x_full[xst * 2 + c], (s / SX) & 1);
      const unsigned char* xr = xs + xst * x_tile + rows + r0 * 128 + 4 * q;
      const uint64_t bh = sw128_desc(bs + bst * b_stage);
      const uint64_t bl = sw128_desc(bs + bst * b_stage + TF32_TILE);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int p = kk & 1;
        const int o0 = ((2 * kk) ^ sw) << 4, o1 = ((2 * kk + 1) ^ sw) << 4;
        const float v[4] = {*reinterpret_cast<const float*>(xr + o0),
                            *reinterpret_cast<const float*>(xr + 8 * 128 + o0),
                            *reinterpret_cast<const float*>(xr + o1),
                            *reinterpret_cast<const float*>(xr + 8 * 128 + o1)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xh[p][j] = tf32_rna(v[j]);
          xl[p][j] = tf32_rna(v[j] - __uint_as_float(xh[p][j]));
        }
        keep_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        // 32 bytes along K a k8 step: 2 in the descriptor's 16-byte units
        wgmma_tf32_rs(acc, xl[p], bh + 2 * kk, kk == 0 ? 0 : 1);
        wgmma_tf32_rs(acc, xh[p], bl + 2 * kk, 1);
        wgmma_tf32_rs(acc, xh[p], bh + 2 * kk, 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        keep_regs(acc);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      keep_regs(acc);
      if (t == 0) {  // step s's products are done: its W pair and x slot are free
        bar_arrive(&b_empty[bst]);
        if (s + SX < steps) load_x(s + SX);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    store_tile<BN>(tot, out, m_blk + 64 * c, n_blk, M, M, N);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x [M, K] bf16 in boxes of BK x BM, 128-byte swizzled (the wgmma A layout).
inline bool x_map(CUtensorMap* m, const __nv_bfloat16* x, int M, int K, int BM) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BM};
  const cuuint32_t el[2] = {1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(x),
                   dims, strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x [M, K] float32 in boxes of 32 x 64 (one 128-byte swizzle row of K, a
// consumer warpgroup's rows).
inline bool x_map_f32(CUtensorMap* m, const float* x, int M, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {(cuuint32_t)f32::BK, (cuuint32_t)(f32::BM / 2)};
  const cuuint32_t el[2] = {1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims,
                   strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A plane as stored, [E][q * KW][N] 32-bit words (or [E][K][N] bytes), read
// as dims (N, rows of one band block, band blocks q, experts E) in boxes of
// (BN, rows per step, q, 1).
inline bool plane_map(CUtensorMap* m, const void* p, bool bytes, int N, int rows,
                      int blocks, int experts, int box_rows) {
  const cuuint64_t el_bytes = bytes ? 1 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)rows, (cuuint64_t)blocks,
                              (cuuint64_t)experts};
  const cuuint64_t row = (cuuint64_t)N * el_bytes;
  const cuuint64_t strides[3] = {row, row * rows, row * rows * blocks};
  const cuuint32_t box[4] = {(cuuint32_t)BN, (cuuint32_t)box_rows, (cuuint32_t)blocks, 1};
  const cuuint32_t el[4] = {1, 1, 1, 1};
  return encoder()(m, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT32,
                   4, const_cast<void*>(p), dims, strides, box, el,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

template <int FMT, int MI, bool GROUPED, typename OutT, bool A4 = false>
cudaError_t launch_gemm(const __nv_bfloat16* xk, const PackArgs& a, const int* block_expert,
                        const int* block_rows, OutT* out, int M, int K, int N, int g,
                        cudaStream_t st) {
  using F = Fmt<FMT>;
  using L = tc::Layout<MI>;
  if (tc::encoder() == nullptr) return cudaErrorNotSupported;
  const int experts = GROUPED ? tc::MAX_EXPERTS : 1;
  // byte rows need a 16-byte row stride for TMA; else the words come from
  // global memory (direct)
  const int direct = F::kByte && N % 16 != 0;
  CUtensorMap xm, wm[3];
  memset(wm, 0, sizeof(wm));
  bool ok = tc::x_map(&xm, xk, M, K, L::BM);
  if constexpr (F::kByte) {
    if (!direct) ok = ok && tc::plane_map(&wm[0], a.plane[0], true, N, K, 1, experts, tc::BK);
  } else {
    const int KW = K / F::kBands;
#pragma unroll
    for (int p = 0; p < F::kPlanes; ++p)
      ok = ok && tc::plane_map(&wm[p], a.plane[p], false, N, KW, F::q(p), experts,
                               tc::BK / F::kBands);
  }
  if (!ok) return cudaErrorInvalidValue;
  constexpr int smem = L::bytes;
  auto kernel = tc::gemm_kernel<FMT, MI, GROUPED, OutT, A4>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + tc::BN - 1) / tc::BN, (M + L::BM - 1) / L::BM);
  kernel<<<grid, tc::THREADS, smem, st>>>(xm, wm[0], wm[1], wm[2], a, block_expert,
                                          block_rows, out, M, K, N, g, direct);
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

// The float32 GEMM (M > 32): x [M, K] float32 in band-major K order, out
// float32; tc::gemm_tf32x3_kernel on the bf16 GEMM's plane maps, at 32 k' a
// step.
template <int FMT>
cudaError_t run_gemm_f32(const float* xk, const PackArgs& a, float* out, int M, int K,
                         int N, int g, cudaStream_t st) {
  using F = Fmt<FMT>;
  if (tc::encoder() == nullptr) return cudaErrorNotSupported;
  const int direct = F::kByte && N % 16 != 0;
  CUtensorMap xm, wm[3];
  memset(wm, 0, sizeof(wm));
  bool ok = tc::x_map_f32(&xm, xk, M, K);
  if constexpr (F::kByte) {
    if (!direct) ok = ok && tc::plane_map(&wm[0], a.plane[0], true, N, K, 1, 1, tc::f32::BK);
  } else {
    const int KW = K / F::kBands;
#pragma unroll
    for (int p = 0; p < F::kPlanes; ++p)
      ok = ok && tc::plane_map(&wm[p], a.plane[p], false, N, KW, F::q(p), 1,
                               tc::f32::BK / F::kBands);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = tc::gemm_tf32x3_kernel<FMT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc::f32::smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::f32::BM - 1) / tc::f32::BM);
  kernel<<<grid, tc::f32::THREADS, tc::f32::smem, st>>>(xm, wm[0], wm[1], wm[2], a, out, M,
                                                        K, N, g, direct);
  return cudaGetLastError();
}

}  // namespace nstfp
