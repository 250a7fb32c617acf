// Prefill flash attention over the KV cache (int8 codes, or bf16 or float32
// values).  One library per head dim and addressing: `flash_prefill_d<D>.cu`
// (the contiguous cache, kernel C) and `flash_prefill_paged_d<D>.cu` (the
// page pool, kernel 9) define NST_FLASH_DIM and NST_FLASH_PAGED and include
// this file, so nvcc builds them side by side.
//
// Replaces: neural_speed_tpu/ops/flash.py, _mha_kernel as launched by
// _mha_packed from mha over the contiguous cache (nst_flash_prefill) and by
// _mha_paged from mha_paged over the page pool (nst_flash_prefill_paged);
// int8 (bf16 or float32 scales), bf16 or float32 cache, causal or not,
// ALiBi or none, logit softcap or none, bf16 or float32 output; every head
// dim the JAX kernels take (multiples of 8 up to 256, `_head_dim_ok`).
//
// What it computes, for query row t of head h in slot b (KV head
// h / n_rep): the columns c with c < kv_len[b] and, when causal,
// c <= pos[b, t] are valid; s = (bf16(q) . k) * k_scale * sm_scale (no
// k_scale for K values; float32 K rounded to bf16 first), then softcap *
// tanh(s / softcap) with a softcap (softcap > 0: a runtime argument; IEEE
// division and tanhf, as the plain versions' torch.tanh on the card), then
// + slope[h] * (c - pos[b, t]) with ALiBi; an online softmax over column
// tiles; P * v_scale (P for V values) rounded to bf16 before the product
// with V (float32 V rounded to bf16), accumulated in f32; out = acc / l,
// and 0 for a row with no valid column (padded rows carry position -1),
// stored as bf16 (rounded to nearest even) or, with `out_f32`, as float32
// from the f32 accumulator, as the JAX kernel stores `o_ref.dtype`.  q
// arrives in bf16 (the launcher rounds a float32 q, as the JAX launcher's
// `astype(bfloat16)`).  Non-causal (whisper's encoder and cross
// attention): no row test and no skip of tiles above the last position;
// ALiBi still measures c - pos[b, t].  At prefill the cache is appended
// first, so this reads the K/V of the prompt itself.  The exponent is
// 2^(s * log2(e) - m * log2(e)) (one FFMA and ex2.approx.ftz), P is rounded
// against the running max of the tiles seen so far: only those two, and
// the order of the float32 sums, differ from the plain version.
//
// Bound: operations (4 * T^2/2 * D per head with causal skipping, ~34 GFLOP
// per Llama-2-7B layer at T = 2048, on the bf16 tensor cores).
// Design (FlashAttention-3's shape on the parts of qmm_fp.cuh's `tc`):
// a block takes BT = 64 * NC query rows of one (slot, head) in the natural
// [B, T, H, D] layout (no GQA row packing) and walks the cache in tiles of
// BC = 64 columns, with two roles:
//  * warpgroup 0 feeds the tiles.  Its thread 0 loads the block's Q once
//    (a TMA box of 64 rows x 64 columns per consumer warpgroup and
//    128-byte chunk of the row, through a 3-D map over [B * T, H, D],
//    128-byte swizzle) and keeps the K / V tiles in flight through
//    mbarrier rings: bf16 tiles straight into the BS-stage ring of
//    swizzled bf16 tiles (TMA boxes of `run` rows x 64 columns, ready for
//    wgmma), the other three warps idle; int8 and float32 rows, and the
//    int8 scales, as raw bytes into an RS-slot ring, one slot per K or V
//    tile (1-D cp.async.bulk copies of `run` consecutive rows: int8 rows
//    of D % 16 == 8 are 72 / 88 / ... bytes, which no tensor map can
//    stride), which all four warps then convert to bf16 in the
//    128-byte-swizzled layout wgmma reads, 16 bytes a store (int8 codes
//    exactly: an exponent trick and the float's upper half; float32
//    rounded to nearest even; the scales to float32 beside the tile).
//    Thread 0 refills a raw slot, RS tiles ahead, once the warpgroup has
//    read it (a named barrier).  `run` is 64 over the contiguous cache
//    and gcd(page size, 64) over the pool, so a copy never crosses a page;
//  * warpgroups 1..NC: the consumers, 64 rows each.  S = Q K^T is
//    wgmma m64n64k16 with both operands K-major in shared memory (D / 16
//    steps: the zero pad of the 80 / 96 tiles to 128 columns is never
//    read); the online softmax runs on S's accumulator fragment in
//    registers (a row lives in a quad: its max and sum take two shfl_xor,
//    and the sum only at the end), applying the column's k_scale to S and
//    v_scale to P; O += P V is wgmma with P from registers (S's fragment,
//    rounded to bf16 pairs, is the A operand of a k16 slice as it stands)
//    and V as an MN-major B operand (the transpose bit), read from the
//    same swizzled row-major tile: P V's width is D at 64 / 128 / 256 and
//    the padded 128 at 80 / 96 (MN-major atoms are 64 columns wide).  S and
//    O stay in registers; the epilogue writes bf16 or float32 to
//    [B, T, H, D] straight from O.
// Causal work: column tiles past kv_len or past the block's last position
// are skipped; a tile that every row of the consumer warpgroup sees whole
// takes no per-element mask; blocks are issued heaviest first (the last
// row tiles of every head before the first).  NC = 2 (128 rows, 384
// threads: 12 warps, at most 168 registers a thread) up to D = 128; NC = 1
// (256 threads) at D = 256, where O alone is 128 floats a thread, and for calls
// of at most FEW_ROWS rows (decode through C, verify steps, whisper's
// prefix), picked by the launcher from T.  Head dims below the instance's
// (a multiple of 8 without an instance of its own, as 72 through the 80
// instance) run with a runtime D <= NST_FLASH_DIM: Q's and K's columns
// past D are zero (TMA's out-of-bounds fill, the transform's zeros) and
// only the first D output columns are stored.
// Paged: the kernel is a template over the cache addressing (common.cuh);
// the producer resolves each run of rows through the slot's page table,
// and everything after the load is the contiguous kernel's, so kernel 9
// equals kernel C over the gathered layer bit for bit.

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "qmm_fp.cuh"  // tc: mbarriers, TMA, the 128-byte swizzle, wgmma

#ifndef NST_FLASH_DIM
#error "define NST_FLASH_DIM (the head-dim instance) before including this file"
#endif
#ifndef NST_FLASH_PAGED
#error "define NST_FLASH_PAGED (1: the page pool's entry) before including this file"
#endif

namespace {

using nstfp::tc::bar_arrive;
using nstfp::tc::bar_expect;
using nstfp::tc::bar_init;
using nstfp::tc::bar_wait;
using nstfp::tc::keep_regs;
using nstfp::tc::pack_bf16;
using nstfp::tc::smem_addr;
using nstfp::tc::sw128_desc;
using nstfp::tc::tma_2d;
using nstfp::tc::Wgmma;

constexpr int DI = NST_FLASH_DIM;             // the instance's head dim
constexpr int DP = (DI + 63) / 64 * 64;       // a row in 128-byte swizzle chunks
constexpr int DN = DI % 64 == 0 ? DI : DP;    // P V's width
constexpr int ON = DN < 128 ? DN : 128;       // one P V wgmma's width
constexpr int NP = DN / ON;                   // P V wgmmas per k16 slice
constexpr int KSTEPS = DI / 16;               // Q K^T's k16 steps
constexpr int BC = 64;                        // cache columns per tile
constexpr int MAX_NC = DI > 128 ? 1 : 2;      // consumer warpgroups, 64 rows each
constexpr int FEW_ROWS = 64;                  // T <= FEW_ROWS: one consumer warpgroup
constexpr int BS = 2;                         // stages of the bf16 K / V ring
constexpr int MAX_RS = 4;                     // slots of the raw ring (a K or V tile)
constexpr int TWARPS = 4;                     // transform warps (warpgroup 0)
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
// V as P V's B operand (MN-major, 128-byte swizzle): the 64-column chunks
// of the tile lie BC * 128 bytes apart (the leading offset), its 8-row
// groups 1024 (the stride offset).
constexpr uint32_t V_LBO = BC * 128, V_SBO = 1024;
static_assert(DI % 16 == 0, "the k16 steps of Q K^T");

template <class KV, class SC, int NC>
struct Layout {
  static constexpr bool kRaw = !std::is_same<KV, __nv_bfloat16>::value;
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int BT = 64 * NC;                      // query rows
  static constexpr int THREADS = 128 + 128 * NC;
  static constexpr int q_bytes = BT * DP * 2;
  static constexpr int tile = BC * DP * 2;                // K or V, bf16
  static constexpr int raw_codes = BC * DI * (int)sizeof(KV);
  static constexpr int raw_scales = kQuant ? (BC * (int)sizeof(SC) + 15) / 16 * 16 : 0;
  static constexpr int raw = kRaw ? raw_codes + raw_scales : 0;
  static constexpr int q_off = 0;
  static constexpr int kv_off = q_off + q_bytes;          // stage s: K, then V
  static constexpr int sc_off = kv_off + BS * 2 * tile;   // float [BS][2][BC]
  static constexpr int raw_off = sc_off + (kQuant ? BS * 2 * BC * 4 : 0);
  static constexpr int tail = 32 + 8 * (1 + 2 * BS + MAX_RS) + 1024;
  static constexpr int fit = kRaw ? (SMEM_LIMIT - raw_off - tail) / (raw > 0 ? raw : 1) : 0;
  static constexpr int RS = fit < MAX_RS ? fit : MAX_RS;
  static constexpr int red_off = raw_off + RS * raw;      // int [4] max, [4] min
  static constexpr int bar_off = red_off + 32;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * BS + RS) + 1024;
  static_assert(!kRaw || RS >= 1, "a raw slot must fit");
  static_assert(bytes <= SMEM_LIMIT, "shared memory of the instance");
};

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// `bytes` consecutive bytes of global memory into shared memory (both
// 16-byte aligned, a multiple of 16 bytes), completion on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The wgmma descriptor of an MN-major tile in the 128-byte swizzle (V as
// P V's B operand, read with the transpose bit).
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(V_LBO >> 4) << 16) |
         ((uint64_t)(V_SBO >> 4) << 32) | (1ull << 62);
}

// m64nNk16, bf16 x bf16 -> float32, A from registers (four bf16 pairs in
// the layout of a k16 slice of the accumulator), B MN-major in shared
// memory (transposed), accumulating into d.
template <int N>
struct WgmmaRS;
template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Eight cache elements as eight bf16 (16 bytes): int8 codes exactly,
// float32 values rounded to nearest even.
template <class KV>
__device__ __forceinline__ uint4 to_bf16x8(const unsigned char* p);

// Four int8 codes as four bf16, exactly: the float 2^23 + (c + 128) minus
// 2^23 + 128 is c, and a code's float has at most 8 significant bits, so
// its upper half is its bf16.  (Two codes a bf16x2 add, 0x4300 | (c & 127)
// plus -128 or -256, is fewer instructions but measured slower on the
// H100, PERF.md.)
__device__ __forceinline__ uint2 codes_bf16x4(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(
        __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + e)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

template <>
__device__ __forceinline__ uint4 to_bf16x8<int8_t>(const unsigned char* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const uint2 lo = codes_bf16x4(w.x), hi = codes_bf16x4(w.y);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

template <>
__device__ __forceinline__ uint4 to_bf16x8<float>(const unsigned char* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// The transform's share of one landed raw tile (K or V, BC rows of D
// elements) as bf16 in the 128-byte swizzle: thread tt of the 32 * TWARPS
// takes the 16-byte chunk ch = tt % CH of rows tt / CH, + RSTEP, ... (the
// thread count is a multiple of CH, so a thread keeps one chunk and its
// addresses step by constants), GROUP rows' loads issued before their
// stores.  Chunks past D are zeros.
template <class KV>
__device__ __forceinline__ void transform_tile(const unsigned char* __restrict__ src,
                                               unsigned char* __restrict__ dst, int tt,
                                               int D) {
  constexpr int CH = DP / 8, NT = 32 * TWARPS, RSTEP = NT / CH;
  constexpr int ITEMS = (BC + RSTEP - 1) / RSTEP, GROUP = 4;
  static_assert(NT % CH == 0, "a thread keeps one chunk of the row");
  const int ch = tt % CH, r0 = tt / CH;
  const bool live = ch * 8 < D;
  const unsigned char* s0 = src + ((size_t)r0 * D + ch * 8) * sizeof(KV);
  unsigned char* d0 = dst + (ch / 8) * (BC * 128);
  const int c16 = (ch % 8) << 4;
#pragma unroll
  for (int j0 = 0; j0 < ITEMS; j0 += GROUP) {
    uint4 v[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      const int r = r0 + (j0 + j) * RSTEP;
      if (j0 + j < ITEMS && live && r < BC)
        v[j] = to_bf16x8<KV>(s0 + (size_t)(j0 + j) * RSTEP * D * sizeof(KV));
    }
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int r = r0 + (j0 + j) * RSTEP;
      if (j0 + j < ITEMS && r < BC)
        *reinterpret_cast<uint4*>(d0 + r * 128 + (c16 ^ ((r & 7) << 4))) = v[j];
    }
  }
}

// 2^x on the MUFU (flushing results below 2^-126 to 0: a P that small
// moves no sum), 0 for -inf.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's scores S (this thread's BC / 2 accumulator elements: rows r0
// and r0 + 8 of its warp's 16, columns 8j + 2 * quad + {0, 1}) to P: the
// score's scale, softcap, ALiBi and, with MASK, the mask (-inf); the online
// softmax's running max m, partial sum l (this thread's columns) and the
// factor alpha that rescales O; P * v_scale as the bf16 pairs pa, the A
// operand of P V.
template <bool MASK, bool QUANT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BC / 2], uint32_t (&pa)[BC / 4], float (&m)[2], float (&l)[2],
    float (&alpha)[2], const float* __restrict__ ksc, const float* __restrict__ vsc,
    float sm_scale, float softcap, bool alibi, float slope, const int (&prow)[2],
    const int (&lim)[2], int c0, int c_end, int quad) {
  float mx[2] = {-FLT_MAX, -FLT_MAX};
  float2 ks2[BC / 8];  // the k_scale of this thread's columns, two a load
  if constexpr (QUANT) {
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
      ks2[j] = *reinterpret_cast<const float2*>(ksc + 8 * j + 2 * quad);
  }
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * quad + (i & 1), e = (i >> 1) & 1;
    float x = s[i] * sm_scale;
    if constexpr (QUANT) x = s[i] * ((i & 1) ? ks2[i >> 2].y : ks2[i >> 2].x) * sm_scale;
    if (softcap > 0.f) x = nst::softcap_score(x, softcap);
    if (alibi) x = nst::add_alibi(x, slope, c0 + col, prow[e]);
    if (MASK && !(c0 + col < c_end && c0 + col <= lim[e]))
      x = __int_as_float(0xff800000u);  // -inf
    s[i] = x;
    mx[e] = fmaxf(mx[e], x);
  }
  float ms[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float mn = fmaxf(m[e], mx[e]);
    alpha[e] = exp2_ftz((m[e] - mn) * LOG2E);
    m[e] = mn;
    // no valid column yet: every score is -inf and P is 0
    ms[e] = mn == -FLT_MAX ? 0.f : mn * LOG2E;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BC / 2; i += 2) {
    const int e = (i >> 1) & 1;
    const float p0 = exp2_ftz(fmaf(s[i], LOG2E, -ms[e]));
    const float p1 = exp2_ftz(fmaf(s[i + 1], LOG2E, -ms[e]));
    sum[e] += p0 + p1;
    if constexpr (QUANT) {
      const float2 v2 = *reinterpret_cast<const float2*>(vsc + 8 * (i >> 2) + 2 * quad);
      pa[i / 2] = pack_bf16(p0 * v2.x, p1 * v2.y);
    } else {
      pa[i / 2] = pack_bf16(p0, p1);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = alpha[e] * l[e] + sum[e];
}

// SC: the int8 cache's scale type (bf16 or float32).  `run`: rows per copy
// (a divisor of BC that no page boundary splits).
template <class KV, class SC, class Cache, int NC>
__global__ void __launch_bounds__(Layout<KV, SC, NC>::THREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, Cache cache,
                     const KV* __restrict__ kc, const KV* __restrict__ vc,
                     const SC* __restrict__ ks, const SC* __restrict__ vs,
                     const float* __restrict__ slopes, const int* __restrict__ pos,
                     const int* __restrict__ kv_lens, void* __restrict__ out, int T,
                     int H, int Hkv, int S, int D, int layer, int causal, int out_f32,
                     float sm_scale, float softcap, int run) {
  using L = Layout<KV, SC, NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  auto bars = reinterpret_cast<uint64_t*>(sm + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* t_full = q_full + 1;     // [BS] bf16 K / V tiles ready
  uint64_t* t_empty = t_full + BS;   // [BS] consumed
  uint64_t* r_full = t_empty + BS;   // [RS] raw tiles landed
  auto red = reinterpret_cast<int*>(sm + L::red_off);

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * L::BT;  // heaviest row tile first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the rows' positions (-1 past T): the block's largest bounds its
  // columns, each consumer warpgroup's smallest decides its mask-free tiles
  if (tid < L::BT) {
    const int t = t0 + tid;
    int mx = t < T ? pos[(size_t)b * T + t] : -1, mn = mx;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      red[warp] = mx;
      red[4 + warp] = mn;
    }
  }
  if (tid == 0) {
    bar_init(q_full, 1);
    for (int i = 0; i < BS; ++i) {
      bar_init(&t_full[i], 1);
      bar_init(&t_empty[i], NC);
    }
    for (int i = 0; i < L::RS; ++i) bar_init(&r_full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int pmax = red[0];
#pragma unroll
  for (int w = 1; w < L::BT / 32; ++w) pmax = max(pmax, red[w]);
  const int kv_len = kv_lens[b];
  const int c_end = causal ? min(min(kv_len, pmax + 1), S) : min(kv_len, S);
  const int n_tiles = c_end > 0 ? (c_end + BC - 1) / BC : 0;

  if (warp < 4) {
    // ---- warpgroup 0: thread 0 loads Q once, then feeds the K / V rings
    const auto rows = cache.rows(layer, b, hk);
    if (tid == 0) {
      bar_expect(q_full, L::q_bytes);
#pragma unroll
      for (int w = 0; w < NC; ++w)
#pragma unroll
        for (int j = 0; j < DP / 64; ++j)
          tma_3d(sm + L::q_off + j * L::BT * 128 + w * 64 * 128, &qmap, q_full, 64 * j, h,
                 b * T + t0 + 64 * w);
    }
    if constexpr (!L::kRaw) {
      // bf16: TMA boxes straight into the bf16 ring, ready for wgmma
      if (tid != 0) return;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % BS;
        bar_wait(&t_empty[st], ((i / BS) & 1) ^ 1);
        bar_expect(&t_full[st], 2 * L::tile);
        unsigned char* kt = sm + L::kv_off + st * 2 * L::tile;
        for (int r = 0; r < BC; r += run) {
          const int row = (int)rows(i * BC + r);
#pragma unroll
          for (int j = 0; j < DP / 64; ++j) {
            tma_2d(kt + j * BC * 128 + r * 128, &kmap, &t_full[st], 64 * j, row);
            tma_2d(kt + L::tile + j * BC * 128 + r * 128, &vmap, &t_full[st], 64 * j, row);
          }
        }
      }
    } else {
      // int8 / float32: the warpgroup converts each landed raw tile (K, then
      // V, of tile i = u / 2); thread 0 also issues the copies RS tiles
      // ahead, refilling a slot once all 128 threads have read it (a named
      // barrier), its page-table reads made before the conversion
      const uint32_t row_bytes = D * (uint32_t)sizeof(KV);
      const int nu = 2 * n_tiles;
      size_t rw[BC / 16];  // the next copy's source rows, one per run
      auto runs_of = [&](int u) {
#pragma unroll
        for (int k = 0; k < BC / 16; ++k)
          if (k * run < BC) rw[k] = rows((u / 2) * BC + k * run);
      };
      auto issue = [&](int u) {
        const int slot = u % L::RS;
        const bool isv = u & 1;
        bar_expect(&r_full[slot],
                   BC * row_bytes + (L::kQuant ? BC * (uint32_t)sizeof(SC) : 0u));
        unsigned char* dst = sm + L::raw_off + slot * L::raw;
#pragma unroll
        for (int k = 0; k < BC / 16; ++k) {
          if (k * run >= BC) break;
          bulk_load(dst + k * run * row_bytes, (isv ? vc : kc) + rw[k] * D, run * row_bytes,
                    &r_full[slot]);
          if constexpr (L::kQuant)
            bulk_load(dst + L::raw_codes + k * run * sizeof(SC), (isv ? vs : ks) + rw[k],
                      run * (uint32_t)sizeof(SC), &r_full[slot]);
        }
      };
      if (tid == 0)
        for (int u = 0; u < min(L::RS, nu); ++u) {
          runs_of(u);
          issue(u);
        }
      for (int u = 0; u < nu; ++u) {
        const int i = u / 2, st = i % BS, slot = u % L::RS;
        const bool isv = u & 1;
        const bool refill = tid == 0 && u + L::RS < nu;
        if (refill) runs_of(u + L::RS);
        if (!isv) bar_wait(&t_empty[st], ((i / BS) & 1) ^ 1);
        bar_wait(&r_full[slot], (u / L::RS) & 1);
        const unsigned char* src = sm + L::raw_off + slot * L::raw;
        transform_tile<KV>(src, sm + L::kv_off + st * 2 * L::tile + (isv ? L::tile : 0), tid,
                           D);
        if constexpr (L::kQuant) {
          float* scl = reinterpret_cast<float*>(sm + L::sc_off) + (st * 2 + isv) * BC;
          const SC* ssrc = reinterpret_cast<const SC*>(src + L::raw_codes);
          if (tid < BC) scl[tid] = nst::scale_to_float(ssrc[tid]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the slot is read
        if (refill) issue(u + L::RS);
        if (tid == 0 && isv) bar_arrive(&t_full[st]);
      }
    }
  } else {
    // ---- consumers: S = Q K^T, the softmax and O += P V, in registers
    const int c = warp / 4 - 1, cw = warp % 4, quad = lane % 4;
    const int r0 = 64 * c + 16 * cw + lane / 4;  // rows r0, r0 + 8 of the block
    int prow[2], lim[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + r0 + 8 * e;
      prow[e] = t < T ? pos[(size_t)b * T + t] : -1;
      lim[e] = causal ? prow[e] : INT_MAX;
    }
    const int pmin = min(red[4 + 2 * c], red[5 + 2 * c]);
    const bool alibi = slopes != nullptr;
    const float slope = alibi ? slopes[h] : 0.f;
    float o[NP][ON / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) o[p][i] = 0.f;
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
    const uint64_t qd = sw128_desc(sm + L::q_off + c * 64 * 128);
    bar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % BS;
      unsigned char* kt = sm + L::kv_off + st * 2 * L::tile;
      const uint64_t kd = sw128_desc(kt);
      const uint64_t vd = mn_desc(kt + L::tile);
      bar_wait(&t_full[st], (i / BS) & 1);
      float s[BC / 2];
#pragma unroll
      for (int j = 0; j < BC / 2; ++j) s[j] = 0.f;
      keep_regs(s);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)  // chunk kk / 4, 32 bytes along it each
        Wgmma<BC>::mma(s, qd + (kk / 4) * (L::BT * 128 >> 4) + 2 * (kk % 4),
                       kd + (kk / 4) * (BC * 128 >> 4) + 2 * (kk % 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      keep_regs(s);

      const int c0 = i * BC;
      const float* ksc = reinterpret_cast<const float*>(sm + L::sc_off) + st * 2 * BC;
      uint32_t pa[BC / 4];
      float alpha[2];
      if (c0 + BC <= c_end && (!causal || c0 + BC - 1 <= pmin))
        softmax_tile<false, L::kQuant>(s, pa, m, l, alpha, ksc, ksc + BC, sm_scale, softcap,
                                       alibi, slope, prow, lim, c0, c_end, quad);
      else
        softmax_tile<true, L::kQuant>(s, pa, m, l, alpha, ksc, ksc + BC, sm_scale, softcap,
                                      alibi, slope, prow, lim, c0, c_end, quad);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < ON / 2; ++j) o[p][j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int p = 0; p < NP; ++p) keep_regs(o[p]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BC / 16; ++k)  // 16 rows of V: two 8-row groups
#pragma unroll
        for (int p = 0; p < NP; ++p)
          WgmmaRS<ON>::mma(o[p], pa + 4 * k,
                           vd + ((k * 16 * 128 + p * (ON / 64) * V_LBO) >> 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int p = 0; p < NP; ++p) keep_regs(o[p]);
      if (tid % 128 == 0) bar_arrive(&t_empty[st]);
    }

    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      inv[e] = l[e] == 0.f ? 0.f : 1.f / l[e];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < ON / 2; j += 2) {
        const int e = (j >> 1) & 1, t = t0 + r0 + 8 * e;
        const int col = p * ON + 8 * (j >> 2) + 2 * quad;
        if (t < T && col < D) {
          const size_t at = (((size_t)b * T + t) * H + h) * D + col;
          const float v0 = o[p][j] * inv[e], v1 = o[p][j + 1] * inv[e];
          if (out_f32)
            *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
  }
}

// q [B, T, H, D] bf16 as a 3-D map (D, H, B * T) in boxes of 64 columns x
// 1 head x 64 rows, 128-byte swizzled (columns past D read as zeros).
inline bool q_map(CUtensorMap* m, const void* q, int B, int T, int H, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)B * T};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2};
  const cuuint32_t box[3] = {64, 1, 64};
  const cuuint32_t el[3] = {1, 1, 1};
  return nstfp::tc::encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(q),
                              dims, strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 cache's rows [rows, D] in boxes of 64 columns x `run` rows,
// 128-byte swizzled.
inline bool kv_map(CUtensorMap* m, const void* p, long long rows, int D, int run) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)run};
  const cuuint32_t el[2] = {1, 1};
  return nstfp::tc::encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
                              dims, strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class KV, class SC, int NC, class Cache>
cudaError_t launch(Cache cache, long long rows, int run, const void* q, const void* kc,
                   const void* vc, const void* ks, const void* vs, const void* slopes,
                   const void* pos, const void* kv_lens, void* out, int B, int T_, int H,
                   int Hkv, int S, int D, int layer, int causal, int out_f32,
                   float sm_scale, float softcap, cudaStream_t st) {
  using L = Layout<KV, SC, NC>;
  CUtensorMap qm, km, vm;
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  bool ok = q_map(&qm, q, B, T_, H, D);
  if constexpr (!L::kRaw) ok = ok && kv_map(&km, kc, rows, D, run) && kv_map(&vm, vc, rows, D, run);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_prefill_kernel<KV, SC, Cache, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H * B, (T_ + L::BT - 1) / L::BT);
  kernel<<<grid, L::THREADS, L::bytes, st>>>(
      qm, km, vm, cache, static_cast<const KV*>(kc), static_cast<const KV*>(vc),
      static_cast<const SC*>(ks), static_cast<const SC*>(vs),
      static_cast<const float*>(slopes), static_cast<const int*>(pos),
      static_cast<const int*>(kv_lens), out, T_, H, Hkv, S, D, layer, causal, out_f32,
      sm_scale, softcap, run);
  return cudaGetLastError();
}

// kv_type: 0 int8 codes with bf16 scales, 3 int8 codes with float32
// scales, 1 bf16 values, 2 float32 values (no scales).  D: the head dim, a
// multiple of 8 at most this instance's.  causal: 1 or 0; out_f32: 1 for a
// float32 output, 0 for bf16.  softcap: 0 (off) or the logit softcap.
// rows: the cache's rows up to this layer's last (the tensor maps' extent);
// run: rows per copy.  The tensors must be 16-byte aligned.
template <class Cache>
int launch_d(Cache cache, long long rows, int run, int D, const void* q, const void* kc,
             const void* vc, const void* ks, const void* vs, const void* slopes,
             const void* pos, const void* kv_lens, void* out, int B, int T_, int H, int Hkv,
             int S, int layer, int kv_type, int causal, int out_f32, float sm_scale,
             float softcap, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bool quant = kv_type == 0 || kv_type == 3;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (D > DI || D <= 0 || D % 8 || kv_type < 0 || kv_type > 3 ||
      (causal != 0 && causal != 1) || (out_f32 != 0 && out_f32 != 1) ||
      !(softcap >= 0.f) || rows >= INT_MAX || !aligned(q) || !aligned(kc) ||
      !aligned(vc) || (quant && (!aligned(ks) || !aligned(vs))))
    return (int)cudaErrorInvalidValue;
  if (nstfp::tc::encoder() == nullptr) return (int)cudaErrorNotSupported;
  const bool few = T_ <= FEW_ROWS;
#define NST_LAUNCH(KV, SC)                                                              \
  (few ? launch<KV, SC, 1>(cache, rows, run, q, kc, vc, ks, vs, slopes, pos, kv_lens, out, \
                           B, T_, H, Hkv, S, D, layer, causal, out_f32, sm_scale,         \
                           softcap, st)                                                   \
       : launch<KV, SC, MAX_NC>(cache, rows, run, q, kc, vc, ks, vs, slopes, pos, kv_lens,  \
                                out, B, T_, H, Hkv, S, D, layer, causal, out_f32,         \
                                sm_scale, softcap, st))
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (kv_type == 1)
    err = NST_LAUNCH(bf16, bf16);
  else if (kv_type == 2)
    err = NST_LAUNCH(float, bf16);
  else if (kv_type == 3)
    err = NST_LAUNCH(int8_t, float);
  else
    err = NST_LAUNCH(int8_t, bf16);
#undef NST_LAUNCH
  return (int)err;
}

}  // namespace

#if !NST_FLASH_PAGED
// slopes: float32 [H] ALiBi slopes, or null for none; ks / vs are read
// only for the int8 cache.
extern "C" int nst_flash_prefill(const void* q, const void* kc, const void* vc,
                                 const void* ks, const void* vs,
                                 const void* slopes, const void* pos,
                                 const void* kv_lens, void* out, int B, int T,
                                 int H, int Hkv, int S, int D, int layer,
                                 int kv_type, int causal, int out_f32,
                                 float sm_scale, float softcap, void* stream) {
  if (S % BC) return (int)cudaErrorInvalidValue;
  return launch_d(nst::ContigCache{B, Hkv, S}, (long long)(layer + 1) * B * Hkv * S, BC, D,
                  q, kc, vc, ks, vs, slopes, pos, kv_lens, out, B, T, H, Hkv, S, layer,
                  kv_type, causal, out_f32, sm_scale, softcap, stream);
}
#else
// The pool [L, Hkv, P, ps, D] with scales [L, Hkv, P, 1, ps] (int8) and
// int32 tables [B, n_blocks]; the logical length is n_blocks * ps.  A copy
// takes gcd(ps, 64) rows: a tile of 64 columns is one copy per page at
// page size 16 or 32, one at 64 and above, and 16-row copies at 48.
extern "C" int nst_flash_prefill_paged(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* slopes, const void* tables, const void* pos,
    const void* kv_lens, void* out, int B, int T, int H, int Hkv, int P,
    int ps, int n_blocks, int D, int layer, int kv_type, int causal,
    int out_f32, float sm_scale, float softcap, void* stream) {
  if (ps <= 0 || ps % 16) return (int)cudaErrorInvalidValue;
  const int run = ps % 64 == 0 ? 64 : ps % 32 == 0 ? 32 : 16;
  return launch_d(
      nst::PagedCache{static_cast<const int*>(tables), Hkv, P, ps, n_blocks},
      (long long)(layer + 1) * Hkv * P * ps, run, D, q, kc, vc, ks, vs, slopes, pos,
      kv_lens, out, B, T, H, Hkv, n_blocks * ps, layer, kv_type, causal, out_f32,
      sm_scale, softcap, stream);
}
#endif
