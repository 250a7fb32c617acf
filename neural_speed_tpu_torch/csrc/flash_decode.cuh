// Decode attention over the KV cache: the int8 cache with the current
// token's k/v as extra operands and the in-place append of its quantized
// row, or a cache of bf16 or float32 values after a plain append (no extra
// column).  One instance per head dim and addressing: `flash_decode_d<D>.cu`
// (the contiguous cache) and `flash_decode_paged_d<D>.cu` (the page pool)
// define NST_FLASH_DIM and NST_FLASH_PAGED and include this file, so nvcc
// builds them side by side.
//
// Replaces: neural_speed_tpu/ops/flash.py, _mha_kernel_hblk, launched by
// _mha_packed_hblk from mha over the contiguous cache (nst_flash_decode) and
// by _mha_paged_hblk from mha_paged over the page pool
// (nst_flash_decode_paged): int8 K/V (bf16 or float32 scales) with
// extra_kv=True, fused_append=True; int8, bf16 or float32 K/V with neither;
// ALiBi or none; logit softcap or none; causal or not; bf16 or float32
// output; the int8 score dot (FLASH_INT8_DOT) over int8 K/V or not, over
// the contiguous cache also at several tokens per slot; every head dim the
// JAX kernels take (multiples of 8 up to 256, `_head_dim_ok`).
//
// What it computes, per slot b and KV head hk, for the n_rep query heads of
// that group (one token per slot):
//   * with the extra column, kv_len includes the current token; the cache is
//     read only below kv_len_cache = kv_len - 1 when pos == kv_len - 1 (a
//     live slot), else below kv_len (a spectator whose query is parked at
//     max_len - 1).  Without it the cache is read below kv_len.  Columns
//     also satisfy c <= pos when causal (non-causal: whisper's cross
//     attention, every column below the length);
//   * scores s = (bf16(q) . k) * k_scale * sm_scale (no k_scale for K
//     values; float32 K rounded to bf16 first), then softcap * tanh(s /
//     softcap) with a softcap (softcap > 0), then + slope[h] * (c - pos)
//     with ALiBi; the online softmax is seeded with the UNQUANTIZED current
//     k/v (f32, softcapped too, ALiBi distance 0) when the extra column is
//     on;
//   * P * v_scale (P for V values) is rounded to bf16 before the product
//     with V (float32 V rounded to bf16); out = acc / l, 0 where no column
//     is valid, stored as bf16 or float32 (from the f32 sums, as the JAX
//     kernel stores `o_ref.dtype`); q arrives in bf16 (the launcher rounds
//     a float32 q);
//   * with the fused append, live slots get the current k/v quantized
//     (amax / 127 by division, codes rint(x / scale) clipped to +-127 from
//     the float32 scale, the scale stored as the cache's scale type, bf16
//     or float32) and written at row kv_len - 1; spectators are left
//     untouched.
// The int8 score dot (NST_FLASH_INT8=qk, the JAX body's `quantized and
// FLASH_INT8_DOT` branch, flash.py:464-479): each q row is quantized to int8
// codes with the per-row scale qsc = max(max|q|, 1e-6) / 127 (IEEE
// division; codes rint(q / qsc) clipped to +-127), and a column's score is
// float(int32 dot of the codes with the K codes) * qsc * k_scale *
// sm_scale, then the softcap, ALiBi and the mask; the seed column keeps the
// float product.  Several tokens per slot (the int8 dot over the contiguous
// cache, t * n_rep <= 8, no extra column and no append: speculative
// decoding's verify steps): the rows of a (slot, KV head) are the t * n_rep
// (query head, token) pairs, rep-major (row rep * t + ti, head hk * n_rep +
// rep, token ti, as the JAX launcher packs them), q and the output in the
// natural [B, t, H, D] layout, positions [B, t]; each row has its own
// column end and ALiBi distance.
//
// Bound: bytes.  Each step reads the K and V of every live column once
// (about 0.5 GB per Llama-2-7B step at ctx 2000, B = 1, in int8; twice that
// in bf16, four times in float32), at about n_rep operations a byte, far
// below the card's ~295.
//
// Design.  A block takes one (slot, KV head) and one split of its columns:
// the grid is (splits, Hkv, B), the split count the launcher's
// (ops/flash.py `split_columns`: whole 128-column tiles per split, as many
// splits as B * Hkv * splits >= two waves of the SMs asks for where the
// columns allow, at most MAX_SPLITS).  Blocks whose split starts past the slot's column end exit at
// once.  Each block first issues its copies, then loads q and (with the
// extra column) works out the seed column's scores and the append's
// scales, so those loads overlap the K / V copies.  Inside a block the
// warps walk block steps together (warp w takes the 16 columns w of each
// step of NW * 16):
//  * each warp has its own ring of STAGES stages in shared memory (Ring),
//    filled by cp.async (16-byte copies; int8 rows of D % 16 == 8 as one
//    16-byte-aligned run a step; a whole step's copies at constant strides,
//    rows past the split's end zero-filled), guarded by
//    cp.async.wait_group and __syncwarp.  A step's 16 rows never cross a
//    page (page sizes are multiples of 16), so the pool resolves one table
//    entry a step;
//  * the scores on the tensor cores with the query rows (<= 8) as the
//    MMA's n8: S^T = K q^T by mma.sync m16n8k16 (K's 16-byte chunk of a row
//    feeds 16 / 8 / 4 k values of the A fragment; q's B fragments, permuted
//    to match, stay in registers), in two accumulators (even and odd k
//    steps).  int8 K runs in fp16: a code is an fp16 value (a byte permute
//    and a half2 subtraction per two codes), and q's row, a bf16 value, is
//    one too once scaled by the power of two that takes its largest element
//    into [2^14, 2^15) (divided out of the score: the float32 sum is the
//    bf16 product's up to its order, elements below 2^-39 of the row's
//    largest aside).  bf16 and float32 K run in bf16 (float32 rounded as it
//    leaves shared memory).  QK: mma.sync m16n8k32 s8 (exact int32 sums);
//  * the online softmax on S^T's fragment in registers (a row's max over
//    the warp's 16 columns by three shuffles, over the block's step through
//    shared memory, one barrier a step; P = 2^(s log2(e) - m log2(e)) on
//    the MUFU; the running sum per lane, summed at the end).  A step's P is
//    formed one step late, against the block's running max through the
//    next step: a 128-column window, the parent's, so that P * v_scale is
//    rounded to bf16 against nearly the plain version's row max (16- and
//    64-column windows moved the tiny models of chip_smoke.py phase 3
//    beyond its 2% card-against-CPU tolerance); it is transposed into the
//    B fragment of the second product by movmatrix;
//  * O^T += V^T P^T by mma.sync m16n8k16, V^T's A fragments built from
//    4-element words of four V rows (column pairs interleaved by byte
//    permutes; the 32-feature slab of a thread is d = 32T + 4 * (lane / 4)
//    + {0..3}, so its accumulators hold four consecutive features of its
//    two rows).  int8 V runs in fp16 against bf16(P * v_scale) scaled by a
//    power of two per step (the step's largest into [2^14, 2^15): exact in
//    fp16); the accumulators carry that factor and are rescaled with the
//    running max when it changes, and not at all while neither moves.
// The warps' states are merged in shared memory (in warp order) into the
// block's partial (max, sum, accumulator per row), written to device
// memory; then thread 0 adds one to the (slot, KV head)'s counter with an
// acq_rel atomic (after a block barrier: it releases the block's partials
// and acquires the earlier blocks'), and the block that brings it to the
// number of live splits (the last) resets it and merges the partials one
// split at a time in split order against the running max, from the seed
// column (never in arrival order, so repeated calls give one result; the
// loads do not wait on the sums, so they are in flight together), writes
// the output and performs the fused append: one launch a call.  The append
// cannot race with the reads: the new row sits at kv_len - 1 >=
// kv_len_cache, which no block reads, and only the last block of the group
// writes it, after every block of the group has read its columns.  The
// counters are the launcher's (zeros at first, left zero by every call);
// the partials [B * t, H, splits] are scratch.
// Head dims below the instance's (a multiple of 8 without an instance of
// its own, as 72 through the 80 instance) take the instance's masked
// kernels (EXACT = false): a runtime D <= NST_FLASH_DIM tested where a K
// chunk or a V slab is read.  The instance's own head dim takes kernels in
// which D is the compile-time NST_FLASH_DIM (EXACT).  The softcap is a
// compile-time flag of the exact kernels (CAP = OFF or ON; RUNTIME in the
// masked ones) and the int8 score dot a template parameter (QK): a runtime
// test of either in the inner loop moved B by 0.75-1.25x.
// Paged: the kernel is a template over the cache addressing (common.cuh);
// everything after a step's first row is resolved is the contiguous
// kernel's, so kernel 10 equals kernel B over the gathered layer bit for
// bit.
//
// Compiled without --use_fast_math: the quantization must match
// kv_cache.quantize_kv bit for bit (IEEE division, round half to even), and
// the softcap the plain versions' torch.tanh (libdevice's tanhf).

#include <cuda_fp16.h>

#include "common.cuh"

#if !defined(NST_FLASH_DIM) || !defined(NST_FLASH_PAGED)
#error "define NST_FLASH_DIM and NST_FLASH_PAGED before including this file"
#endif

namespace {

constexpr int DI = NST_FLASH_DIM;  // the instance's head dim
constexpr int MAX_ROWS = 8;        // query rows of a block: the MMAs' n8
constexpr int STEP = 16;           // cache columns of a warp step: the m16
constexpr int TILE = 128;          // splits are whole tiles (flash.DECODE_TILE)
constexpr int MAX_SPLITS = 256;    // flash.DECODE_MAX_SPLITS
constexpr int NT = (DI + 31) / 32;  // 32-feature slabs of P V
// The split kernel's softcap: none, applied, or as the argument says.
enum Cap { OFF, ON, RUNTIME };

// Bytes of a cache row in a ring stage: padded to a multiple of 16 that is
// 16 or 48 modulo 64, so that the V reads (four rows apart by two) and the
// cp.async writes spread over the banks.
constexpr int stride_of(int row) {
  int r = (row + 15) / 16 * 16;
  while (r % 64 != 16 && r % 64 != 48) r += 16;
  return r;
}

// One warp's ring (STAGES stages of K rows, V rows and, int8, their
// scales), the warps of a block and the dynamic shared memory of a block
// (the ring, reused after the loop for the warps' partials and the merge).
template <class T, class SC>
struct Ring {
  static constexpr bool kQuant = nst::KVElem<T>::kQuantized;
  static constexpr int kStride = stride_of(DI * (int)sizeof(T));
  static constexpr int kScales = kQuant ? STEP * (int)sizeof(SC) : 0;
  static constexpr int kStage = 2 * STEP * kStride + 2 * kScales;
  static constexpr int kWarps = 2 * 4 * kStage > 200 * 1024 ? 2 : 4;
  // at least three stages where they fit: a step's V is read one step
  // after its K (P waits for the next step's maxima), so two stages would
  // leave no copy in flight
  static constexpr int kFit = 72 * 1024 / (kWarps * kStage);
  static constexpr int kStages =
      kFit >= 4 ? 4 : (3 * kWarps * kStage <= 208 * 1024 ? 3 : 2);
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kPartials = 4 * kWarps * MAX_ROWS * (2 + DI);
  static constexpr int kBytes = kRing > kPartials ? kRing : kPartials;
  static_assert(kBytes <= 227 * 1024, "shared memory of the instance");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VB bytes from global to shared memory, asynchronously; zeros when !ok.
template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int n = ok ? VB : 0;
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
}
// 16 bytes from global to shared memory, asynchronously (a whole row chunk).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the MUFU (flushing results below 2^-126 to 0: a P that small
// moves no sum), 0 for -inf.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// e with x = m 2^e, m in [0.5, 1), for a positive normal float x (frexpf's
// exponent; -126 for a subnormal one).
__device__ __forceinline__ int expo(float x) {
  return max(((__float_as_int(x) >> 23) & 0xff) - 126, -126);
}

// 2^k as a float, k clamped to the normal range [-126, 127].
__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((min(max(k, -126), 127) + 127) << 23);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four int8 codes as four fp16, exactly (fp16 holds every integer up to
// 2048): 0x64 above the byte c + 128 is the half 1024 + c + 128, less 1152
// (bytes 0, 1 in .x, bytes 2, 3 in .y).  Two bytes a half2 subtraction:
// fewer operations than the bf16 conversion, which needs a float per code.
__device__ __forceinline__ uint2 codes_f16x4(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  uint32_t lo = __byte_perm(x, 0x64646464u, 0x5140);
  uint32_t hi = __byte_perm(x, 0x64646464u, 0x7362);
  const __half2 l2 = __hsub2(*reinterpret_cast<const __half2*>(&lo), bias);
  const __half2 h2 = __hsub2(*reinterpret_cast<const __half2*>(&hi), bias);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&l2),
                    *reinterpret_cast<const uint32_t*>(&h2));
}

// d += a b: m16n8k16, fp16 in (int8 K codes against q scaled by a power of
// two), float32 sums.
__device__ __forceinline__ void mma_f16(float& d0, float& d1, float& d2, float& d3,
                                        const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k16, bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k32, int8 in, exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8 x 8 bf16 matrix whose row lane / 4 this lane holds (elements
// 2 (lane % 4) and + 1), transposed: this lane then holds row lane / 4 of
// the transpose.
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// A chunk of VB bytes of a cache row, and the pairs (e0, e1), (e2, e3) of
// its elements 4s .. 4s + 3 as the score's A fragment takes them: int8
// codes as fp16 (exactly), bf16 values, float32 rounded to bf16.
template <class T, int VB>
struct Chunk {
  using Raw = std::conditional_t<VB == 16, uint4, uint2>;
  static __device__ __forceinline__ void pairs(const Raw& x, int s, uint32_t& lo,
                                               uint32_t& hi) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&x);
    if constexpr (std::is_same<T, int8_t>::value) {
      const uint2 p = codes_f16x4(w[s]);
      lo = p.x;
      hi = p.y;
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      lo = w[2 * s];
      hi = w[2 * s + 1];
    } else {
      const float* f = reinterpret_cast<const float*>(&x);
      lo = pack_bf16(f[0], f[1]);
      hi = pack_bf16(f[2], f[3]);
    }
  }
};

// Four elements of a V row (d .. d + 3) as read from the ring.
template <class T>
struct V4;
template <>
struct V4<int8_t> {
  using Raw = uint32_t;
  // pairs (a_j, b_j) of two columns' elements j = 0..3 (int8 codes as fp16)
  static __device__ __forceinline__ void pairs(Raw a, Raw b, uint32_t (&p)[4]) {
    const uint2 lo = codes_f16x4(__byte_perm(a, b, 0x5140));
    const uint2 hi = codes_f16x4(__byte_perm(a, b, 0x7362));
    p[0] = lo.x;
    p[1] = lo.y;
    p[2] = hi.x;
    p[3] = hi.y;
  }
};
template <>
struct V4<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ void pairs(Raw a, Raw b, uint32_t (&p)[4]) {
    p[0] = __byte_perm(a.x, b.x, 0x5410);
    p[1] = __byte_perm(a.x, b.x, 0x7632);
    p[2] = __byte_perm(a.y, b.y, 0x5410);
    p[3] = __byte_perm(a.y, b.y, 0x7632);
  }
};
template <>
struct V4<float> {
  using Raw = float4;
  static __device__ __forceinline__ void pairs(Raw a, Raw b, uint32_t (&p)[4]) {
    p[0] = pack_bf16(a.x, b.x);
    p[1] = pack_bf16(a.y, b.y);
    p[2] = pack_bf16(a.z, b.z);
    p[3] = pack_bf16(a.w, b.w);
  }
};

// T: the cache's element type (KVElem); VB: bytes per row copy; EXACT: D is
// the instance's head dim; SC: the int8 cache's scale type; CAP: the
// softcap (Cap); QK: the int8 score dot (int8 T only).  t: tokens per slot
// (the block's rows t * n_rep <= MAX_ROWS); lim: the positions (causal) or
// kv_lens (non-causal) at t = 1, the positions or null above.
template <class T, int VB, bool EXACT, class Cache, class SC, int CAP, bool QK>
__global__ void __launch_bounds__(Ring<T, SC>::kWarps * 32, 1)
flash_decode_kernel(Cache cache, const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new, T* __restrict__ kc,
                    T* __restrict__ vc, SC* __restrict__ ks, SC* __restrict__ vs,
                    const float* __restrict__ slopes, const int* __restrict__ pos,
                    const int* __restrict__ kv_lens, const int* __restrict__ lim,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ counters,
                    void* __restrict__ out, int H, int Hkv, int S, int D, int layer,
                    int chunk, int extra, int fused_append, int t, int out_f32,
                    float sm_scale, float softcap) {
  if constexpr (EXACT) D = DI;
  using E = nst::KVElem<T>;
  using RG = Ring<T, SC>;
  constexpr int NW = RG::kWarps, THREADS = NW * 32, STAGES = RG::kStages;
  constexpr int PE = VB / (int)sizeof(T);  // elements per copy
  constexpr int CH = DI / PE;              // copies per row of the instance
  constexpr int NG = (CH + 3) / 4;         // lane % 4 takes copies 4g + lane % 4
  constexpr int KS = PE / 4;               // k16 steps per copy (16-bit products)
  constexpr int KQ = PE / 8;               // k32 steps per copy (QK)
  constexpr int NK = QK ? NG * KQ : NG * KS;
  // int8 K against q on the fp16 tensor cores (codes are exact in fp16; q
  // scaled by a power of two per row); bf16 and float32 K on bf16 ones
  constexpr bool F16 = E::kQuantized && !QK;
  // int8 V on the fp16 tensor cores too, against P * v_scale (rounded to
  // bf16) scaled by a power of two per step, 2^kp, that takes the step's
  // largest into [2^14, 2^15): every such P is then an fp16 value (those
  // below 2^-31 of it aside); the accumulators hold O 2^kp of the last step
  constexpr bool V16 = E::kQuantized;
  constexpr int NA = (DI + THREADS - 1) / THREADS;  // the append's elements a thread
  // the widest rows (float32 at 256) keep q's fragments in shared memory:
  // in registers, beside O's 64 accumulators, they spilled
  constexpr bool QSH = sizeof(T) * DI >= 1024;
  static_assert(!QK || E::kQuantized, "qk reads int8 K");
  static_assert(DI % PE == 0 && PE % 4 == 0, "copies hold whole 4-element groups");
  const int nch = D / PE;  // copies per row
  // a ring row's bytes: the padded stride, or, for int8 rows of D % 16 == 8
  // (8-byte copies), D: a step's 16 rows are then one run of 16 D bytes,
  // copied 16 bytes at a time from its even (16-byte aligned) first row
  const int RS = VB == 8 ? D : RG::kStride;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int n_rep = H / Hkv, nr = t * n_rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gi = lane / 4, qd = lane % 4;
  const int kvl = kv_lens[b];

  // the block's column end (the largest of its rows'), and this lane's two
  // score rows 2 qd + e: their ends and positions
  int c_end = 0, r_end[2], r_pos[2], p = 0;
  if (t == 1) {
    p = pos[b];
    const int kvl_cache = kvl - (extra && p == kvl - 1 ? 1 : 0);
    c_end = min(min(kvl_cache, lim[b] + 1), S);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r_end[e] = 2 * qd + e < nr ? c_end : 0;
      r_pos[e] = p;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) r_end[e] = r_pos[e] = 0;
    for (int r = 0; r < nr; ++r) {
      const int pr = pos[b * t + r % t];
      const int en = min(lim != nullptr ? min(kvl, pr + 1) : kvl, S);
      c_end = max(c_end, en);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (r == 2 * qd + e) {
          r_end[e] = en;
          r_pos[e] = pr;
        }
    }
  }
  const int n_live = c_end > 0 ? (c_end + chunk - 1) / chunk : 1;
  if (split >= n_live) return;
  const int c0 = split * chunk, c1 = min(c0 + chunk, c_end);
  // the q / output / partials row of block row r: rep-major rows r = rep * t
  // + ti (head hk * n_rep + rep at token ti), as the JAX launcher packs them
  auto row_of = [&](int r) -> size_t {
    return ((size_t)b * t + r % t) * H + hk * n_rep + r / t;
  };
  const bool ok = t == 1 && p == kvl - 1;
  const bool valid0 = extra && ok && p >= 0;
  const bool append = E::kQuantized && extra && fused_append && ok;
  const size_t nidx = ((size_t)b * Hkv + hk) * D;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int8_t qi[QK ? MAX_ROWS : 1][QK ? DI : 16];
  __shared__ float qsc[MAX_ROWS];
  __shared__ float s0_sh[MAX_ROWS];
  __shared__ float quant_sh[2];
  __shared__ uint2 qf_sh[QSH ? NK : 1][32];
  __shared__ float smax[2][NW][MAX_ROWS];
  __shared__ int s_last;

  // ---- the warp's walk: steps cs = c0 + STEP * (warp + NW * j)
  const auto rows = cache.rows(layer, b, hk);
  unsigned char* ring = smem + warp * STAGES * RG::kStage;
  const int first = c0 + STEP * warp;
  const int nsteps = first < c1 ? (c1 - first + STEP * NW - 1) / (STEP * NW) : 0;
  auto issue = [&](int j) {
    if (j < nsteps) {
      const int cs = first + STEP * NW * j;
      unsigned char* st = ring + (j % STAGES) * RG::kStage;
      const size_t r0 = rows(cs);
      if constexpr (VB == 8) {
        if (cs + STEP <= c1) {
          const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(kc + r0 * D);
          const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(vc + r0 * D);
          for (int o = 16 * lane; o < STEP * D; o += 32 * 16) {
            cp_async16(st + o, ksrc + o);
            cp_async16(st + STEP * RG::kStride + o, vsrc + o);
          }
          constexpr int SCH = RG::kScales / 16, PER = 16 / (int)sizeof(SC);
          if (lane < 2 * SCH)
            cp_async16(st + 2 * STEP * RG::kStride + lane * 16,
                       (lane < SCH ? ks : vs) + r0 + (lane % SCH) * PER);
          cp_commit();
          return;
        }
      }
      if constexpr (EXACT && VB == 16 && (32 % CH == 0 || CH % 32 == 0)) {
        if (cs + STEP <= c1) {
          // a whole step: each lane's copies at constant strides, no tests
          constexpr int RPP = CH <= 32 ? 32 / CH : 1;  // rows a pass
          constexpr int CPR = CH <= 32 ? 1 : CH / 32;  // a lane's copies a row
          const int r = CH <= 32 ? lane / CH : 0, ch = CH <= 32 ? lane % CH : lane;
          const T* ksrc = kc + (r0 + r) * DI + ch * PE;
          const T* vsrc = vc + (r0 + r) * DI + ch * PE;
          unsigned char* dst = st + r * RG::kStride + ch * VB;
#pragma unroll
          for (int k = 0; k < STEP / RPP; ++k)
#pragma unroll
            for (int c = 0; c < CPR; ++c) {
              const int off = k * RPP * DI + c * 32 * PE;
              unsigned char* dk = dst + k * RPP * RG::kStride + c * 32 * VB;
              cp_async16(dk, ksrc + off);
              cp_async16(dk + STEP * RG::kStride, vsrc + off);
            }
          if constexpr (RG::kQuant) {
            constexpr int SCH = RG::kScales / 16, PER = 16 / (int)sizeof(SC);
            if (lane < 2 * SCH)
              cp_async16(st + 2 * STEP * RG::kStride + lane * 16,
                         (lane < SCH ? ks : vs) + r0 + (lane % SCH) * PER);
          }
          cp_commit();
          return;
        }
      }
      // the instance's copies of a row (compile-time divisions), those past
      // a smaller D skipped, rows past the split's end zero-filled
      const bool full = cs + STEP <= c1;
#pragma unroll 4
      for (int i = lane; i < 2 * STEP * CH; i += 32) {
        const int kv = i / (STEP * CH), rem = i % (STEP * CH);
        const int r = rem / CH, ch = rem % CH;
        if (!EXACT && ch >= nch) continue;
        const bool ok_r = full || cs + r < c1;
        const T* src = (kv ? vc : kc) + (r0 + (ok_r ? r : 0)) * D + ch * PE;
        cp_async<VB>(st + kv * STEP * RG::kStride + r * RS + ch * VB, src, ok_r);
      }
      if constexpr (RG::kQuant) {
        constexpr int SCH = RG::kScales / 16;  // 16-byte copies of a step's scales
        constexpr int PER = 16 / (int)sizeof(SC);
        if (lane < 2 * SCH) {
          const int kv = lane / SCH, ch = lane % SCH;
          const bool ok_r = cs + ch * PER < c1;
          cp_async<16>(st + 2 * STEP * RG::kStride + kv * RG::kScales + ch * 16,
                       (kv ? vs : ks) + r0 + (ok_r ? ch * PER : 0), ok_r);
        }
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  // the seed column's scores and the fused append's scales, computed by
  // every block (beside its walk) and used by the last one
  float kx[NA] = {}, vx[NA] = {};
  if (extra) {
    for (int r = warp; r < nr; r += NW) {
      const __nv_bfloat16* qr = q + row_of(r) * D;
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part += __bfloat162float(qr[d]) * __bfloat162float(k_new[nidx + d]);
      float s0 = nst::warp_sum(part) * sm_scale;
      if (softcap > 0.f) s0 = nst::softcap_score(s0, softcap);
      if (lane == 0) s0_sh[r] = s0;
    }
    if (append) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int d = tid + i * THREADS;
        kx[i] = d < D ? __bfloat162float(k_new[nidx + d]) : 0.f;
        vx[i] = d < D ? __bfloat162float(v_new[nidx + d]) : 0.f;
      }
    }
    if (append && warp == NW - 1) {
      float km = 0.f, vm = 0.f;
      for (int d = lane; d < D; d += 32) {
        km = fmaxf(km, fabsf(__bfloat162float(k_new[nidx + d])));
        vm = fmaxf(vm, fabsf(__bfloat162float(v_new[nidx + d])));
      }
      km = nst::warp_max(km);
      vm = nst::warp_max(vm);
      if (lane == 0) {
        quant_sh[0] = fmaxf(km, 1e-8f) / 127.0f;
        quant_sh[1] = fmaxf(vm, 1e-8f) / 127.0f;
      }
    }
  }

  // q's B fragments: k step (g, s) holds row gi's elements (4g + qd) * PE +
  // 4s + {0, 1} and + {2, 3} (16-bit products) or its codes (4g + qd) * PE +
  // 8s + {0..3} and {4..7} (QK), the permutation of k the A fragments use;
  // qs_row: the factor of this lane's score rows 2 qd + e (QK: the q scale;
  // F16: the inverse of q's power of two)
  uint32_t qf[NK][2];
  float qs_row[2] = {1.f, 1.f};
  if constexpr (QK) {
    for (int r = warp; r < MAX_ROWS; r += NW) {
      if (r < nr) {
        const __nv_bfloat16* qr = q + row_of(r) * D;
        float amax = 0.f;
        for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(__bfloat162float(qr[d])));
        const float sc = fmaxf(nst::warp_max(amax), 1e-6f) / 127.0f;
        for (int d = lane; d < DI; d += 32) {
          const float x = d < D ? __bfloat162float(qr[d]) : 0.f;
          qi[r][d] = (int8_t)fminf(fmaxf(rintf(x / sc), -127.f), 127.f);
        }
        if (lane == 0) qsc[r] = sc;
      } else {
        for (int d = lane; d < DI; d += 32) qi[r][d] = 0;
        if (lane == 0) qsc[r] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int s = 0; s < KQ; ++s) {
        const int off = (4 * g + qd) * PE + 8 * s;
        const uint2 w = off < DI ? *reinterpret_cast<const uint2*>(&qi[gi][off])
                                 : make_uint2(0u, 0u);
        qf[g * KQ + s][0] = w.x;
        qf[g * KQ + s][1] = w.y;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) qs_row[e] = qsc[2 * qd + e];
  } else {
    const __nv_bfloat16* qr = gi < nr ? q + row_of(gi) * D : nullptr;
    float amax = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int ch = 4 * g + qd;
        const bool in = qr != nullptr && (EXACT ? ch < CH : ch < nch);
        const uint2 w = in ? *reinterpret_cast<const uint2*>(qr + ch * PE + 4 * s)
                           : make_uint2(0u, 0u);
        qf[g * KS + s][0] = w.x;
        qf[g * KS + s][1] = w.y;
        if constexpr (F16) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
          amax = fmaxf(amax, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(c.x), fabsf(c.y))));
        }
      }
    if constexpr (F16) {
      // row gi's largest |q| (its copies lie in the quad's four lanes), and
      // the power of two 2^sh that takes it into [2^14, 2^15): every bf16
      // element is then an fp16 value (those below 2^-24 of it aside, whose
      // products fall below the float32 sum's rounding)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      const int sh = amax > 0.f ? min(max(15 - expo(amax), -126), 126) : 0;
      const float up = ldexpf(1.f, sh);
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 a =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[k][h]));
          const __half2 v = __floats2half2_rn(a.x * up, a.y * up);
          qf[k][h] = *reinterpret_cast<const uint32_t*>(&v);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        qs_row[e] = ldexpf(1.f, -__shfl_sync(0xffffffffu, sh, 4 * (2 * qd + e)));
    }
  }
  if constexpr (QSH) {
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < NK; ++k) qf_sh[k][lane] = make_uint2(qf[k][0], qf[k][1]);
    }
    __syncthreads();
  }
  float slope[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    slope[e] = slopes != nullptr && 2 * qd + e < nr
                   ? slopes[hk * n_rep + (2 * qd + e) / t]
                   : 0.f;

  float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f};
  int kp_run = 0;
  float o[NT][8];
#pragma unroll
  for (int s = 0; s < NT; ++s)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[s][i] = 0.f;

  // the block's steps: its warps walk them together and share each step's
  // row maxima, and a step's P is formed one step later, against the
  // block's running max through the next step (128 columns: the parent's
  // window, near the plain version's rounding against the row's max); a
  // warp past the split's end takes part with no column, and one more
  // iteration forms the last step's P
  const int bsteps = c1 > c0 ? (c1 - c0 + STEP * NW - 1) / (STEP * NW) : 0;
  float sp[4] = {0.f, 0.f, 0.f, 0.f}, vsp[2] = {1.f, 1.f};  // the previous step's
  bool vp[4] = {false, false, false, false}, live_p = false;
  int cs_p = 0;
  for (int j = 0; j <= bsteps; ++j) {
    if (j < bsteps) {
      cp_wait<STAGES - 2>();
      __syncwarp();
    }
    const int cs = first + STEP * NW * j;
    const bool live = j < bsteps && cs < c1;  // the warp's
    const unsigned char* kt = ring + (j % STAGES) * RG::kStage;
    const SC* kss = reinterpret_cast<const SC*>(kt + 2 * STEP * RG::kStride);
    const SC* vss = reinterpret_cast<const SC*>(kt + 2 * STEP * RG::kStride + RG::kScales);

    // S^T = K q^T: 16 columns (gi, gi + 8) x 8 rows (2 qd, 2 qd + 1), in two
    // accumulators (even and odd k steps: two dependent chains, not one)
    float sv[4];
    {
      using Raw = typename Chunk<T, VB>::Raw;
      float sa0[4] = {0.f, 0.f, 0.f, 0.f}, sa1[4] = {0.f, 0.f, 0.f, 0.f};
      int si0[4] = {0, 0, 0, 0}, si1[4] = {0, 0, 0, 0};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (!live) break;
        const int ch = 4 * g + qd;
        const bool in = EXACT ? (CH % 4 == 0 || ch < CH) : ch < nch;
        Raw x0{}, x1{};
        if (in) {
          x0 = *reinterpret_cast<const Raw*>(kt + gi * RS + ch * VB);
          x1 = *reinterpret_cast<const Raw*>(kt + (gi + 8) * RS + ch * VB);
        }
        if constexpr (QK) {
          const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&x0);
          const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&x1);
#pragma unroll
          for (int s = 0; s < KQ; ++s) {
            const int k = g * KQ + s;
            const uint32_t a[4] = {w0[2 * s], w1[2 * s], w0[2 * s + 1], w1[2 * s + 1]};
            if (k & 1)
              mma_s8(si1, a, qf[k][0], qf[k][1]);
            else
              mma_s8(si0, a, qf[k][0], qf[k][1]);
          }
        } else {
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            const int k = g * KS + s;
            uint32_t a[4];
            Chunk<T, VB>::pairs(x0, s, a[0], a[2]);
            Chunk<T, VB>::pairs(x1, s, a[1], a[3]);
            float* acc = (k & 1) ? sa1 : sa0;
            uint32_t b0 = qf[k][0], b1 = qf[k][1];
            if constexpr (QSH) {
              const uint2 w = qf_sh[k][lane];
              b0 = w.x;
              b1 = w.y;
            }
            if constexpr (F16)
              mma_f16(acc[0], acc[1], acc[2], acc[3], a, b0, b1);
            else
              mma_bf16(acc[0], acc[1], acc[2], acc[3], a, b0, b1);
          }
        }
        // the widest rows: one group's loads live at a time
        if constexpr (QSH) asm volatile("" ::: "memory");
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = QK ? (float)(si0[i] + si1[i]) * qs_row[i & 1]
                   : (F16 ? (sa0[i] + sa1[i]) * qs_row[i & 1] : sa0[i] + sa1[i]);
    }

    // the softmax over the step: sv[i] is column gi + 8 (i >> 1), row 2 qd
    // + (i & 1); P = 2^(s log2(e) - m log2(e)) on the MUFU
    float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
    if (RG::kQuant && live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ksc[h] = nst::scale_to_float(kss[gi + 8 * h]);
        vsc[h] = nst::scale_to_float(vss[gi + 8 * h]);
      }
    }
    bool valid[4];
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1, e = i & 1, col = cs + gi + 8 * h;
      float x = RG::kQuant ? sv[i] * ksc[h] * sm_scale : sv[i] * sm_scale;
      if (CAP == ON || (CAP == RUNTIME && softcap > 0.f)) x = nst::softcap_score(x, softcap);
      if (slopes != nullptr) x = nst::add_alibi(x, slope[e], col, r_pos[e]);
      valid[i] = live && col < c1 && col < r_end[e];
      sv[i] = x;
      if (valid[i]) mx[e] = fmaxf(mx[e], x);
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 4));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 8));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 16));
      if (gi == 0) smax[j & 1][warp][2 * qd + e] = mx[e];
    }
    __syncthreads();  // (two buffers: one barrier a step)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int w = 0; w < NW; ++w) mx[e] = fmaxf(mx[e], smax[j & 1][w][2 * qd + e]);
      const float m_new = fmaxf(m_run[e], mx[e]);
      alpha[e] = exp2_ftz((m_run[e] - m_new) * LOG2E);
      m_run[e] = m_new;
      ms[e] = m_new * LOG2E;
    }
    // P of the previous step (its scores sp, columns cs_p + gi (+ 8))
    float pw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1, e = i & 1;
      const float pr = vp[i] ? exp2_ftz(fmaf(sp[i], LOG2E, -ms[e])) : 0.f;
      l_run[e] = (h == 0 ? alpha[e] * l_run[e] : l_run[e]) + pr;
      pw[i] = RG::kQuant ? pr * vsp[h] : pr;
    }
    // P^T's B fragment: rows gi, columns 2 qd, 2 qd + 1 (+ 8)
    uint32_t b0, b1;
    if constexpr (V16) {
      float vm = fmaxf(live_p && cs_p + gi < c1 ? vsp[0] : 0.f,
                       live_p && cs_p + gi + 8 < c1 ? vsp[1] : 0.f);
      vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, 4));
      vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, 8));
      vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, 16));
      const int kp = vm > 0.f ? min(max(15 - expo(vm), -126), 126) : kp_run;
      const float up = pow2(kp), shift = pow2(kp - kp_run);
      kp_run = kp;
#pragma unroll
      for (int e = 0; e < 2; ++e) alpha[e] *= shift;
      b0 = transpose8(pack_f16(nst::round_bf16(pw[0]) * up, nst::round_bf16(pw[1]) * up));
      b1 = transpose8(pack_f16(nst::round_bf16(pw[2]) * up, nst::round_bf16(pw[3]) * up));
    } else {
      b0 = transpose8(pack_bf16(pw[0], pw[1]));
      b1 = transpose8(pack_bf16(pw[2], pw[3]));
    }

    // O^T += V^T P^T over 32-feature slabs: this lane's features d0 .. d0 + 3
    // of rows 2 qd (even accumulators) and 2 qd + 1 (odd)
    using VR = typename V4<T>::Raw;
    const unsigned char* vrow =
        ring + ((j + STAGES - 1) % STAGES) * RG::kStage + STEP * RG::kStride + 2 * qd * RS;
    // (no rescale while the running maxima and P's power of two stand still)
    const bool rescale = !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f);
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      if (rescale) {
#pragma unroll
        for (int i = 0; i < 8; ++i) o[s][i] *= alpha[i & 1];
      }
      if (!live_p) continue;
      const int d0 = 32 * s + 4 * gi;
      const bool in = EXACT ? (DI % 32 == 0 || d0 < DI) : d0 < D;
      uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const size_t off = (size_t)d0 * sizeof(T);
        V4<T>::pairs(*reinterpret_cast<const VR*>(vrow + off),
                     *reinterpret_cast<const VR*>(vrow + RS + off), lo);
        V4<T>::pairs(*reinterpret_cast<const VR*>(vrow + 8 * RS + off),
                     *reinterpret_cast<const VR*>(vrow + 9 * RS + off), hi);
      }
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
      if constexpr (V16) {
        mma_f16(o[s][0], o[s][1], o[s][2], o[s][3], a0, b0, b1);
        mma_f16(o[s][4], o[s][5], o[s][6], o[s][7], a1, b0, b1);
      } else {
        mma_bf16(o[s][0], o[s][1], o[s][2], o[s][3], a0, b0, b1);
        mma_bf16(o[s][4], o[s][5], o[s][6], o[s][7], a1, b0, b1);
      }
      if constexpr (QSH) asm volatile("" ::: "memory");
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sp[i] = sv[i];
      vp[i] = valid[i];
    }
    vsp[0] = vsc[0];
    vsp[1] = vsc[1];
    live_p = live;
    cs_p = cs;
    __syncwarp();     // the previous step's stage is read: refill it
    issue(j + STAGES - 1);
  }
  cp_wait<0>();
  if constexpr (V16) {  // O from the last step's domain, O 2^kp
    const float down = pow2(-kp_run);
#pragma unroll
    for (int s = 0; s < NT; ++s)
#pragma unroll
      for (int i = 0; i < 8; ++i) o[s][i] *= down;
  }

  // ---- the block's partial: the warps' states merged in warp order
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 4);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 8);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 16);
  }
  __syncthreads();  // every warp is done with its ring
  float* wm = reinterpret_cast<float*>(smem);  // [NW][MAX_ROWS]
  float* wl = wm + NW * MAX_ROWS;              // [NW][MAX_ROWS]
  float* wacc = wl + NW * MAX_ROWS;            // [NW][MAX_ROWS][DI]
  if (gi == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      wm[warp * MAX_ROWS + 2 * qd + e] = m_run[e];
      wl[warp * MAX_ROWS + 2 * qd + e] = l_run[e];
    }
  }
#pragma unroll
  for (int s = 0; s < NT; ++s) {
    const int d0 = 32 * s + 4 * gi;
    if (d0 < DI) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(&wacc[(warp * MAX_ROWS + 2 * qd + e) * DI + d0]) =
            make_float4(o[s][e], o[s][2 + e], o[s][4 + e], o[s][6 + e]);
    }
  }
  __syncthreads();
  const int nq = D / 4;
  for (int it = tid; it < nr * nq; it += THREADS) {
    const int r = it / nq, d = 4 * (it % nq);
    float mx = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * MAX_ROWS + r]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float ew = expf(wm[w * MAX_ROWS + r] - mx);
      const float4 x = *reinterpret_cast<const float4*>(&wacc[(w * MAX_ROWS + r) * DI + d]);
      a.x += x.x * ew;
      a.y += x.y * ew;
      a.z += x.z * ew;
      a.w += x.w * ew;
      l += wl[w * MAX_ROWS + r] * ew;
    }
    const size_t pi = row_of(r) * splits + split;
    *reinterpret_cast<float4*>(&part_acc[pi * D + d]) = a;
    if (d == 0) {
      part_m[pi] = mx;
      part_l[pi] = l;
    }
  }

  // ---- the last block of the (slot, KV head) merges the splits: the
  // counter's add releases this block's partials (the barrier orders the
  // block's writes before it) and acquires the earlier blocks'
  __syncthreads();
  int* counter = counters + (size_t)b * Hkv + hk;
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    s_last = prev == n_live - 1;
    if (s_last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (!s_last) return;

  // in split order, one split at a time against the running max: the
  // partials' loads do not wait on the sums, so they are in flight together
  for (int it = tid; it < nr * nq; it += THREADS) {
    const int r = it / nq, d = 4 * (it % nq);
    const size_t row = row_of(r);
    float m = -FLT_MAX, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid0) {
      const uint2 w = *reinterpret_cast<const uint2*>(v_new + nidx + d);
      const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
      const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
      m = s0_sh[r];
      l = 1.f;
      a = make_float4(v01.x, v01.y, v23.x, v23.y);
    }
    const float* pm = part_m + row * splits;
    const float* pl = part_l + row * splits;
    const float* pa = part_acc + row * splits * D + d;
#pragma unroll 16
    for (int i = 0; i < n_live; ++i) {
      const float mi = __ldcg(pm + i), li = __ldcg(pl + i);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(pa + (size_t)i * D));
      const float m_new = fmaxf(m, mi);
      const float so = expf(m - m_new), si = expf(mi - m_new);
      l = l * so + li * si;
      a.x = a.x * so + x.x * si;
      a.y = a.y * so + x.y * si;
      a.z = a.z * so + x.z * si;
      a.w = a.w * so + x.w * si;
      m = m_new;
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    if (out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + row * D + d) =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    } else {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + row * D + d) =
          make_uint2(pack_bf16(a.x * inv, a.y * inv), pack_bf16(a.z * inv, a.w * inv));
    }
  }

  if constexpr (E::kQuantized) {
    if (!append) return;
    const size_t at = cache.rows(layer, b, hk)(max(kvl - 1, 0));
    const float kq = quant_sh[0], vq = quant_sh[1];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int d = tid + i * THREADS;
      if (d < D) {
        kc[at * D + d] = (int8_t)fminf(fmaxf(rintf(kx[i] / kq), -127.f), 127.f);
        vc[at * D + d] = (int8_t)fminf(fmaxf(rintf(vx[i] / vq), -127.f), 127.f);
      }
    }
    if (tid == 0) {
      ks[at] = nst::from_float<SC>(kq);
      vs[at] = nst::from_float<SC>(vq);
    }
  }
}

// Launches one kernel instance, its shared-memory size set once.
template <class T, int VB, bool EXACT, class Cache, class SC, int CAP, bool QK>
cudaError_t launch_kernel(dim3 grid, cudaStream_t st, Cache cache, const void* q,
                          const void* k_new, const void* v_new, void* kc, void* vc,
                          void* ks, void* vs, const void* slopes, const int* pos,
                          const void* kv_lens, const int* lim, void* part_m, void* part_l,
                          void* part_acc, void* counters, void* out, int H, int Hkv,
                          int S, int D, int layer, int chunk, int extra, int fused_append,
                          int t, int out_f32, float sm_scale, float softcap) {
  using RG = Ring<T, SC>;
  auto kernel = flash_decode_kernel<T, VB, EXACT, Cache, SC, CAP, QK>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RG::kBytes);
  if (attr != cudaSuccess) return attr;
  using bf16 = __nv_bfloat16;
  kernel<<<grid, RG::kWarps * 32, RG::kBytes, st>>>(
      cache, static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<SC*>(ks), static_cast<SC*>(vs), static_cast<const float*>(slopes), pos,
      static_cast<const int*>(kv_lens), lim, static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc),
      static_cast<int*>(counters), out, H, Hkv, S, D, layer, chunk, extra, fused_append, t,
      out_f32, sm_scale, softcap);
  return cudaGetLastError();
}

template <class T, int VB, bool EXACT, class SC, class Cache>
cudaError_t launch(Cache cache, const void* q, const void* k_new, const void* v_new,
                   void* kc, void* vc, void* ks, void* vs, const void* slopes,
                   const void* pos, const void* kv_lens, void* part_m, void* part_l,
                   void* part_acc, void* counters, void* out, int B, int H, int Hkv,
                   int S, int D, int layer, int chunk, int extra, int fused_append,
                   int causal, int out_f32, int qk, int t, float sm_scale, float softcap,
                   cudaStream_t st) {
  const dim3 grid((S + chunk - 1) / chunk, Hkv, B);
  // t > 1: the rows' limits are their positions (causal) or kv_len (null)
  const int* pos_i = static_cast<const int*>(pos);
  const int* lim = t > 1 ? (causal ? pos_i : nullptr)
                         : static_cast<const int*>(causal ? pos : kv_lens);
#define NST_LAUNCH(CAP, QK)                                                            \
  launch_kernel<T, VB, EXACT, Cache, SC, CAP, QK>(                                     \
      grid, st, cache, q, k_new, v_new, kc, vc, ks, vs, slopes, pos_i, kv_lens, lim,   \
      part_m, part_l, part_acc, counters, out, H, Hkv, S, D, layer, chunk, extra,      \
      fused_append, t, out_f32, sm_scale, softcap)
  if constexpr (nst::KVElem<T>::kQuantized) {
    if (qk) {
      if constexpr (EXACT)
        return softcap > 0.f ? NST_LAUNCH(ON, true) : NST_LAUNCH(OFF, true);
      else
        return NST_LAUNCH(RUNTIME, true);
    }
  }
  if constexpr (EXACT)
    return softcap > 0.f ? NST_LAUNCH(ON, false) : NST_LAUNCH(OFF, false);
  else
    return NST_LAUNCH(RUNTIME, false);
#undef NST_LAUNCH
}

// kv_type: 0 int8 codes with bf16 scales, 3 int8 codes with float32
// scales, 1 bf16 values, 2 float32 values (no scales, no extra column, no
// append).  D: the head dim, a multiple of 8 at most this instance's
// (below it, the masked kernels); int8 rows of D % 16 == 8 take 8-byte
// copies.  causal: 1 or 0; out_f32: 1 for a float32 output, 0 for bf16;
// qk: 1 for the int8 score dot (int8 only), else 0.  t: tokens per slot,
// 1 but for the int8 dot over the contiguous cache without the extra
// column, where t * (H / Hkv) <= MAX_ROWS, positions [B, t] and the output
// [B, t, H, D].  chunk: columns per split, a multiple of TILE, at most
// MAX_SPLITS splits; the partials hold B * t * H rows of that many splits;
// counters: B * Hkv ints, zero (and left zero).  softcap: 0 (off) or the
// logit softcap.
template <class Cache>
int launch_d(Cache cache, int D, const void* q, const void* k_new, const void* v_new,
             void* kc, void* vc, void* ks, void* vs, const void* slopes, const void* pos,
             const void* kv_lens, void* part_m, void* part_l, void* part_acc,
             void* counters, void* out, int B, int H, int Hkv, int S, int layer,
             int chunk, int extra, int fused_append, int kv_type, int causal,
             int out_f32, int qk, int t, float sm_scale, float softcap, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bool int8 = kv_type == 0 || kv_type == 3;
  if (D > DI || D <= 0 || D % 8 || kv_type < 0 || kv_type > 3 || Hkv <= 0 || H % Hkv ||
      (!int8 && (extra || fused_append || qk)) || (causal != 0 && causal != 1) ||
      (out_f32 != 0 && out_f32 != 1) || (qk != 0 && qk != 1) || !(softcap >= 0.f) ||
      t < 1 || t * (H / Hkv) > MAX_ROWS || chunk <= 0 || chunk % TILE ||
      (S + chunk - 1) / chunk > MAX_SPLITS ||
      (t > 1 && (!qk || extra || fused_append || NST_FLASH_PAGED)))
    return (int)cudaErrorInvalidValue;
#define NST_ARGS                                                                         \
  cache, q, k_new, v_new, kc, vc, ks, vs, slopes, pos, kv_lens, part_m, part_l, part_acc, \
      counters, out, B, H, Hkv, S, D, layer, chunk, extra, fused_append, causal, out_f32, \
      qk, t, sm_scale, softcap, st
#define NST_LAUNCH_INT8(SC)                          \
  (D == DI         ? launch<int8_t, 16, true, SC>(NST_ARGS)  \
   : D % 16 == 0 ? launch<int8_t, 16, false, SC>(NST_ARGS) \
                 : launch<int8_t, 8, false, SC>(NST_ARGS))
  using bf16 = __nv_bfloat16;
  const bool exact = D == DI;
  cudaError_t err;
  if (kv_type == 1)
    err = exact ? launch<bf16, 16, true, bf16>(NST_ARGS) : launch<bf16, 16, false, bf16>(NST_ARGS);
  else if (kv_type == 2)
    err = exact ? launch<float, 16, true, bf16>(NST_ARGS)
                : launch<float, 16, false, bf16>(NST_ARGS);
  else if (kv_type == 3)
    err = NST_LAUNCH_INT8(float);
  else
    err = NST_LAUNCH_INT8(bf16);
#undef NST_ARGS
#undef NST_LAUNCH_INT8
  return (int)err;
}

}  // namespace

#if !NST_FLASH_PAGED
// slopes: float32 [H] ALiBi slopes, or null for none.  k_new / v_new are
// read only with `extra`; ks / vs only for the int8 cache.  t: tokens per
// slot (launch_d); pos is [B] at t = 1, [B, t] above.  The int8 cache's
// rows S must be a multiple of 8 (its scales' copies are 16 bytes).
extern "C" int nst_flash_decode(const void* q, const void* k_new, const void* v_new,
                                void* kc, void* vc, void* ks, void* vs,
                                const void* slopes, const void* pos,
                                const void* kv_lens, void* part_m, void* part_l,
                                void* part_acc, void* counters, void* out, int B, int H,
                                int Hkv, int S, int D, int layer, int chunk, int extra,
                                int fused_append, int kv_type, int causal, int out_f32,
                                int qk, int t, float sm_scale, float softcap,
                                void* stream) {
  if ((kv_type == 0 || kv_type == 3) && S % 8) return (int)cudaErrorInvalidValue;
  return launch_d(nst::ContigCache{B, Hkv, S}, D, q, k_new, v_new, kc, vc, ks, vs, slopes,
                  pos, kv_lens, part_m, part_l, part_acc, counters, out, B, H, Hkv, S,
                  layer, chunk, extra, fused_append, kv_type, causal, out_f32, qk, t,
                  sm_scale, softcap, stream);
}

#else
// The pool [L, Hkv, P, ps, D] with scales [L, Hkv, P, 1, ps] (int8) and
// int32 tables [B, n_blocks]; the logical length is n_blocks * ps, ps a
// multiple of 16 (a warp's step of 16 rows never crosses a page).
extern "C" int nst_flash_decode_paged(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc, void* ks,
    void* vs, const void* slopes, const void* tables, const void* pos, const void* kv_lens,
    void* part_m, void* part_l, void* part_acc, void* counters, void* out, int B, int H,
    int Hkv, int P, int ps, int n_blocks, int D, int layer, int chunk, int extra,
    int fused_append, int kv_type, int causal, int out_f32, int qk, float sm_scale,
    float softcap, void* stream) {
  if (ps <= 0 || ps % STEP) return (int)cudaErrorInvalidValue;
  return launch_d(nst::PagedCache{static_cast<const int*>(tables), Hkv, P, ps, n_blocks}, D,
                  q, k_new, v_new, kc, vc, ks, vs, slopes, pos, kv_lens, part_m, part_l,
                  part_acc, counters, out, B, H, Hkv, n_blocks * ps, layer, chunk, extra,
                  fused_append, kv_type, causal, out_f32, qk, 1, sm_scale, softcap, stream);
}
#endif
