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
//
// Bound: bytes.  Each step reads the K and V of every live column once
// (about 0.5 GB per Llama-2-7B step at ctx 2000, B = 1, in int8; twice that
// in bf16, four times in float32).
// Design: flash-decoding.  B * Hkv = 32 blocks cannot fill 132 SMs, so the
// sequence is split into chunks of `chunk` columns across blocks
// (gridDim.x); each block keeps its partial max / sum / accumulator, and a
// second kernel (one block per (b, hk)) merges the partials with the seed
// column, writes the output and performs the append.  The append cannot race
// with the reads: the new row sits at kv_len - 1 >= kv_len_cache, which no
// block reads, and exactly one block writes it.  Within a block, a thread
// scores one column (its K row as 16-byte loads: 16 int8 codes, 8 bf16 or 4
// float32 values each; 8-byte loads for int8 rows of D % 16 == 8) and, after
// the softmax step, owns the output features tid and tid + 128 (at D = 256
// two each; at D = 80 or 96 threads past D own none); the V rows of each
// 128-column sub-chunk are staged in dynamic shared memory with coalesced
// loads, float32 rounded to bf16 on the way (128 * D bytes in int8, twice
// that in bf16 and float32; static shared memory up to 32 KiB, dynamic
// above: 64 KiB at D = 256 is beyond the 48 KB of static shared memory).  The score loop is unrolled over 128 elements of the K
// row (all of it up to D = 128, half at 256, which keeps the instance's
// build time near the 128 one's), loads at constant offsets from the row.
// Head dims below the instance's (a multiple of 8 without an instance of
// its own, as 72 through the 80 instance) take the instance's masked
// kernels (EXACT = false): a runtime D <= NST_FLASH_DIM, a rolled score
// loop over the row's D / PER loads, and the V chunks and output features
// past D skipped.  The instance's own head dim takes kernels in which D is
// the compile-time NST_FLASH_DIM (EXACT): with a runtime D, ptxas spilled
// 4-20 bytes in most of the split kernels and B ran 1.03-1.35x its time
// before the head-dim instances; with the V stage in dynamic shared memory
// at every size, the bf16 instance still ran 1.10-1.27x.
//
// Paged: the kernels are templates over the cache addressing
// (common.cuh): every column's row is resolved through the slot's page
// table, per column, so a 128-column sub-chunk may span pages (8 of them at
// page size 16); the arithmetic and its order are the contiguous kernel's.
// The append writes a live slot's row at table[b, (kv_len - 1) / ps]; a
// spectator writes nothing (the JAX kernel parks it on the trash page).
//
// The softcap and the scale type: the scale type (SC, bf16 or float32) is a
// template parameter of the int8 kernels.  The softcap (a runtime argument,
// 0 = off) is a compile-time flag of the exact split kernels (CAP = OFF or
// ON) and of the combine kernel (CAPPED), so the kernels without it are the
// code they were before it: tested at run time, once per column, the
// branch moved kernels B and 10 by 0.75-1.25x at equal work (NVIDIA H100
// 80GB HBM3, 700 W, parent and change in one run), and in the combine
// kernel it cost the main decode case 6%.  The masked
// kernels (head dims without an instance of their own) test it at run time
// (CAP = RUNTIME), which keeps their count, and the build, unchanged.
//
// Causality reaches the split kernels as data, not as a flag: the column
// end is min(kv_len_cache, lim[b] + 1), where the launcher passes `pos` as
// `lim` (causal) or `kv_lens` (non-causal: lim + 1 lies past every cached
// column), so their body is the causal one with no test of a flag (a
// runtime flag there made the D = 256 instance spill more).  The output
// type (OT, bf16 or float32) is a template parameter of the combine kernel
// only, which writes the output: a second small instance.
//
// The int8 score dot (NST_FLASH_INT8=qk, the JAX body's `quantized and
// FLASH_INT8_DOT` branch, flash.py:464-479): each q row is quantized to int8
// codes with the per-row scale qsc = max(max|q|, 1e-6) / 127 (IEEE
// division; codes rint(q / qsc) clipped to +-127), and a column's score is
// float(int32 dot of the codes with the K codes) * qsc * k_scale * sm_scale,
// then the softcap, ALiBi and the mask as before.  The seed column keeps the
// float product.  It is a compile-time parameter (QK) of the int8 split
// kernels only, exact and masked, both scale types: a runtime test in B's
// inner loop moved B and 10 by 0.75-1.25x (the softcap, above), so the
// kernels without it are the code they were.  Each block quantizes its
// rows' q into shared memory (one warp per row: the row's |max| by warp
// shuffles, then the codes); a thread scores its column with __dp4a over
// its 16-byte (8-byte) K loads against 16-byte (8-byte) shared loads of the
// codes, and the int32 sum is exact.
//
// Several tokens per slot (the int8 dot only: the JAX launcher sends calls
// of t tokens with t * n_rep <= 8, an even KV head count and S % 128 == 0
// to the same body, `_mha_packed_hblk`, flash.py:732; speculative decoding
// verifies 2-8 tokens so): the rows of a (slot, KV head) block are the
// t * n_rep (query head, token) pairs, rep-major (row rep * t + ti, head
// hk * n_rep + rep, token ti, as the JAX launcher packs them), q and the
// output in the natural [B, t, H, D] layout, positions [B, t].  Each row
// has its own position, so its own column end (min(kv_len, pos + 1) when
// causal, kv_len when not) and ALiBi distance: the prologue writes both to
// shared memory once, and the block reads columns up to the largest end
// (the JAX body skips a block only past every row's limit, flash.py:445).
// There is no extra column and no append at t > 1 (the JAX package refuses
// them, `extra_kv_eligible`), and no such call on the pool.  It is a
// compile-time parameter (MULTI) of the QK split kernels over the
// contiguous cache, R chosen from t * n_rep, so the t = 1 kernels are the
// code they were; the combine kernel runs unchanged over B * t virtual
// slots of one token.
//
// Compiled without --use_fast_math: the quantization must match
// kv_cache.quantize_kv bit for bit (IEEE division, round half to even), and
// the softcap the plain versions' torch.tanh (libdevice's tanhf).

#include "common.cuh"

#if !defined(NST_FLASH_DIM) || !defined(NST_FLASH_PAGED)
#error "define NST_FLASH_DIM and NST_FLASH_PAGED before including this file"
#endif

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int MAX_REP = 8;
constexpr int DI = NST_FLASH_DIM;                   // the instance's head dim
constexpr int NF = (DI + THREADS - 1) / THREADS;    // features per thread
// The split kernel's softcap: none, applied, or as the argument says.
enum Cap { OFF, ON, RUNTIME };

// Bytes of a sub-chunk's V rows in shared memory, and whether they fit a
// static array (up to 32 KiB: every element type up to D = 128, int8 at
// 256); above that, dynamic shared memory.
template <class T>
struct VStage {
  static constexpr int kBytes =
      THREADS * DI * (int)sizeof(typename nst::KVElem<T>::Stage);
  static constexpr bool kStatic = kBytes <= 32 * 1024;
};

// si[r] += qi[r] . (chunk `ch` of the int8 K row kr), for the n_rep rows:
// the int8 score dot's int32 sums (__dp4a over 4-byte words).
template <int R, int VB>
__device__ __forceinline__ void score_chunk_qk(int (&si)[R],
                                               const int8_t (*qi)[DI],
                                               const int8_t* kr, int ch,
                                               int n_rep) {
  using Raw = typename nst::RowChunk<int8_t, VB>::Raw;
  constexpr int W = VB / 4;                  // words per load
  const nst::RowChunk<int8_t, VB> k8(kr + ch * VB);
  const int* kw = reinterpret_cast<const int*>(&k8.raw);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < n_rep) {
      const Raw q8 = *reinterpret_cast<const Raw*>(&qi[r][ch * VB]);
      const int* qw = reinterpret_cast<const int*>(&q8);
#pragma unroll
      for (int w = 0; w < W; ++w) si[r] = __dp4a(kw[w], qw[w], si[r]);
    }
  }
}

// s[r] += q[r] . (chunk `ch` of the K row kr), for the n_rep rows.
template <int R, class T, int VB>
__device__ __forceinline__ void score_chunk(float (&s)[R],
                                            const float (*qs)[DI],
                                            const T* kr, int ch, int n_rep) {
  using E = nst::KVElem<T>;
  constexpr int PER = VB / (int)sizeof(T);
  const nst::RowChunk<T, VB> kv8(kr + ch * PER);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float kv = E::to_float(kv8[j]);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < n_rep) s[r] = fmaf(qs[r][ch * PER + j], kv, s[r]);
  }
}

// R: a power of two >= the block's rows (n_rep, or t * n_rep with MULTI),
// so the per-row arrays have compile-time indices and stay in registers.
// T: the cache's element type (KVElem); VB: bytes per row load; EXACT: D
// is the instance's head dim; SC: the int8 cache's scale type; CAP: the
// softcap (Cap); QK: the int8 score dot (int8 T only); MULTI: t tokens per
// slot (QK only, no extra column), each row with its own position.
template <int R, class T, int VB, bool EXACT, class Cache, class SC, int CAP,
          bool QK = false, bool MULTI = false>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(Cache cache, const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const SC* __restrict__ ks, const SC* __restrict__ vs,
                   const float* __restrict__ slopes,
                   const int* __restrict__ pos, const int* __restrict__ kv_lens,
                   const int* __restrict__ lim, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int H, int Hkv, int S, int D, int layer, int chunk,
                   int extra, int t, float sm_scale, float softcap) {
  if constexpr (EXACT) D = DI;
  using E = nst::KVElem<T>;
  using ST = typename E::Stage;
  using SE = nst::KVElem<ST>;
  constexpr int PER = VB / (int)sizeof(T);   // elements per load
  constexpr int CH = DI / PER;               // loads per row of the instance
  constexpr int CU = CH * PER <= 128 ? CH : 128 / PER;  // unrolled loads
  const int nch = D / PER;                   // loads per row
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int n_rep = H / Hkv;
  const int nr = MULTI ? t * n_rep : n_rep;  // the block's rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvl = kv_lens[b];
  // MULTI: each row's position and column end, set once here; the block
  // reads columns up to the largest end
  __shared__ int row_pos[MULTI ? R : 1];
  __shared__ int row_end[MULTI ? R : 1];
  int p, c_end;
  if constexpr (MULTI) {
    p = 0;
    c_end = 0;
    for (int r = 0; r < nr; ++r) {
      const int pr = pos[b * t + r % t];
      const int e = min(lim != nullptr ? min(kvl, pr + 1) : kvl, S);
      c_end = max(c_end, e);
      if (tid == r) {
        row_pos[r] = pr;
        row_end[r] = e;
      }
    }
  } else {
    p = pos[b];
    const int kvl_cache = kvl - (extra && p == kvl - 1 ? 1 : 0);
    c_end = min(min(kvl_cache, lim[b] + 1), S);
  }
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, c_end);
  // the q / output / partials row of block row r: head hk * n_rep + r, or
  // with MULTI rep-major rows r = rep * t + ti (head hk * n_rep + rep at
  // token ti), as the JAX launcher packs them
  auto row_of = [&](int r) -> size_t {
    if constexpr (MULTI)
      return ((size_t)b * t + r % t) * H + hk * n_rep + r / t;
    else
      return (size_t)b * H + hk * n_rep + r;
  };

  static_assert(!QK || nst::KVElem<T>::kQuantized, "qk reads int8 K");
  static_assert(!MULTI || QK, "several tokens per slot run the int8 dot");
  __shared__ float qs[QK ? 1 : R][DI];
  // the int8 score dot: q rows' codes and scales
  __shared__ __align__(16) int8_t qi[QK ? R : 1][DI];
  __shared__ float qsc[QK ? R : 1];
  __shared__ float ps[R][THREADS];
  __shared__ float red_max[R][NW];
  __shared__ float red_sum[R][NW];
  // V rows of a sub-chunk [128][DI]
  __shared__ __align__(16) ST vsm_static[VStage<T>::kStatic ? THREADS * DI
                                                              : 1];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  ST* vsm = VStage<T>::kStatic ? vsm_static : reinterpret_cast<ST*>(dyn_smem);

  if constexpr (QK) {
    for (int r = warp; r < nr; r += NW) {
      const __nv_bfloat16* qr = q + row_of(r) * D;
      float amax = 0.f;
      for (int d = lane; d < D; d += 32)
        amax = fmaxf(amax, fabsf(__bfloat162float(qr[d])));
      const float sc = fmaxf(nst::warp_max(amax), 1e-6f) / 127.0f;
      for (int d = lane; d < DI; d += 32) {
        const float x = d < D ? __bfloat162float(qr[d]) : 0.f;
        qi[r][d] = (int8_t)fminf(fmaxf(rintf(x / sc), -127.f), 127.f);
      }
      if (lane == 0) qsc[r] = sc;
    }
  } else {
    for (int i = tid; i < n_rep * DI; i += THREADS) {
      const int r = i / DI, d = i % DI;
      qs[r][d] = d < D ? __bfloat162float(
                             q[((size_t)b * H + hk * n_rep + r) * D + d])
                       : 0.f;
    }
  }
  float slope[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    slope[r] = slopes != nullptr && r < nr
                   ? slopes[hk * n_rep + (MULTI ? r / t : r)]
                   : 0.f;
  __syncthreads();

  const auto rows = cache.rows(layer, b, hk);

  float m_run[R], l_run[R], acc[R][NF];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[r][f] = 0.f;
  }

  for (int cs = c0; cs < c1; cs += THREADS) {
    const int c = cs + tid;
    const bool valid = c < c1;
    // stage this sub-chunk's V rows with coalesced loads; they are in
    // flight while the scores are computed
    const int ncols = min(THREADS, c1 - cs);
    for (int i = tid; i < ncols * CH; i += THREADS) {
      const int col = i / CH, ch = i % CH;
      if (ch < nch)
        nst::stage_chunk<T, VB>(vsm + col * DI + ch * PER,
                                vc + rows(cs + col) * D + ch * PER);
    }
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    float vsc = 1.f;
    if (valid) {
      const size_t rc = rows(c);
      const T* kr = kc + rc * D;
      if constexpr (QK) {
        int si[R];
#pragma unroll
        for (int r = 0; r < R; ++r) si[r] = 0;
        if constexpr (EXACT) {
#pragma unroll (CU)
          for (int ch = 0; ch < CH; ++ch)
            score_chunk_qk<R, VB>(si, qi, kr, ch, nr);
        } else {
#pragma unroll 1
          for (int ch = 0; ch < nch; ++ch)
            score_chunk_qk<R, VB>(si, qi, kr, ch, nr);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nr) s[r] = (float)si[r] * qsc[r];
      } else if constexpr (EXACT) {
#pragma unroll (CU)
        for (int ch = 0; ch < CH; ++ch)
          score_chunk<R, T, VB>(s, qs, kr, ch, n_rep);
      } else {
#pragma unroll 1
        for (int ch = 0; ch < nch; ++ch)
          score_chunk<R, T, VB>(s, qs, kr, ch, n_rep);
      }
      if constexpr (E::kQuantized) {
        const float ksc = nst::scale_to_float(ks[rc]);
        vsc = nst::scale_to_float(vs[rc]);
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = s[r] * ksc * sm_scale;
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = s[r] * sm_scale;
      }
      if (CAP == ON || (CAP == RUNTIME && softcap > 0.f)) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nr) s[r] = nst::softcap_score(s[r], softcap);
      }
      if (slopes != nullptr) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[r] = nst::add_alibi(s[r], slope[r], c, MULTI ? row_pos[r] : p);
      }
    }
    // MULTI: a column is valid for row r below the row's own end
    auto valid_row = [&](int r) {
      if constexpr (MULTI)
        return valid && c < row_end[r];
      else
        return valid;
    };
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) continue;
      const float mx = nst::warp_max(valid_row(r) ? s[r] : -FLT_MAX);
      if (lane == 0) red_max[r][warp] = mx;
    }
    __syncthreads();
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) continue;
      float bmax = -FLT_MAX;
#pragma unroll
      for (int w = 0; w < NW; ++w) bmax = fmaxf(bmax, red_max[r][w]);
      const float m_new = fmaxf(m_run[r], bmax);
      alpha[r] = expf(m_run[r] - m_new);
      const float pr = valid_row(r) ? expf(s[r] - m_new) : 0.f;
      ps[r][tid] = E::kQuantized ? nst::round_bf16(pr * vsc)
                                 : nst::round_bf16(pr);
      const float sm = nst::warp_sum(pr);
      if (lane == 0) red_sum[r][warp] = sm;
      m_run[r] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) continue;
      float bsum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) bsum += red_sum[r][w];
      l_run[r] = alpha[r] * l_run[r] + bsum;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int d = tid + f * THREADS;
        if (d < D) {
          float a = 0.f;
          for (int j = 0; j < ncols; ++j)
            a = fmaf(ps[r][j], SE::to_float(vsm[j * DI + d]), a);
          acc[r][f] = acc[r][f] * alpha[r] + a;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) continue;
    const size_t pi = row_of(r) * splits + split;
    if (tid == 0) {
      part_m[pi] = m_run[r];
      part_l[pi] = l_run[r];
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int d = tid + f * THREADS;
      if (d < D) part_acc[pi * D + d] = acc[r][f];
    }
  }
}

// Merges the splits' partials (with the seed column when `extra`, softcapped
// when CAPPED), writes the output (OT: bf16 or float32) and, with
// `fused_append` (int8 only), the new row and its scales (SC: bf16 or
// float32).
template <class T, class Cache, class SC, bool CAPPED, class OT>
__global__ void __launch_bounds__(THREADS)
flash_decode_combine(Cache cache, const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new,
                     T* __restrict__ kc, T* __restrict__ vc,
                     SC* __restrict__ ks, SC* __restrict__ vs,
                     const int* __restrict__ pos,
                     const int* __restrict__ kv_lens,
                     const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     OT* __restrict__ out, int H, int Hkv, int D,
                     int layer, int splits, int extra, int fused_append,
                     float sm_scale, float softcap) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x;
  const int p = pos[b], kvl = kv_lens[b];
  const bool ok = p == kvl - 1;
  const bool valid0 = extra && ok && p >= 0;
  __shared__ float sh[NW];

  const size_t nidx = ((size_t)b * Hkv + hk) * D;
  float kn[NF], vn[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int d = tid + f * THREADS;
    kn[f] = extra && d < D ? __bfloat162float(k_new[nidx + d]) : 0.f;
    vn[f] = extra && d < D ? __bfloat162float(v_new[nidx + d]) : 0.f;
  }

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const size_t qo = ((size_t)b * H + h) * D;
    float s0 = 0.f;
    if (extra) {
      float part = 0.f;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int d = tid + f * THREADS;
        const float qv = d < D ? __bfloat162float(q[qo + d]) : 0.f;
        part += qv * kn[f];
      }
      s0 = nst::block_sum<NW>(part, sh) * sm_scale;
      if constexpr (CAPPED) s0 = nst::softcap_score(s0, softcap);
    }
    const size_t pi = ((size_t)b * H + h) * splits;
    float m = valid0 ? s0 : -FLT_MAX;
    for (int i = 0; i < splits; ++i) m = fmaxf(m, part_m[pi + i]);
    const float e0 = valid0 ? expf(s0 - m) : 0.f;
    float l = e0;
    float a[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) a[f] = e0 * vn[f];
    for (int i = 0; i < splits; ++i) {
      const float e = expf(part_m[pi + i] - m);
      l += part_l[pi + i] * e;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int d = tid + f * THREADS;
        if (d < D) a[f] += part_acc[(pi + i) * D + d] * e;
      }
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int d = tid + f * THREADS;
      if (d < D) out[qo + d] = nst::from_float<OT>(a[f] * inv);
    }
  }

  if constexpr (nst::KVElem<T>::kQuantized) {
    if (!(extra && fused_append && ok)) return;
    const size_t at = cache.rows(layer, b, hk)(max(kvl - 1, 0));
    float km = 0.f, vm = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      km = fmaxf(km, fabsf(kn[f]));
      vm = fmaxf(vm, fabsf(vn[f]));
    }
    const float kamax = nst::block_max<NW>(km, sh);
    const float vamax = nst::block_max<NW>(vm, sh);
    const float ksc = fmaxf(kamax, 1e-8f) / 127.0f;
    const float vsc = fmaxf(vamax, 1e-8f) / 127.0f;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int d = tid + f * THREADS;
      if (d < D) {
        kc[at * D + d] = (int8_t)fminf(fmaxf(rintf(kn[f] / ksc), -127.f), 127.f);
        vc[at * D + d] = (int8_t)fminf(fmaxf(rintf(vn[f] / vsc), -127.f), 127.f);
      }
    }
    if (tid == 0) {
      ks[at] = nst::from_float<SC>(ksc);
      vs[at] = nst::from_float<SC>(vsc);
    }
  }
}

// The split kernel for n_rep query heads per KV head (R: the next power of
// two up to MAX_REP) with the softcap CAP and the int8 score dot QK.
template <int CAP, class T, int VB, bool EXACT, class Cache, class SC,
          bool QK = false>
auto split_for(int n_rep)
    -> decltype(&flash_decode_split<1, T, VB, EXACT, Cache, SC, CAP>) {
  return n_rep <= 1   ? flash_decode_split<1, T, VB, EXACT, Cache, SC, CAP, QK>
         : n_rep <= 2 ? flash_decode_split<2, T, VB, EXACT, Cache, SC, CAP, QK>
         : n_rep <= 4 ? flash_decode_split<4, T, VB, EXACT, Cache, SC, CAP, QK>
                      : flash_decode_split<MAX_REP, T, VB, EXACT, Cache, SC,
                                           CAP, QK>;
}

// The int8-dot split kernel for t > 1 tokens per slot over `rows` = t *
// n_rep <= MAX_REP rows (R: the next power of two, at least 2).
template <int CAP, class T, int VB, bool EXACT, class Cache, class SC>
auto split_rows(int rows)
    -> decltype(&flash_decode_split<1, T, VB, EXACT, Cache, SC, CAP>) {
  return rows <= 2 ? flash_decode_split<2, T, VB, EXACT, Cache, SC, CAP, true,
                                        true>
         : rows <= 4 ? flash_decode_split<4, T, VB, EXACT, Cache, SC, CAP,
                                          true, true>
                     : flash_decode_split<MAX_REP, T, VB, EXACT, Cache, SC,
                                          CAP, true, true>;
}

// split_for, with the int8 score dot when `qk` (int8 K only: the other
// element types have no QK instance), over t tokens per slot when t > 1
// (the contiguous cache only: the pool has no such call).
template <int CAP, class T, int VB, bool EXACT, class Cache, class SC>
auto split_qk(int n_rep, int qk, int t)
    -> decltype(&flash_decode_split<1, T, VB, EXACT, Cache, SC, CAP>) {
  if constexpr (nst::KVElem<T>::kQuantized) {
    if constexpr (!NST_FLASH_PAGED) {
      if (qk && t > 1)
        return split_rows<CAP, T, VB, EXACT, Cache, SC>(t * n_rep);
    }
    if (qk) return split_for<CAP, T, VB, EXACT, Cache, SC, true>(n_rep);
  }
  return split_for<CAP, T, VB, EXACT, Cache, SC>(n_rep);
}

template <class T, int VB, bool EXACT, class SC, class Cache>
cudaError_t launch(Cache cache, const void* q, const void* k_new,
                   const void* v_new, void* kc, void* vc, void* ks, void* vs,
                   const void* slopes, const void* pos, const void* kv_lens,
                   void* part_m, void* part_l, void* part_acc, void* out,
                   int B, int H, int Hkv, int S, int D, int layer, int chunk,
                   int extra, int fused_append, int causal, int out_f32,
                   int qk, int t, float sm_scale, float softcap,
                   cudaStream_t st) {
  const int splits = (S + chunk - 1) / chunk;
  const int n_rep = H / Hkv;
  auto bq = static_cast<const __nv_bfloat16*>(q);
  constexpr int CAP = EXACT ? OFF : RUNTIME;
  decltype(&flash_decode_split<1, T, VB, EXACT, Cache, SC, CAP>) split_kernel;
  if constexpr (EXACT) {
    split_kernel = softcap > 0.f
                       ? split_qk<ON, T, VB, EXACT, Cache, SC>(n_rep, qk, t)
                       : split_qk<OFF, T, VB, EXACT, Cache, SC>(n_rep, qk, t);
  } else {
    split_kernel = split_qk<RUNTIME, T, VB, EXACT, Cache, SC>(n_rep, qk, t);
  }
  // t > 1: the rows' limits are their positions (causal) or kv_len (null);
  // the combine kernel then runs over B * t virtual slots of one token each
  // (no extra column, so it reads pos / kv_lens only for `ok`, and gets the
  // [B, t] positions for both)
  const bool multi = t > 1;
  const int* pos_i = static_cast<const int*>(pos);
  const int* lim = multi ? (causal ? pos_i : nullptr)
                         : static_cast<const int*>(causal ? pos : kv_lens);
  const int vbytes = VStage<T>::kStatic ? 0 : VStage<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, vbytes);
  if (err != cudaSuccess) return err;
  split_kernel<<<dim3(splits, Hkv, B), THREADS, vbytes, st>>>(
      cache, bq, static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const SC*>(ks), static_cast<const SC*>(vs),
      static_cast<const float*>(slopes), pos_i,
      static_cast<const int*>(kv_lens), lim, static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), H, Hkv, S,
      D, layer, chunk, extra, t, sm_scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto combine = [&](auto kernel, auto* o) {
    kernel<<<dim3(Hkv, B * t), THREADS, 0, st>>>(
        cache, bq, static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), static_cast<T*>(kc),
        static_cast<T*>(vc), static_cast<SC*>(ks), static_cast<SC*>(vs),
        pos_i, multi ? pos_i : static_cast<const int*>(kv_lens),
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), o, H, Hkv, D, layer, splits,
        extra, fused_append, sm_scale, softcap);
  };
  using bf16 = __nv_bfloat16;
  if (out_f32) {
    auto o = static_cast<float*>(out);
    if (softcap > 0.f)
      combine(flash_decode_combine<T, Cache, SC, true, float>, o);
    else
      combine(flash_decode_combine<T, Cache, SC, false, float>, o);
  } else {
    auto o = static_cast<bf16*>(out);
    if (softcap > 0.f)
      combine(flash_decode_combine<T, Cache, SC, true, bf16>, o);
    else
      combine(flash_decode_combine<T, Cache, SC, false, bf16>, o);
  }
  return cudaGetLastError();
}

// The int8 kernels of one scale type SC: the exact kernel, or the masked
// one with 16- or 8-byte row loads.
template <class SC, class Cache>
cudaError_t launch_int8(Cache cache, int D, const void* q, const void* k_new,
                        const void* v_new, void* kc, void* vc, void* ks,
                        void* vs, const void* slopes, const void* pos,
                        const void* kv_lens, void* part_m, void* part_l,
                        void* part_acc, void* out, int B, int H, int Hkv,
                        int S, int layer, int chunk, int extra,
                        int fused_append, int causal, int out_f32, int qk,
                        int t, float sm_scale, float softcap,
                        cudaStream_t st) {
#define NST_LAUNCH(VB, EXACT)                                                 \
  launch<int8_t, VB, EXACT, SC>(cache, q, k_new, v_new, kc, vc, ks, vs,       \
                                slopes, pos, kv_lens, part_m, part_l,         \
                                part_acc, out, B, H, Hkv, S, D, layer, chunk, \
                                extra, fused_append, causal, out_f32, qk, t,  \
                                sm_scale, softcap, st)
  if (D == DI) return NST_LAUNCH(16, true);
  if (D % 16 == 0) return NST_LAUNCH(16, false);
  return NST_LAUNCH(8, false);
#undef NST_LAUNCH
}

// kv_type: 0 int8 codes with bf16 scales, 3 int8 codes with float32
// scales, 1 bf16 values, 2 float32 values (no scales, no extra column, no
// append).  D: the head dim, a multiple of 8 at most this instance's
// (below it, the masked kernels); int8 rows of D % 16 == 8 take 8-byte
// loads.  causal: 1 or 0; out_f32: 1 for a float32 output, 0 for bf16;
// qk: 1 for the int8 score dot (int8 only), else 0.  t: tokens per slot,
// 1 but for the int8 dot over the contiguous cache without the extra
// column, where t * (H / Hkv) <= MAX_REP, positions [B, t] and the output
// [B, t, H, D].  softcap: 0 (off) or the logit softcap.
template <class Cache>
int launch_d(Cache cache, int D, const void* q, const void* k_new,
             const void* v_new, void* kc, void* vc, void* ks, void* vs,
             const void* slopes, const void* pos, const void* kv_lens,
             void* part_m, void* part_l, void* part_acc, void* out, int B,
             int H, int Hkv, int S, int layer, int chunk, int extra,
             int fused_append, int kv_type, int causal, int out_f32, int qk,
             int t, float sm_scale, float softcap, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bool int8 = kv_type == 0 || kv_type == 3;
  if (D > DI || D <= 0 || D % 8 || kv_type < 0 || kv_type > 3 ||
      (!int8 && (extra || fused_append || qk)) ||
      (causal != 0 && causal != 1) || (out_f32 != 0 && out_f32 != 1) ||
      (qk != 0 && qk != 1) || !(softcap >= 0.f) || t < 1 ||
      (t > 1 && (!qk || extra || fused_append || NST_FLASH_PAGED ||
                 t * (H / Hkv) > MAX_REP)))
    return (int)cudaErrorInvalidValue;
#define NST_LAUNCH(T, EXACT)                                                  \
  launch<T, 16, EXACT, __nv_bfloat16>(                                        \
      cache, q, k_new, v_new, kc, vc, ks, vs, slopes, pos, kv_lens, part_m,   \
      part_l, part_acc, out, B, H, Hkv, S, D, layer, chunk, extra,            \
      fused_append, causal, out_f32, 0, 1, sm_scale, softcap, st)
#define NST_LAUNCH_INT8(SC)                                                   \
  launch_int8<SC>(cache, D, q, k_new, v_new, kc, vc, ks, vs, slopes, pos,     \
                  kv_lens, part_m, part_l, part_acc, out, B, H, Hkv, S,       \
                  layer, chunk, extra, fused_append, causal, out_f32, qk, t,  \
                  sm_scale, softcap, st)
  const bool exact = D == DI;
  cudaError_t err;
  if (kv_type == 1)
    err = exact ? NST_LAUNCH(__nv_bfloat16, true)
                : NST_LAUNCH(__nv_bfloat16, false);
  else if (kv_type == 2)
    err = exact ? NST_LAUNCH(float, true) : NST_LAUNCH(float, false);
  else if (kv_type == 3)
    err = NST_LAUNCH_INT8(float);
  else
    err = NST_LAUNCH_INT8(__nv_bfloat16);
#undef NST_LAUNCH
#undef NST_LAUNCH_INT8
  return (int)err;
}

}  // namespace

#if !NST_FLASH_PAGED
// slopes: float32 [H] ALiBi slopes, or null for none.  k_new / v_new are
// read only with `extra`; ks / vs only for the int8 cache.  t: tokens per
// slot (launch_d); pos is [B] at t = 1, [B, t] above; the partials hold
// B * t * H rows.
extern "C" int nst_flash_decode(const void* q, const void* k_new,
                                const void* v_new, void* kc, void* vc,
                                void* ks, void* vs, const void* slopes,
                                const void* pos, const void* kv_lens,
                                void* part_m, void* part_l, void* part_acc,
                                void* out, int B, int H, int Hkv, int S, int D,
                                int layer, int chunk, int extra,
                                int fused_append, int kv_type, int causal,
                                int out_f32, int qk, int t, float sm_scale,
                                float softcap, void* stream) {
  return launch_d(nst::ContigCache{B, Hkv, S}, D, q, k_new, v_new, kc, vc, ks,
                  vs, slopes, pos, kv_lens, part_m, part_l, part_acc, out, B,
                  H, Hkv, S, layer, chunk, extra, fused_append, kv_type,
                  causal, out_f32, qk, t, sm_scale, softcap, stream);
}

#else
// The pool [L, Hkv, P, ps, D] with scales [L, Hkv, P, 1, ps] (int8) and
// int32 tables [B, n_blocks]; the logical length is n_blocks * ps.
extern "C" int nst_flash_decode_paged(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    void* ks, void* vs, const void* slopes, const void* tables,
    const void* pos, const void* kv_lens, void* part_m, void* part_l,
    void* part_acc, void* out, int B, int H, int Hkv, int P, int ps,
    int n_blocks, int D, int layer, int chunk, int extra, int fused_append,
    int kv_type, int causal, int out_f32, int qk, float sm_scale,
    float softcap, void* stream) {
  return launch_d(
      nst::PagedCache{static_cast<const int*>(tables), Hkv, P, ps, n_blocks},
      D, q, k_new, v_new, kc, vc, ks, vs, slopes, pos, kv_lens, part_m,
      part_l, part_acc, out, B, H, Hkv, n_blocks * ps, layer, chunk, extra,
      fused_append, kv_type, causal, out_f32, qk, 1, sm_scale, softcap,
      stream);
}
#endif
