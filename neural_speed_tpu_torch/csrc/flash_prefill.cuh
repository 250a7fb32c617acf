// Prefill flash attention over the KV cache (int8 codes, or bf16 or float32
// values).  One instance per head dim: `flash_prefill_d<D>.cu` defines
// NST_FLASH_DIM and includes this file.
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
// first, so this reads the K/V of the prompt itself.  Decode calls that
// kernel B does not take (Falcon-7B's 71 query heads over one KV head,
// Gemma-2B's 8 over one, an odd KV head count) go to the rows body
// (flash_rows.cuh), which packs a KV head's query heads as its tile rows;
// here a decode call would hold one real row per 64-row tile.
//
// Bound: operations (4 * T^2/2 * D per head with causal skipping, ~34 GFLOP
// per Llama-2-7B layer at T = 2048, on the bf16 tensor cores).
// Design: the natural [B, T, H, D] layout (no GQA row packing: a block
// takes 64 rows of one query head, and the K/V tile of its KV head).  Four
// warps, 16 rows each, run nvcuda::wmma bf16 16x16x16 products with f32
// accumulation for Q K^T and P V.  Each 64-column K/V tile is converted to
// bf16 in shared memory once per block: int8 codes exactly, float32 values
// rounded to nearest even (`__float2bfloat16_rn`, the JAX kernels'
// `astype(bfloat16)`); bf16 tiles are copied as they are.  Column tiles
// past kv_len or (causal) above the tile's last position are skipped.  The
// causal flag and the output type are runtime arguments (no template
// instances: the build), read outside the column loop: each row's column
// limit is its position, or INT_MAX when non-causal, so the loop's test is
// the same instructions either way.  The running
// max / sum live in registers (two lanes per row), the output accumulator
// O in shared memory.  The P V product goes through a per-warp 16 x 64 f32
// tile S (the scores' tile, free once P is written) four 16-column slabs at
// a time, each slab then folded as O = O * alpha + PV, so no D-wide f32
// scratch tile is kept beside O.  Shared memory per block (Smem::bytes):
// 72,464 B at D = 64, 82,704 at 80, 92,944 at 96, 113,424 at 128 (two
// blocks per SM) and 195,344 at 256 (one), within the 232,448 a block may
// use; a D-wide scratch tile would have taken D = 256 to 244,496.
// Head dims below the instance's (a multiple of 8 without an instance of
// its own, as 72 through the 80 instance) take the instance's masked
// kernels (EXACT = false): a runtime D <= NST_FLASH_DIM, Q's and K/V's
// columns past D zeroed in shared memory and only the first D output
// columns stored.  The instance's own head dim takes kernels in which D is
// the compile-time NST_FLASH_DIM (EXACT), as kernel B does.  No TMA/wgmma
// pipeline yet.
// Paged: the kernel is a template over the cache addressing (common.cuh);
// each column of a tile is resolved through the slot's page table (a
// 64-column tile spans 4 pages at page size 16), and the arithmetic and its
// order are the contiguous kernel's.

#include <climits>
#include <mma.h>

#include "common.cuh"

#ifndef NST_FLASH_DIM
#error "define NST_FLASH_DIM (the head-dim instance) before including this file"
#endif

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;
constexpr int NWARP = THREADS / 32;
constexpr int BT = 64;  // query rows per block
constexpr int BC = 64;  // cache columns per tile
constexpr int LDP = BC + 8;
constexpr int LDS = BC + 4;
constexpr int DI = NST_FLASH_DIM;  // the instance's head dim

struct Smem {
  static constexpr int LDH = DI + 8;  // bf16 tiles
  static constexpr int LDO = DI + 4;  // the f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BT * LDH;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BC * LDH;
  static constexpr size_t ksc_off = v_off + sizeof(__nv_bfloat16) * BC * LDH;
  static constexpr size_t vsc_off = ksc_off + sizeof(float) * BC;
  static constexpr size_t pos_off = vsc_off + sizeof(float) * BC;
  static constexpr size_t p_off = pos_off + sizeof(int) * BT;
  static constexpr size_t s_off = p_off + sizeof(__nv_bfloat16) * NWARP * 16 * LDP;
  static constexpr size_t o_off = s_off + sizeof(float) * NWARP * 16 * LDS;
  static constexpr size_t red_off = o_off + sizeof(float) * NWARP * 16 * LDO;
  static constexpr size_t bytes = red_off + sizeof(float) * NWARP;
};
static_assert(Smem::bytes <= 232448, "shared memory of the instance");
static_assert(DI % 16 == 0, "the wmma products take 16 columns at a time");

// SC: the int8 cache's scale type (bf16 or float32).
template <class KV, int VB, bool EXACT, class Cache, class SC>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(Cache cache, const __nv_bfloat16* __restrict__ q,
                     const KV* __restrict__ kc,
                     const KV* __restrict__ vc,
                     const SC* __restrict__ ks, const SC* __restrict__ vs,
                     const float* __restrict__ slopes,
                     const int* __restrict__ pos,
                     const int* __restrict__ kv_lens,
                     void* __restrict__ out, int T, int H,
                     int Hkv, int S, int D, int layer, int causal,
                     int out_f32, float sm_scale, float softcap) {
  if constexpr (EXACT) D = DI;
  using L = Smem;
  using E = nst::KVElem<KV>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  auto Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  auto Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  auto ksc = reinterpret_cast<float*>(smem + L::ksc_off);
  auto vsc = reinterpret_cast<float*>(smem + L::vsc_off);
  auto posS = reinterpret_cast<int*>(smem + L::pos_off);
  auto red = reinterpret_cast<float*>(smem + L::red_off);

  const int t0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const bool alibi = slopes != nullptr;
  const float slope = alibi ? slopes[h] : 0.f;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto Pw = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off) + warp * 16 * LDP;
  auto Sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * LDS;
  auto Ow = reinterpret_cast<float*>(smem + L::o_off) + warp * 16 * L::LDO;

  // Q tile (bf16, 16-byte chunks; zero past D) and row positions
  constexpr int QCH = DI / 8;
  for (int i = tid; i < BT * QCH; i += THREADS) {
    const int r = i / QCH, ch = i % QCH;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t0 + r < T && ch * 8 < D)
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * T + t0 + r) * H + h) * D + ch * 8);
    *reinterpret_cast<uint4*>(Qs + r * L::LDH + ch * 8) = v;
  }
  int my_pos = -1;
  if (tid < BT) {
    my_pos = t0 + tid < T ? pos[(size_t)b * T + t0 + tid] : -1;
    posS[tid] = my_pos;
  }
  for (int i = lane; i < 16 * L::LDO; i += 32) Ow[i] = 0.f;
  const int pmax = (int)nst::block_max<NWARP>((float)my_pos, red);
  const int c_end =
      causal ? min(min(kv_lens[b], pmax + 1), S) : min(kv_lens[b], S);

  const int r = lane / 2, half = lane % 2;  // this lane's row / column half
  const int row_pos = posS[warp * 16 + r];
  const int row_lim = causal ? row_pos : INT_MAX;  // the row's last column
  float m_run = -FLT_MAX, l_run = 0.f;
  const auto rows = cache.rows(layer, b, hk);

  for (int c0 = 0; c0 < c_end; c0 += BC) {
    __syncthreads();
    constexpr int PER = VB / (int)sizeof(KV);   // elements per load
    constexpr int KCH = DI / PER;
    for (int i = tid; i < BC * KCH; i += THREADS) {
      const int c = i / KCH, ch = i % KCH;
      __nv_bfloat16* kd = Ks + c * L::LDH + ch * PER;
      __nv_bfloat16* vd = Vs + c * L::LDH + ch * PER;
      if (ch * PER < D) {
        const size_t src = rows(c0 + c) * D + ch * PER;
        const nst::RowChunk<KV, VB> k8(kc + src), v8(vc + src);
        if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
          *reinterpret_cast<int4*>(kd) = k8.raw;
          *reinterpret_cast<int4*>(vd) = v8.raw;
        } else {
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            kd[j] = E::to_bf16(k8[j]);
            vd[j] = E::to_bf16(v8[j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j)
          kd[j] = vd[j] = __float2bfloat16_rn(0.f);
      }
    }
    if (E::kQuantized && tid < BC) {
      const size_t rc = rows(c0 + tid);
      ksc[tid] = nst::scale_to_float(ks[rc]);
      vsc[tid] = nst::scale_to_float(vs[rc]);
    }
    __syncthreads();

    // scores: 16 rows x 64 columns per warp
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BC / 16];
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
    for (int kd = 0; kd < DI / 16; ++kd) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + (warp * 16) * L::LDH + kd * 16, L::LDH);
#pragma unroll
      for (int j = 0; j < BC / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + (j * 16) * L::LDH + kd * 16, L::LDH);
        wmma::mma_sync(sacc[j], a, kb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BC / 16; ++j)
      wmma::store_matrix_sync(Sw + j * 16, sacc[j], LDS, wmma::mem_row_major);
    __syncwarp();

    // online softmax: lanes 2r, 2r+1 share row r, 32 columns each
    float sv[32];
    float mloc = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int cc = half * 32 + i;
      const int c = c0 + cc;
      const bool valid = c < c_end && c <= row_lim;
      float x = E::kQuantized ? Sw[r * LDS + cc] * ksc[cc] * sm_scale
                              : Sw[r * LDS + cc] * sm_scale;
      if (softcap > 0.f) x = nst::softcap_score(x, softcap);
      if (alibi) x = nst::add_alibi(x, slope, c, row_pos);
      sv[i] = valid ? x : -FLT_MAX;
      if (valid) mloc = fmaxf(mloc, x);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float m_new = fmaxf(m_run, mloc);
    const float alpha = expf(m_run - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int cc = half * 32 + i;
      const int c = c0 + cc;
      const bool valid = c < c_end && c <= row_lim;
      const float p = valid ? expf(sv[i] - m_new) : 0.f;
      lsum += p;
      Pw[r * LDP + cc] = __float2bfloat16_rn(E::kQuantized ? p * vsc[cc] : p);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l_run = alpha * l_run + lsum;
    m_run = m_new;
    __syncwarp();

    // P V: 16 rows x D per warp, four 16-column slabs at a time into Sw,
    // then O = O * alpha + PV for those columns
    constexpr int NJ = DI / 16;
    constexpr int GJ = BC / 16;   // slabs per pass through Sw
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += GJ) {
#pragma unroll
      for (int jj = 0; jj < GJ; ++jj) {
        if (j0 + jj < NJ) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
          wmma::fill_fragment(o, 0.f);
#pragma unroll
          for (int kk = 0; kk < BC / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> pa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> vb;
            wmma::load_matrix_sync(pa, Pw + kk * 16, LDP);
            wmma::load_matrix_sync(
                vb, Vs + (kk * 16) * L::LDH + (j0 + jj) * 16, L::LDH);
            wmma::mma_sync(o, pa, vb, o);
          }
          wmma::store_matrix_sync(Sw + jj * 16, o, LDS, wmma::mem_row_major);
        }
      }
      __syncwarp();
      const int w = 16 * min(GJ, NJ - j0);      // columns in this pass
      float* orow = Ow + r * L::LDO + j0 * 16;
      for (int i = 0; i < w / 2; ++i) {
        const int col = half * (w / 2) + i;
        orow[col] = orow[col] * alpha + Sw[r * LDS + col];
      }
      __syncwarp();
    }
  }

  const int t = t0 + warp * 16 + r;
  if (t < T) {
    const float inv = l_run == 0.f ? 0.f : 1.f / l_run;
    const size_t o = (((size_t)b * T + t) * H + h) * D;
    const float* orow = Ow + r * L::LDO;
    if (out_f32) {
      float* dst = static_cast<float*>(out) + o;
      for (int i = 0; i < DI / 2; ++i) {
        const int col = half * (DI / 2) + i;
        if (col < D) dst[col] = orow[col] * inv;
      }
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
      for (int i = 0; i < DI / 2; ++i) {
        const int col = half * (DI / 2) + i;
        if (col < D) dst[col] = __float2bfloat16_rn(orow[col] * inv);
      }
    }
  }
}

template <class KV, int VB, bool EXACT, class SC, class Cache>
cudaError_t launch(Cache cache, const void* q, const void* kc, const void* vc,
                   const void* ks, const void* vs, const void* slopes,
                   const void* pos, const void* kv_lens, void* out, int B,
                   int T_, int H, int Hkv, int S, int D, int layer,
                   int causal, int out_f32, float sm_scale, float softcap,
                   cudaStream_t st) {
  const size_t bytes = Smem::bytes;
  auto kernel = flash_prefill_kernel<KV, VB, EXACT, Cache, SC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + BT - 1) / BT, H, B);
  kernel<<<grid, THREADS, bytes, st>>>(
      cache, static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const SC*>(ks),
      static_cast<const SC*>(vs), static_cast<const float*>(slopes),
      static_cast<const int*>(pos), static_cast<const int*>(kv_lens), out,
      T_, H, Hkv, S, D, layer, causal, out_f32, sm_scale, softcap);
  return cudaGetLastError();
}

// kv_type: 0 int8 codes with bf16 scales, 3 int8 codes with float32
// scales, 1 bf16 values, 2 float32 values (no scales).  D: the head dim, a
// multiple of 8 at most this instance's (below it, the masked kernels);
// int8 rows of D % 16 == 8 take 8-byte loads.  causal: 1 or 0; out_f32: 1
// for a float32 output, 0 for bf16.  softcap: 0 (off) or the logit
// softcap.
template <class Cache>
int launch_d(Cache cache, int D, const void* q, const void* kc,
             const void* vc, const void* ks, const void* vs,
             const void* slopes, const void* pos, const void* kv_lens,
             void* out, int B, int T_, int H, int Hkv, int S, int layer,
             int kv_type, int causal, int out_f32, float sm_scale,
             float softcap, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (D > DI || D <= 0 || D % 8 || kv_type < 0 || kv_type > 3 ||
      (causal != 0 && causal != 1) || (out_f32 != 0 && out_f32 != 1) ||
      !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
#define NST_LAUNCH(KV, VB, EXACT, SC)                                     \
  launch<KV, VB, EXACT, SC>(cache, q, kc, vc, ks, vs, slopes, pos, kv_lens, \
                            out, B, T_, H, Hkv, S, D, layer, causal,        \
                            out_f32, sm_scale, softcap, st)
#define NST_LAUNCH_INT8(SC)                                               \
  (exact ? NST_LAUNCH(int8_t, 16, true, SC)                               \
   : D % 16 == 0 ? NST_LAUNCH(int8_t, 16, false, SC)                      \
                 : NST_LAUNCH(int8_t, 8, false, SC))
  using bf16 = __nv_bfloat16;
  const bool exact = D == DI;
  cudaError_t err;
  if (kv_type == 1)
    err = exact ? NST_LAUNCH(bf16, 16, true, bf16)
                : NST_LAUNCH(bf16, 16, false, bf16);
  else if (kv_type == 2)
    err = exact ? NST_LAUNCH(float, 16, true, bf16)
                : NST_LAUNCH(float, 16, false, bf16);
  else if (kv_type == 3)
    err = NST_LAUNCH_INT8(float);
  else
    err = NST_LAUNCH_INT8(bf16);
#undef NST_LAUNCH
#undef NST_LAUNCH_INT8
  return (int)err;
}

}  // namespace

// slopes: float32 [H] ALiBi slopes, or null for none; ks / vs are read
// only for the int8 cache.
extern "C" int nst_flash_prefill(const void* q, const void* kc, const void* vc,
                                 const void* ks, const void* vs,
                                 const void* slopes, const void* pos,
                                 const void* kv_lens, void* out, int B, int T,
                                 int H, int Hkv, int S, int D, int layer,
                                 int kv_type, int causal, int out_f32,
                                 float sm_scale, float softcap, void* stream) {
  return launch_d(nst::ContigCache{B, Hkv, S}, D, q, kc, vc, ks, vs, slopes,
                  pos, kv_lens, out, B, T, H, Hkv, S, layer, kv_type, causal,
                  out_f32, sm_scale, softcap, stream);
}

// The pool [L, Hkv, P, ps, D] with scales [L, Hkv, P, 1, ps] (int8) and
// int32 tables [B, n_blocks]; the logical length is n_blocks * ps.
extern "C" int nst_flash_prefill_paged(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* slopes, const void* tables, const void* pos,
    const void* kv_lens, void* out, int B, int T, int H, int Hkv, int P,
    int ps, int n_blocks, int D, int layer, int kv_type, int causal,
    int out_f32, float sm_scale, float softcap, void* stream) {
  return launch_d(
      nst::PagedCache{static_cast<const int*>(tables), Hkv, P, ps, n_blocks},
      D, q, kc, vc, ks, vs, slopes, pos, kv_lens, out, B, T, H, Hkv,
      n_blocks * ps, layer, kv_type, causal, out_f32, sm_scale, softcap,
      stream);
}
