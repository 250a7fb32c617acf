// Decode attention for the calls kernel B does not take: one token per slot
// with more than 8 query heads per KV head or an odd KV head count
// (Falcon-7B's 71 query heads over one KV head at D = 64, Gemma-2B's 8 over
// one at D = 256, 12 over 3), over the int8 cache (bf16 or float32 scales)
// or bf16 / float32 values, after the plain append.  One instance per head
// dim: `flash_rows_d<D>.cu` defines NST_FLASH_DIM and includes this file;
// each holds the contiguous body (nst_flash_rows) and its paged twin
// (nst_flash_rows_paged).
//
// Replaces: neural_speed_tpu/ops/flash.py, _mha_kernel as launched by
// _mha_packed from mha (and _mha_paged from mha_paged) for those calls at
// t = 1, the calls whose JAX launcher rejects the head-blocked body
// (`rp <= 8 and hb > 1`, flash.py:732).  The function is kernel C's
// (flash_prefill.cuh) at T = 1: the same scores, softcap, ALiBi, mask,
// rounding points (bf16 q; P * v_scale rounded to bf16 before the product
// with V; float32 sums) and output types; only the order of the float32
// sums differs, through the split below.
//
// Bound: bytes (each live K/V column read once per KV head: Gemma-2B's
// int8 cache at B = 4 and 2000 columns is ~4 MB).  Kernel C took one query
// head of one slot per block, so at T = 1 a 64-row MMA tile held one real
// row, and the KV head's K/V was read once per query head (8 times for
// Gemma-2B, 71 for Falcon-7B) by B * H blocks walking every column in
// sequence.  Here:
//  * grid (column chunks, KV heads, slots): a block packs all n_rep query
//    heads of its KV head as the rows of its MMA tile (16 per warp: 8 heads
//    take one warp, 71 take five, padded with zero rows), reads each K/V
//    tile of its chunk once, converts it to bf16 in shared memory once
//    (float32 rounded to nearest even, int8 codes exactly), and runs
//    wmma bf16 16x16x16 products (tensor cores, float32 accumulation) for
//    Q K^T and P V over 32-column tiles;
//  * each chunk keeps its own running max, sum and output accumulator (in
//    shared memory, as kernel C's) and writes them as partials; a second
//    kernel (flash_rows_combine, one block per query head and slot) merges
//    a row's chunks as kernel B's combine does and writes bf16 or float32;
//  * the chunk count is the wrapper's (ops/flash.rows_chunking): enough
//    chunks that B * Hkv * chunks covers the 132 SMs at least twice, at
//    least 32 columns each;
//  * n_rep up to 128 query heads per KV head (eight row warps; four at
//    D = 256, where shared memory bounds it); above that the wrapper keeps
//    kernel C.
// Head dims below the instance's take masked kernels (EXACT = false), as
// in kernel C.  Paged: the same template over the pool's addressing
// (common.cuh), every column resolved through the slot's table, the
// arithmetic and its order the contiguous body's, so the two agree bit for
// bit over the gathered layer.

#include <cfloat>
#include <climits>
#include <mma.h>

#include "common.cuh"

#ifndef NST_FLASH_DIM
#error "define NST_FLASH_DIM (the head-dim instance) before including this file"
#endif

using namespace nvcuda;

namespace {

constexpr int DI = NST_FLASH_DIM;
constexpr int BC = 32;                      // cache columns per tile
constexpr int LDP = BC + 8;
constexpr int LDS = BC + 4;
constexpr int LDH = DI + 8;                 // bf16 tiles
constexpr int LDO = DI + 4;                 // the f32 output accumulator
constexpr int MAX_WARPS = DI > 128 ? 4 : 8;  // row warps of 16 query heads
constexpr int MAX_THREADS = 256;
constexpr int COMBINE_THREADS = 128;
constexpr int NF = (DI + COMBINE_THREADS - 1) / COMBINE_THREADS;
static_assert(DI % 16 == 0, "the wmma products take 16 columns at a time");

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory of a block with W row warps.
struct RowsSmem {
  size_t q, k, v, ksc, vsc, p, s, o, bytes;
  __host__ __device__ explicit RowsSmem(int W) {
    q = 0;
    k = q + align128(sizeof(__nv_bfloat16) * 16 * W * LDH);
    v = k + align128(sizeof(__nv_bfloat16) * BC * LDH);
    ksc = v + align128(sizeof(__nv_bfloat16) * BC * LDH);
    vsc = ksc + align128(sizeof(float) * BC);
    p = vsc + align128(sizeof(float) * BC);
    s = p + align128(sizeof(__nv_bfloat16) * W * 16 * LDP);
    o = s + align128(sizeof(float) * W * 16 * LDS);
    bytes = o + align128(sizeof(float) * W * 16 * LDO);
  }
};

template <class KV, int VB, bool EXACT, class Cache, class SC>
__global__ void __launch_bounds__(MAX_THREADS)
flash_rows_kernel(Cache cache, const __nv_bfloat16* __restrict__ q,
                  const KV* __restrict__ kc, const KV* __restrict__ vc,
                  const SC* __restrict__ ks, const SC* __restrict__ vs,
                  const float* __restrict__ slopes, const int* __restrict__ pos,
                  const int* __restrict__ kv_lens, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc, int H,
                  int Hkv, int S, int D, int layer, int chunk, int nch, int causal,
                  float sm_scale, float softcap) {
  if constexpr (EXACT) D = DI;
  using E = nst::KVElem<KV>;
  const int n_rep = H / Hkv;
  const int W = (n_rep + 15) / 16;
  const RowsSmem L(W);
  extern __shared__ __align__(128) unsigned char smem[];
  auto Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  auto Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  auto Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  auto ksc = reinterpret_cast<float*>(smem + L.ksc);
  auto vsc = reinterpret_cast<float*>(smem + L.vsc);

  const int ci = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid / 32, lane = tid % 32;
  const bool mma_warp = warp < W;
  auto Pw = reinterpret_cast<__nv_bfloat16*>(smem + L.p) + warp * 16 * LDP;
  auto Sw = reinterpret_cast<float*>(smem + L.s) + warp * 16 * LDS;
  auto Ow = reinterpret_cast<float*>(smem + L.o) + warp * 16 * LDO;

  // Q rows: query head hk * n_rep + r of slot b (bf16, zero past n_rep / D)
  constexpr int QCH = DI / 8;
  for (int i = tid; i < 16 * W * QCH; i += nthr) {
    const int r = i / QCH, ch = i % QCH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_rep && ch * 8 < D)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * H + hk * n_rep + r) * D + ch * 8);
    *reinterpret_cast<uint4*>(Qs + r * LDH + ch * 8) = val;
  }
  if (mma_warp)
    for (int i = lane; i < 16 * LDO; i += 32) Ow[i] = 0.f;
  __syncwarp();
  const int p = pos[b];
  const int c_end = causal ? min(min(kv_lens[b], p + 1), S) : min(kv_lens[b], S);
  const int c_lo = ci * chunk, c_hi = min(c_end, c_lo + chunk);

  const int r = lane / 2, half = lane % 2;  // this lane's row / column half
  const int row = warp * 16 + r;            // query head hk * n_rep + row
  const float slope =
      slopes != nullptr && mma_warp && row < n_rep ? slopes[hk * n_rep + row] : 0.f;
  const bool alibi = slopes != nullptr;
  float m_run = -FLT_MAX, l_run = 0.f;
  const auto rows = cache.rows(layer, b, hk);

  for (int c0 = c_lo; c0 < c_hi; c0 += BC) {
    __syncthreads();
    constexpr int PER = VB / (int)sizeof(KV);  // elements per load
    constexpr int KCH = DI / PER;
    for (int i = tid; i < BC * KCH; i += nthr) {
      const int c = i / KCH, ch = i % KCH;
      __nv_bfloat16* kd = Ks + c * LDH + ch * PER;
      __nv_bfloat16* vd = Vs + c * LDH + ch * PER;
      if (ch * PER < D && c0 + c < c_hi) {
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
        for (int j = 0; j < PER; ++j) kd[j] = vd[j] = __float2bfloat16_rn(0.f);
      }
    }
    if (E::kQuantized && tid < BC) {
      const bool in = c0 + tid < c_hi;
      const size_t rc = in ? rows(c0 + tid) : 0;
      ksc[tid] = in ? nst::scale_to_float(ks[rc]) : 0.f;
      vsc[tid] = in ? nst::scale_to_float(vs[rc]) : 0.f;
    }
    __syncthreads();
    if (!mma_warp) continue;

    // scores: 16 rows x 32 columns per warp
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BC / 16];
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
    for (int kd = 0; kd < DI / 16; ++kd) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + (warp * 16) * LDH + kd * 16, LDH);
#pragma unroll
      for (int j = 0; j < BC / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + (j * 16) * LDH + kd * 16, LDH);
        wmma::mma_sync(sacc[j], a, kb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BC / 16; ++j)
      wmma::store_matrix_sync(Sw + j * 16, sacc[j], LDS, wmma::mem_row_major);
    __syncwarp();

    // online softmax over the chunk: lanes 2r, 2r+1 share row r
    constexpr int HC = BC / 2;
    float sv[HC];
    float mloc = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const int cc = half * HC + i;
      const int c = c0 + cc;
      const bool valid = c < c_hi;
      float x = E::kQuantized ? Sw[r * LDS + cc] * ksc[cc] * sm_scale
                              : Sw[r * LDS + cc] * sm_scale;
      if (softcap > 0.f) x = nst::softcap_score(x, softcap);
      if (alibi) x = nst::add_alibi(x, slope, c, p);
      sv[i] = valid ? x : -FLT_MAX;
      if (valid) mloc = fmaxf(mloc, x);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float m_new = fmaxf(m_run, mloc);
    const float alpha = expf(m_run - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const int cc = half * HC + i;
      const bool valid = c0 + cc < c_hi;
      const float pv = valid ? expf(sv[i] - m_new) : 0.f;
      lsum += pv;
      Pw[r * LDP + cc] = __float2bfloat16_rn(E::kQuantized ? pv * vsc[cc] : pv);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l_run = alpha * l_run + lsum;
    m_run = m_new;
    __syncwarp();

    // P V: 16 rows x D per warp, two 16-column slabs at a time into Sw,
    // then O = O * alpha + PV for those columns
    constexpr int NJ = DI / 16;
    constexpr int GJ = BC / 16;
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += GJ) {
#pragma unroll
      for (int jj = 0; jj < GJ; ++jj) {
        if (j0 + jj < NJ) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
          wmma::fill_fragment(o, 0.f);
#pragma unroll
          for (int kk = 0; kk < BC / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
                pa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
                vb;
            wmma::load_matrix_sync(pa, Pw + kk * 16, LDP);
            wmma::load_matrix_sync(vb, Vs + (kk * 16) * LDH + (j0 + jj) * 16, LDH);
            wmma::mma_sync(o, pa, vb, o);
          }
          wmma::store_matrix_sync(Sw + jj * 16, o, LDS, wmma::mem_row_major);
        }
      }
      __syncwarp();
      const int w = 16 * min(GJ, NJ - j0);  // columns in this pass
      float* orow = Ow + r * LDO + j0 * 16;
      for (int i = 0; i < w / 2; ++i) {
        const int col = half * (w / 2) + i;
        orow[col] = orow[col] * alpha + Sw[r * LDS + col];
      }
      __syncwarp();
    }
  }

  // the chunk's partials (an empty chunk: max -FLT_MAX, sum 0, zeros)
  if (mma_warp && row < n_rep) {
    const size_t pi = ((size_t)b * H + hk * n_rep + row) * nch + ci;
    if (half == 0) {
      part_m[pi] = m_run;
      part_l[pi] = l_run;
    }
    const float* orow = Ow + r * LDO;
    for (int i = 0; i < DI / 2; ++i) {
      const int col = half * (DI / 2) + i;
      if (col < D) part_acc[pi * D + col] = orow[col];
    }
  }
}

// Merges the nch chunks of each (slot, query head) row and writes the output
// [B, 1, H, D] (OT: bf16 or float32); 0 where no column is valid.  The
// chunks' maxima and weights exp(m_i - m) are reduced across the block and
// kept in shared memory (nch floats), so the accumulator loads of different
// chunks are independent and stay in flight together.
template <class OT>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_rows_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, OT* __restrict__ out, int H,
                   int D, int nch) {
  extern __shared__ float wt[];  // [nch] exp(m_i - m)
  __shared__ float red[COMBINE_THREADS / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t pi = ((size_t)b * H + h) * nch;
  float m = -FLT_MAX;
  for (int i = tid; i < nch; i += COMBINE_THREADS) m = fmaxf(m, part_m[pi + i]);
  m = nst::block_max<COMBINE_THREADS / 32>(m, red);
  float l = 0.f;
  for (int i = tid; i < nch; i += COMBINE_THREADS) {
    const float e = expf(part_m[pi + i] - m);
    wt[i] = e;
    l += part_l[pi + i] * e;
  }
  l = nst::block_sum<COMBINE_THREADS / 32>(l, red);  // its barriers publish wt
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int d = tid + f * COMBINE_THREADS;
    if (d >= D) continue;
    const float* src = part_acc + pi * D + d;
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < nch; ++i) a += src[(size_t)i * D] * wt[i];
    out[((size_t)b * H + h) * D + d] = nst::from_float<OT>(a * inv);
  }
}

template <class KV, int VB, bool EXACT, class SC, class Cache>
cudaError_t launch(Cache cache, const void* q, const void* kc, const void* vc,
                   const void* ks, const void* vs, const void* slopes, const void* pos,
                   const void* kv_lens, void* part_m, void* part_l, void* part_acc,
                   void* out, int B, int H, int Hkv, int S, int D, int layer,
                   int chunk, int nch, int causal, int out_f32, float sm_scale,
                   float softcap, cudaStream_t st) {
  const int W = (H / Hkv + 15) / 16;
  const RowsSmem L(W);
  auto kernel = flash_rows_kernel<KV, VB, EXACT, Cache, SC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(nch, Hkv, B);
  kernel<<<grid, W > 4 ? 32 * W : 128, L.bytes, st>>>(
      cache, static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const SC*>(ks),
      static_cast<const SC*>(vs), static_cast<const float*>(slopes),
      static_cast<const int*>(pos), static_cast<const int*>(kv_lens),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), H, Hkv, S, D, layer, chunk, nch, causal, sm_scale,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 cgrid(H, B);
  const size_t cbytes = sizeof(float) * nch;
  if (out_f32)
    flash_rows_combine<float><<<cgrid, COMBINE_THREADS, cbytes, st>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), static_cast<float*>(out), H, D, nch);
  else
    flash_rows_combine<__nv_bfloat16><<<cgrid, COMBINE_THREADS, cbytes, st>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out), H, D,
        nch);
  return cudaGetLastError();
}

// kv_type: 0 int8 codes with bf16 scales, 3 int8 codes with float32
// scales, 1 bf16 values, 2 float32 values.  D: a multiple of 8 at most this
// instance's; causal, out_f32: 1 or 0; softcap: 0 (off) or the softcap;
// chunk, nch: columns per chunk (a multiple of 32) and chunks, nch * chunk
// >= S; the partials hold B * H * nch rows.
template <class Cache>
int launch_d(Cache cache, int D, const void* q, const void* kc, const void* vc,
             const void* ks, const void* vs, const void* slopes, const void* pos,
             const void* kv_lens, void* part_m, void* part_l, void* part_acc, void* out,
             int B, int H, int Hkv, int S, int layer, int chunk, int nch, int kv_type,
             int causal, int out_f32, float sm_scale, float softcap, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (D > DI || D <= 0 || D % 8 || kv_type < 0 || kv_type > 3 || Hkv <= 0 ||
      H % Hkv || (H / Hkv + 15) / 16 > MAX_WARPS || chunk <= 0 || chunk % BC ||
      nch <= 0 || nch > 12288 || (long long)nch * chunk < S ||
      (causal != 0 && causal != 1) ||
      (out_f32 != 0 && out_f32 != 1) || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
#define NST_LAUNCH(KV, VB, EXACT, SC)                                              \
  launch<KV, VB, EXACT, SC>(cache, q, kc, vc, ks, vs, slopes, pos, kv_lens, part_m, \
                            part_l, part_acc, out, B, H, Hkv, S, D, layer, chunk,   \
                            nch, causal, out_f32, sm_scale, softcap, st)
#define NST_LAUNCH_INT8(SC)                                    \
  (exact ? NST_LAUNCH(int8_t, 16, true, SC)                    \
   : D % 16 == 0 ? NST_LAUNCH(int8_t, 16, false, SC)           \
                 : NST_LAUNCH(int8_t, 8, false, SC))
  using bf16 = __nv_bfloat16;
  const bool exact = D == DI;
  cudaError_t err;
  if (kv_type == 1)
    err = exact ? NST_LAUNCH(bf16, 16, true, bf16) : NST_LAUNCH(bf16, 16, false, bf16);
  else if (kv_type == 2)
    err = exact ? NST_LAUNCH(float, 16, true, bf16) : NST_LAUNCH(float, 16, false, bf16);
  else if (kv_type == 3)
    err = NST_LAUNCH_INT8(float);
  else
    err = NST_LAUNCH_INT8(bf16);
#undef NST_LAUNCH
#undef NST_LAUNCH_INT8
  return (int)err;
}

}  // namespace

// q [B, 1, H, D] bf16; the cache [L, B, Hkv, S, D]; slopes float32 [H] or
// null; ks / vs read only for the int8 cache; out [B, 1, H, D].
extern "C" int nst_flash_rows(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs, const void* slopes,
                              const void* pos, const void* kv_lens, void* part_m,
                              void* part_l, void* part_acc, void* out, int B, int H,
                              int Hkv, int S, int D, int layer, int chunk, int nch,
                              int kv_type, int causal, int out_f32, float sm_scale,
                              float softcap, void* stream) {
  return launch_d(nst::ContigCache{B, Hkv, S}, D, q, kc, vc, ks, vs, slopes, pos,
                  kv_lens, part_m, part_l, part_acc, out, B, H, Hkv, S, layer, chunk,
                  nch, kv_type, causal, out_f32, sm_scale, softcap, stream);
}

// The pool [L, Hkv, P, ps, D] with scales [L, Hkv, P, 1, ps] (int8) and
// int32 tables [B, n_blocks]; the logical length is n_blocks * ps.
extern "C" int nst_flash_rows_paged(const void* q, const void* kc, const void* vc,
                                    const void* ks, const void* vs, const void* slopes,
                                    const void* tables, const void* pos,
                                    const void* kv_lens, void* part_m, void* part_l,
                                    void* part_acc, void* out, int B, int H, int Hkv,
                                    int P, int ps, int n_blocks, int D, int layer,
                                    int chunk, int nch, int kv_type, int causal,
                                    int out_f32, float sm_scale, float softcap,
                                    void* stream) {
  return launch_d(
      nst::PagedCache{static_cast<const int*>(tables), Hkv, P, ps, n_blocks}, D, q, kc,
      vc, ks, vs, slopes, pos, kv_lens, part_m, part_l, part_acc, out, B, H, Hkv,
      n_blocks * ps, layer, chunk, nch, kv_type, causal, out_f32, sm_scale, softcap,
      stream);
}
