// Decode attention over the KV cache: the int8 cache with the current
// token's k/v as extra operands and the in-place append of its quantized
// row, or the bf16 cache after a plain append (no extra column).
//
// Replaces: neural_speed_tpu/ops/flash.py, _mha_kernel_hblk, launched by
// _mha_packed_hblk from mha over the contiguous cache (nst_flash_decode) and
// by _mha_paged_hblk from mha_paged over the page pool
// (nst_flash_decode_paged): int8 K/V with extra_kv=True, fused_append=True;
// int8 or bf16 K/V with neither; ALiBi or none; causal.
//
// What it computes, per slot b and KV head hk, for the n_rep query heads of
// that group (one token per slot):
//   * with the extra column, kv_len includes the current token; the cache is
//     read only below kv_len_cache = kv_len - 1 when pos == kv_len - 1 (a
//     live slot), else below kv_len (a spectator whose query is parked at
//     max_len - 1).  Without it the cache is read below kv_len.  Columns
//     also satisfy c <= pos (causal);
//   * scores s = (bf16(q) . k) * k_scale * sm_scale (no k_scale for bf16
//     K), then + slope[h] * (c - pos) with ALiBi; the online softmax is
//     seeded with the UNQUANTIZED current k/v (f32, ALiBi distance 0) when
//     the extra column is on;
//   * P * v_scale (P for bf16 V) is rounded to bf16 before the product with
//     V; out = acc / l, 0 where no column is valid;
//   * with the fused append, live slots get the current k/v quantized
//     (amax / 127 by division, codes rint(x / scale) clipped to +-127,
//     scale stored as bf16) and written at row kv_len - 1; spectators are
//     left untouched.
//
// Bound: bytes.  Each step reads the K and V of every live column once
// (about 0.5 GB per Llama-2-7B step at ctx 2000, B = 1, in int8; twice that
// in bf16).
// Design: flash-decoding.  B * Hkv = 32 blocks cannot fill 132 SMs, so the
// sequence is split into chunks of `chunk` columns across blocks
// (gridDim.x); each block keeps its partial max / sum / accumulator, and a
// second kernel (one block per (b, hk)) merges the partials with the seed
// column, writes the output and performs the append.  The append cannot race
// with the reads: the new row sits at kv_len - 1 >= kv_len_cache, which no
// block reads, and exactly one block writes it.  Within a block, a thread
// scores one column (its K row as 16-byte loads: 16 int8 codes or 8 bf16
// values each) and, after the softmax step, owns one of the D output
// features; the V rows of each 128-column sub-chunk are staged in shared
// memory with coalesced loads (16 KiB in int8, 32 KiB in bf16 at D = 128).
//
// Paged: the kernels are templates over the cache addressing
// (common.cuh): every column's row is resolved through the slot's page
// table, per column, so a 128-column sub-chunk may span pages (8 of them at
// page size 16); the arithmetic and its order are the contiguous kernel's.
// The append writes a live slot's row at table[b, (kv_len - 1) / ps]; a
// spectator writes nothing (the JAX kernel parks it on the trash page).
//
// Compiled without --use_fast_math: the quantization must match
// kv_cache.quantize_kv bit for bit (IEEE division, round half to even).

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int MAX_REP = 8;

// R: a power of two >= n_rep, so the per-row arrays have compile-time
// indices and stay in registers.  T: the cache's element type (KVElem).
template <int D, int R, class T, class Cache>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(Cache cache, const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ ks,
                   const __nv_bfloat16* __restrict__ vs,
                   const float* __restrict__ slopes,
                   const int* __restrict__ pos, const int* __restrict__ kv_lens,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int Hkv, int S,
                   int layer, int chunk, int extra, float sm_scale) {
  using E = nst::KVElem<T>;
  constexpr int PER = E::kPer16;      // elements per 16-byte load
  constexpr int CH = D / PER;         // 16-byte loads per row
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = pos[b], kvl = kv_lens[b];
  const int kvl_cache = kvl - (extra && p == kvl - 1 ? 1 : 0);
  const int c_end = min(min(kvl_cache, p + 1), S);
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, c_end);

  __shared__ float qs[R][D];
  __shared__ float ps[R][THREADS];
  __shared__ __align__(16) T vsm[THREADS * D];  // V rows of a sub-chunk
  __shared__ float red_max[R][NW];
  __shared__ float red_sum[R][NW];

  for (int i = tid; i < n_rep * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r][d] = __bfloat162float(q[((size_t)b * H + hk * n_rep + r) * D + d]);
  }
  float slope[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    slope[r] = slopes != nullptr && r < n_rep ? slopes[hk * n_rep + r] : 0.f;
  __syncthreads();

  const auto rows = cache.rows(layer, b, hk);

  float m_run[R], l_run[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.f;
    acc[r] = 0.f;
  }

  for (int cs = c0; cs < c1; cs += THREADS) {
    const int c = cs + tid;
    const bool valid = c < c1;
    // stage this sub-chunk's V rows with coalesced 16-byte loads; they are
    // in flight while the scores are computed
    const int ncols = min(THREADS, c1 - cs);
    for (int i = tid; i < ncols * CH; i += THREADS)
      reinterpret_cast<int4*>(vsm)[i] = *reinterpret_cast<const int4*>(
          vc + rows(cs + i / CH) * D + (i % CH) * PER);
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    float vsc = 1.f;
    if (valid) {
      const size_t rc = rows(c);
      const T* kr = kc + rc * D;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += PER) {
        const int4 raw = *reinterpret_cast<const int4*>(kr + d0);
        const T* kv8 = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const float kv = E::to_float(kv8[j]);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < n_rep) s[r] = fmaf(qs[r][d0 + j], kv, s[r]);
        }
      }
      if constexpr (E::kQuantized) {
        const float ksc = __bfloat162float(ks[rc]);
        vsc = __bfloat162float(vs[rc]);
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = s[r] * ksc * sm_scale;
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = s[r] * sm_scale;
      }
      if (slopes != nullptr) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = nst::add_alibi(s[r], slope[r], c, p);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rep) continue;
      const float mx = nst::warp_max(valid ? s[r] : -FLT_MAX);
      if (lane == 0) red_max[r][warp] = mx;
    }
    __syncthreads();
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rep) continue;
      float bmax = -FLT_MAX;
#pragma unroll
      for (int w = 0; w < NW; ++w) bmax = fmaxf(bmax, red_max[r][w]);
      const float m_new = fmaxf(m_run[r], bmax);
      alpha[r] = expf(m_run[r] - m_new);
      const float pr = valid ? expf(s[r] - m_new) : 0.f;
      ps[r][tid] = E::kQuantized ? nst::round_bf16(pr * vsc)
                                 : nst::round_bf16(pr);
      const float sm = nst::warp_sum(pr);
      if (lane == 0) red_sum[r][warp] = sm;
      m_run[r] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rep) continue;
      float bsum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) bsum += red_sum[r][w];
      l_run[r] = alpha[r] * l_run[r] + bsum;
      if (tid < D) {
        float a = 0.f;
        for (int j = 0; j < ncols; ++j)
          a = fmaf(ps[r][j], E::to_float(vsm[j * D + tid]), a);
        acc[r] = acc[r] * alpha[r] + a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n_rep) continue;
    const size_t pi = ((size_t)b * H + hk * n_rep + r) * splits + split;
    if (tid == 0) {
      part_m[pi] = m_run[r];
      part_l[pi] = l_run[r];
    }
    if (tid < D) part_acc[pi * D + tid] = acc[r];
  }
}

// Merges the splits' partials (with the seed column when `extra`), writes
// the output and, with `fused_append` (int8 only), the new row.
template <int D, class T, class Cache>
__global__ void __launch_bounds__(THREADS)
flash_decode_combine(Cache cache, const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new,
                     T* __restrict__ kc, T* __restrict__ vc,
                     __nv_bfloat16* __restrict__ ks,
                     __nv_bfloat16* __restrict__ vs,
                     const int* __restrict__ pos,
                     const int* __restrict__ kv_lens,
                     const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     __nv_bfloat16* __restrict__ out, int H, int Hkv,
                     int layer, int splits, int extra, int fused_append,
                     float sm_scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / Hkv;
  const int tid = threadIdx.x;
  const int p = pos[b], kvl = kv_lens[b];
  const bool ok = p == kvl - 1;
  const bool valid0 = extra && ok && p >= 0;
  __shared__ float sh[NW];

  const size_t nidx = ((size_t)b * Hkv + hk) * D;
  const float kn = extra && tid < D ? __bfloat162float(k_new[nidx + tid]) : 0.f;
  const float vn = extra && tid < D ? __bfloat162float(v_new[nidx + tid]) : 0.f;

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    float s0 = 0.f;
    if (extra) {
      const float qv =
          tid < D ? __bfloat162float(q[((size_t)b * H + h) * D + tid]) : 0.f;
      s0 = nst::block_sum<NW>(qv * kn, sh) * sm_scale;
    }
    const size_t pi = ((size_t)b * H + h) * splits;
    float m = valid0 ? s0 : -FLT_MAX;
    for (int i = 0; i < splits; ++i) m = fmaxf(m, part_m[pi + i]);
    const float e0 = valid0 ? expf(s0 - m) : 0.f;
    float l = e0;
    float a = e0 * vn;
    for (int i = 0; i < splits; ++i) {
      const float e = expf(part_m[pi + i] - m);
      l += part_l[pi + i] * e;
      if (tid < D) a += part_acc[(pi + i) * D + tid] * e;
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    if (tid < D) out[((size_t)b * H + h) * D + tid] = __float2bfloat16_rn(a * inv);
  }

  if constexpr (nst::KVElem<T>::kQuantized) {
    if (!(extra && fused_append && ok)) return;
    const size_t at = cache.rows(layer, b, hk)(max(kvl - 1, 0));
    const float kamax = nst::block_max<NW>(fabsf(kn), sh);
    const float vamax = nst::block_max<NW>(fabsf(vn), sh);
    const float ksc = fmaxf(kamax, 1e-8f) / 127.0f;
    const float vsc = fmaxf(vamax, 1e-8f) / 127.0f;
    if (tid < D) {
      kc[at * D + tid] = (int8_t)fminf(fmaxf(rintf(kn / ksc), -127.f), 127.f);
      vc[at * D + tid] = (int8_t)fminf(fmaxf(rintf(vn / vsc), -127.f), 127.f);
    }
    if (tid == 0) {
      ks[at] = __float2bfloat16_rn(ksc);
      vs[at] = __float2bfloat16_rn(vsc);
    }
  }
}

template <int D, class T, class Cache>
cudaError_t launch(Cache cache, const void* q, const void* k_new,
                   const void* v_new, void* kc, void* vc, void* ks, void* vs,
                   const void* slopes, const void* pos, const void* kv_lens,
                   void* part_m, void* part_l, void* part_acc, void* out,
                   int B, int H, int Hkv, int S, int layer, int chunk,
                   int extra, int fused_append, float sm_scale,
                   cudaStream_t st) {
  const int splits = (S + chunk - 1) / chunk;
  const int n_rep = H / Hkv;
  auto bq = static_cast<const __nv_bfloat16*>(q);
  auto split_kernel = n_rep <= 1   ? flash_decode_split<D, 1, T, Cache>
                      : n_rep <= 2 ? flash_decode_split<D, 2, T, Cache>
                      : n_rep <= 4 ? flash_decode_split<D, 4, T, Cache>
                                   : flash_decode_split<D, MAX_REP, T, Cache>;
  split_kernel<<<dim3(splits, Hkv, B), THREADS, 0, st>>>(
      cache, bq, static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const float*>(slopes),
      static_cast<const int*>(pos), static_cast<const int*>(kv_lens),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), H, Hkv, S, layer, chunk, extra, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<D, T, Cache><<<dim3(Hkv, B), THREADS, 0, st>>>(
      cache, bq, static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<T*>(kc),
      static_cast<T*>(vc), static_cast<__nv_bfloat16*>(ks),
      static_cast<__nv_bfloat16*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(kv_lens), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<const float*>(part_acc),
      static_cast<__nv_bfloat16*>(out), H, Hkv, layer, splits, extra,
      fused_append, sm_scale);
  return cudaGetLastError();
}

template <class T, class Cache>
cudaError_t launch_t(Cache cache, int D, const void* q, const void* k_new,
                     const void* v_new, void* kc, void* vc, void* ks,
                     void* vs, const void* slopes, const void* pos,
                     const void* kv_lens, void* part_m, void* part_l,
                     void* part_acc, void* out, int B, int H, int Hkv, int S,
                     int layer, int chunk, int extra, int fused_append,
                     float sm_scale, cudaStream_t st) {
  if (D == 128)
    return launch<128, T>(cache, q, k_new, v_new, kc, vc, ks, vs, slopes, pos,
                          kv_lens, part_m, part_l, part_acc, out, B, H, Hkv,
                          S, layer, chunk, extra, fused_append, sm_scale, st);
  if (D == 64)
    return launch<64, T>(cache, q, k_new, v_new, kc, vc, ks, vs, slopes, pos,
                         kv_lens, part_m, part_l, part_acc, out, B, H, Hkv, S,
                         layer, chunk, extra, fused_append, sm_scale, st);
  return cudaErrorInvalidValue;
}

// kv_bf16: the cache holds bf16 rows (no scales, no extra column, no
// append) instead of int8 codes.
template <class Cache>
int launch_d(Cache cache, int D, const void* q, const void* k_new,
             const void* v_new, void* kc, void* vc, void* ks, void* vs,
             const void* slopes, const void* pos, const void* kv_lens,
             void* part_m, void* part_l, void* part_acc, void* out, int B,
             int H, int Hkv, int S, int layer, int chunk, int extra,
             int fused_append, int kv_bf16, float sm_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_bf16 && (extra || fused_append)) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      kv_bf16 ? launch_t<__nv_bfloat16>(cache, D, q, k_new, v_new, kc, vc, ks,
                                        vs, slopes, pos, kv_lens, part_m,
                                        part_l, part_acc, out, B, H, Hkv, S,
                                        layer, chunk, 0, 0, sm_scale, st)
              : launch_t<int8_t>(cache, D, q, k_new, v_new, kc, vc, ks, vs,
                                 slopes, pos, kv_lens, part_m, part_l,
                                 part_acc, out, B, H, Hkv, S, layer, chunk,
                                 extra, fused_append, sm_scale, st);
  return (int)err;
}

}  // namespace

// slopes: float32 [H] ALiBi slopes, or null for none.  k_new / v_new are
// read only with `extra`; ks / vs only for the int8 cache.
extern "C" int nst_flash_decode(const void* q, const void* k_new,
                                const void* v_new, void* kc, void* vc,
                                void* ks, void* vs, const void* slopes,
                                const void* pos, const void* kv_lens,
                                void* part_m, void* part_l, void* part_acc,
                                void* out, int B, int H, int Hkv, int S, int D,
                                int layer, int chunk, int extra,
                                int fused_append, int kv_bf16, float sm_scale,
                                void* stream) {
  return launch_d(nst::ContigCache{B, Hkv, S}, D, q, k_new, v_new, kc, vc, ks,
                  vs, slopes, pos, kv_lens, part_m, part_l, part_acc, out, B,
                  H, Hkv, S, layer, chunk, extra, fused_append, kv_bf16,
                  sm_scale, stream);
}

// The pool [L, Hkv, P, ps, D] with scales [L, Hkv, P, 1, ps] (int8) and
// int32 tables [B, n_blocks]; the logical length is n_blocks * ps.
extern "C" int nst_flash_decode_paged(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    void* ks, void* vs, const void* slopes, const void* tables,
    const void* pos, const void* kv_lens, void* part_m, void* part_l,
    void* part_acc, void* out, int B, int H, int Hkv, int P, int ps,
    int n_blocks, int D, int layer, int chunk, int extra, int fused_append,
    int kv_bf16, float sm_scale, void* stream) {
  return launch_d(
      nst::PagedCache{static_cast<const int*>(tables), Hkv, P, ps, n_blocks},
      D, q, k_new, v_new, kc, vc, ks, vs, slopes, pos, kv_lens, part_m,
      part_l, part_acc, out, B, H, Hkv, n_blocks * ps, layer, chunk, extra,
      fused_append, kv_bf16, sm_scale, stream);
}
