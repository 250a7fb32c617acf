// Int4 dequant-matmul for Hopper (sm_90a): out[M, N] = x[M, K] @ W.
//
// Replaces: neural_speed_tpu/ops/matmul.py, _gemm_kernel_int (launched by
// _qmatmul_pallas_2d from qmatmul) for int4, symmetric, bf16 group scales.
//
// W is the JAX package's planar pack: word [kb, n] (uint32, held as int32 by
// the port) carries the 4-bit codes of rows kb + i*K/8, i = 0..7, at bits
// 4i..4i+3.  Value = s[k / g, n] * (code - 8).
//
// Three launch shapes, as in the TPU kernel's compute-dtype rule:
//
//  * GEMV, M <= 8 (decode, and the LM head at prefill).  Bound: bytes.  The
//    int4 words are read once (0.5 byte per weight) and dominate the traffic:
//    ~3.4 GB per Llama-2-7B decode step, ~1.0 ms at 3.35 TB/s.  Body:
//    qmm_int4.cuh's gemv_int4_kernel with MT = 1, 2, 4 or 8 rows, float32
//    math on exact weights, K split across blocks with a second kernel
//    summing the float32 partials in a fixed order.
//  * GEMV, 8 < M <= 32 (speculative verify steps: T = 8 at B = 4 is 32
//    rows).  Bound: bytes, the same words.  qmm_int4.cuh's gemv_mma_kernel
//    reads each word once for all the rows (one launch, then the split-K
//    sum): TF32 tensor-core products of exact operands, float32 sums; the
//    wrapper hands x in band-major order, as to the GEMM.
//  * GEMM, M > 32 (prefill projections).  Bound: operations (2 M N K on the
//    bf16 tensor cores; 369 GFLOP for gate/up at M = 2048).  qmm_fp.cuh's
//    TMA + wgmma template (namespace tc, the kernel of F, P and their
//    grouped instances) with A4 = true: kernel A's format dequantized two
//    weights at a time in bf16x2 (a4_chunk), bit-identical to the float32
//    s * (code - 8) rounded once to bf16, as the JAX package's XLA path does
//    (dequantize(qt, bf16), then a dot with f32 accumulation).  The wrapper
//    hands x in band-major order (k' = r * 8 + band, ops/matmul.py's
//    _band_major), so a K step of 64 is 8 word rows with all their bands.
//
// Host entries return cudaGetLastError() after their launches.

#include "qmm_fp.cuh"
#include "qmm_int4.cuh"

using namespace nst_int4;

// x: in band-major order when M > 8 (the tensor-core body).
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
  cudaError_t err;
  if (M > 8)
    err = launch_gemv_mma(xp, wp, sp, pp, op, M, K, N, g, splits, st);
  else if (M > 4)
    err = launch_gemv<8, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits, 0, 1, st);
  else if (M > 2)
    err = launch_gemv<4, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits, 0, 1, st);
  else if (M == 2)
    err = launch_gemv<2, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits, 0, 1, st);
  else
    err = launch_gemv<1, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits, 0, 1, st);
  if (err == cudaSuccess && splits > 1)
    err = launch_reduce(pp, op, M, N, splits, st);
  return (int)err;
}

// xk: x with K in band-major order.
extern "C" int nst_qmatmul_int4_gemm(const void* xk, const void* words,
                                     const void* scales, void* out, int M,
                                     int K, int N, int g, void* stream) {
  nstfp::PackArgs a{};
  a.plane[0] = static_cast<const uint32_t*>(words);
  a.scales = scales;
  a.scale_bf16 = 1;
  a.zmode = nstfp::Z_SYM;
  return (int)nstfp::launch_gemm<nstfp::FMT_INT4, 2, false, __nv_bfloat16, true>(
      static_cast<const __nv_bfloat16*>(xk), a, nullptr, nullptr,
      static_cast<__nv_bfloat16*>(out), M, K, N, g, static_cast<cudaStream_t>(stream));
}
