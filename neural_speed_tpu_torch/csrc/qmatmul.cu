// Int4 dequant-matmul for Hopper (sm_90a): out[M, N] = x[M, K] @ W.
//
// Replaces: neural_speed_tpu/ops/matmul.py, _gemm_kernel_int (launched by
// _qmatmul_pallas_2d from qmatmul) for int4, symmetric, bf16 group scales.
//
// W is the JAX package's planar pack: word [kb, n] (uint32, held as int32 by
// the port) carries the 4-bit codes of rows kb + i*K/8, i = 0..7, at bits
// 4i..4i+3.  Value = s[k / g, n] * (code - 8).
//
// Two launch shapes, as in the TPU kernel's compute-dtype rule (the bodies
// live in qmm_int4.cuh, shared with kernel 11):
//
//  * GEMV, M <= 32 (decode, and the LM head at prefill).  Bound: bytes.  The
//    int4 words are read once (0.5 byte per weight) and dominate the traffic:
//    ~3.4 GB per Llama-2-7B decode step, ~1.0 ms at 3.35 TB/s.  Design: each
//    thread owns four columns and reads each word row as one 16-byte load,
//    coalesced along N; it loads 8 word rows before any arithmetic (enough
//    bytes in flight to cover the memory latency), unpacks the 8 codes of
//    each word in registers and multiplies them with x rows staged in shared
//    memory (f32, the slice of K this block covers).  The math is f32:
//    s * (code - 8) is exact there.  At N = 4096 there are only 8 column
//    blocks for 132 SMs, so K is split across blocks (gridDim.y) and a second
//    small kernel sums the f32 partials in a fixed order (deterministic, no
//    atomics).
//
//  * GEMM, M > 32 (prefill projections).  Bound: operations (2 M N K on the
//    bf16 tensor cores; 369 GFLOP for gate/up at M = 2048).  Design: 128x128
//    output tiles, 8 warps of nvcuda::wmma bf16 16x16x16 with f32
//    accumulation.  Each K step takes 8 word rows: the 8 bands of those rows
//    are 64 values of K, so every word is read from memory once per M tile
//    and unpacked into a bf16 tile in shared memory.  Two shared-memory
//    stages: the next step's operands are loaded into registers while the
//    current step's MMAs run, then unpacked into the other stage (one
//    barrier per K step).
//    The dequantized value is rounded to bf16 before the product, as the JAX
//    package's XLA path does (dequantize(qt, bf16) then a dot with f32
//    accumulation).  No TMA/wgmma yet: that is later work.
//
// Host entries return cudaGetLastError() after their launches.

#include "qmm_int4.cuh"

using namespace nst_int4;

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
  cudaError_t err = cudaSuccess;
  for (int m0 = 0; m0 < M && err == cudaSuccess; m0 += 8) {
    const int rows = M - m0;
    if (rows >= 8 || M > 8)
      err = launch_gemv<8, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits,
                           m0, 1, st);
    else if (rows > 2)
      err = launch_gemv<4, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits,
                           m0, 1, st);
    else if (rows == 2)
      err = launch_gemv<2, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits,
                           m0, 1, st);
    else
      err = launch_gemv<1, false>(xp, wp, sp, nullptr, pp, op, M, K, N, g, splits,
                           m0, 1, st);
  }
  if (err == cudaSuccess && splits > 1)
    err = launch_reduce(pp, op, M, N, splits, st);
  return (int)err;
}

extern "C" int nst_qmatmul_int4_gemm(const void* x, const void* words,
                                     const void* scales, void* out, int M,
                                     int K, int N, int g, void* stream) {
  return (int)launch_gemm<2, false>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(words),
      static_cast<const __nv_bfloat16*>(scales), nullptr, nullptr,
      static_cast<__nv_bfloat16*>(out), M, K, N, g,
      static_cast<cudaStream_t>(stream));
}
