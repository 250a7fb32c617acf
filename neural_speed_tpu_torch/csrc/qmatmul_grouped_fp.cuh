// Grouped dequant-matmul for Hopper (sm_90a) over the expert stacks kernel
// 11 does not take: NF4 / FP4 through the 16-entry table, and one-plane INT
// 1/2/4/8 with the symmetric offset or uint8 zero points, bf16 or float32
// scales.  The MoE experts' projections over rows sorted by expert.
//
// Replaces: neural_speed_tpu/ops/moe.py, _grouped_pallas (entry
// grouped_qmatmul), which runs ops/matmul.py's _gemm_kernel_int and
// _gemm_kernel_lut with the expert of each M block scalar-prefetched into
// the weight, scale and zero-point block maps.  (Its launcher rounds the
// scales to the compute dtype first; here the stored scale is used, as in
// the JAX package's XLA path _grouped_xla.)
//
// Experts are stacked on a leading axis: planes [E, K * w / 32, N] (uint32
// words held as int32) or [E, K, N] bytes for INT8, scales and zeros
// [E, K / g, N]; the output is float32, as the TPU kernel's.  The bodies are
// kernels F's and P's (qmm_fp.cuh) with GROUPED = true:
//
//  * GEMM (nst_qmatmul_grouped_fp_gemm): xk [M_pad, K] bf16, K reordered
//    band-major by the wrapper, in bm-row blocks (bm = 128 or 64, the block
//    of ops/moe.route_tokens); block i times expert block_expert[i], only its
//    block_rows[i] live rows loaded, a block with none written as zeros.
//    Bound: operations of the live rows (2 x rows x N x K on the bf16 tensor
//    cores); each weight is s * (code - zero) (or table[code] * s) in
//    float32, rounded once to bf16 before the product, as the plain version.
//  * GEMV (nst_qmatmul_grouped_fp_gemv): at most 32 rows, row m times expert
//    row_expert[m] (read on the device; one block row per row).  Bound:
//    bytes of the experts the rows touch.  Math in float32 on exact weights.
//
// One translation unit per format (qmatmul_grouped_fp_<format>.cu defines
// NST_GROUPED_FMT and includes this file), each its own library with the
// same two entry names.  Host entries return cudaGetLastError() after their
// launches.

#pragma once

#include "qmm_fp.cuh"

#ifndef NST_GROUPED_FMT
#error "define NST_GROUPED_FMT (nstfp::FMT_LUT4, FMT_INT1, FMT_INT2, FMT_INT4 or FMT_INT8) before including this file"
#endif

static_assert(nstfp::Fmt<NST_GROUPED_FMT>::kSlots == 1,
              "the grouped instances take one-plane and byte formats");

namespace {
nstfp::PackArgs grouped_args(const void* plane, const void* scales, const void* zeros,
                             const void* table, int scale_bf16, int zmode) {
  nstfp::PackArgs a{};
  a.plane[0] = static_cast<const uint32_t*>(plane);
  a.scales = scales;
  a.zeros = zeros;
  a.table = static_cast<const float*>(table);
  a.scale_bf16 = scale_bf16;
  a.zmode = zmode;
  return a;
}
}  // namespace

extern "C" int nst_qmatmul_grouped_fp_gemm(const void* xk, const void* plane,
                                           const void* scales, const void* zeros,
                                           const void* table, const void* block_expert,
                                           const void* block_rows, void* out, int M,
                                           int K, int N, int g, int bm, int scale_bf16,
                                           int zmode, void* stream) {
  return (int)nstfp::run_gemm_grouped<NST_GROUPED_FMT>(
      static_cast<const __nv_bfloat16*>(xk),
      grouped_args(plane, scales, zeros, table, scale_bf16, zmode),
      static_cast<const int*>(block_expert), static_cast<const int*>(block_rows),
      static_cast<float*>(out), M, K, N, g, bm, static_cast<cudaStream_t>(stream));
}

extern "C" int nst_qmatmul_grouped_fp_gemv(const void* x, const void* plane,
                                           const void* scales, const void* zeros,
                                           const void* table, const void* row_expert,
                                           void* partial, void* out, int M, int K, int N,
                                           int g, int splits, int scale_bf16, int zmode,
                                           void* stream) {
  return (int)nstfp::run_gemv_grouped<NST_GROUPED_FMT>(
      static_cast<const __nv_bfloat16*>(x),
      grouped_args(plane, scales, zeros, table, scale_bf16, zmode),
      static_cast<const int*>(row_expert), static_cast<float*>(partial),
      static_cast<float*>(out), M, K, N, g, splits, static_cast<cudaStream_t>(stream));
}
