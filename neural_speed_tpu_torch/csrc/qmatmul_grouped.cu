// Grouped int4 dequant-matmul for Hopper (sm_90a), kernel 11: the MoE
// experts' projections over rows sorted by expert.
//
// Replaces: neural_speed_tpu/ops/moe.py, _grouped_pallas (entry
// grouped_qmatmul), which runs ops/matmul.py's _gemm_kernel_int with the
// expert of each M block scalar-prefetched into the weight and scale block
// maps.  Taken here: int4, symmetric, bf16 group scales (kernel A's format);
// the Pallas kernel's LUT packs, widths 1/2/8 and zero points go to the
// grouped F/P instances (qmatmul_grouped_fp.cuh).
//
// Experts are stacked [E, K/8, N] (words) and [E, K/g, N] (scales); the
// output is float32, as the TPU kernel's.
//
//  * GEMM (nst_qmatmul_grouped_gemm): xk [M_pad, K] bf16, K in band-major
//    order (the wrapper's _band_major), in bm-row blocks (bm = 128 or 64,
//    the block of ops/moe.route_tokens), block i times expert
//    block_expert[i] (read on the device per M tile: the M tile is the
//    block, so it lies inside one expert's segment).  Bound: operations of
//    the live rows (2 x rows x N x K on the bf16 tensor cores; 2048 tokens
//    x top-2 at Mixtral's gate: 481 GFLOP, 0.49 ms).  Body: qmm_fp.cuh's
//    TMA + wgmma template with GROUPED = true and A4 = true (kernel A's
//    bf16x2 dequantization); rows of block i past its block_rows[i] live
//    ones are written as zeros, and a block with none writes zeros and
//    stops.  On the card the MoE layer routes at bm = 128 whatever K
//    (ops/moe.choose_bm): m64n128 tiles per consumer warpgroup, where bm =
//    64 runs m64n64 ones and dequantizes each W tile for half the rows.
//  * GEMV (nst_qmatmul_grouped_gemv): at most 32 rows, row m times expert
//    row_expert[m] (one block row per row, so each block reads one
//    expert's words; qmm_int4.cuh's gemv_int4_kernel with MT = 1).  Bound:
//    bytes of the experts the rows touch (0.5 byte per weight).  The MoE
//    layer's single-token decode puts its top_k rows here: one launch reads
//    both selected experts, and the expert ids never reach the host.  Math
//    in f32 on exact weights, as kernel A's GEMV.
//
// Host entries return cudaGetLastError() after their launches.

#include "qmm_fp.cuh"
#include "qmm_int4.cuh"

using namespace nst_int4;

extern "C" int nst_qmatmul_grouped_gemm(const void* xk, const void* words,
                                        const void* scales,
                                        const void* block_expert,
                                        const void* block_rows, void* out,
                                        int M, int K, int N, int g, int bm,
                                        void* stream) {
  nstfp::PackArgs a{};
  a.plane[0] = static_cast<const uint32_t*>(words);
  a.scales = scales;
  a.scale_bf16 = 1;
  a.zmode = nstfp::Z_SYM;
  auto xp = static_cast<const __nv_bfloat16*>(xk);
  auto be = static_cast<const int*>(block_expert);
  auto br = static_cast<const int*>(block_rows);
  auto op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return (int)nstfp::launch_gemm<nstfp::FMT_INT4, 2, true, float, true>(
        xp, a, be, br, op, M, K, N, g, st);
  if (bm == 64)
    return (int)nstfp::launch_gemm<nstfp::FMT_INT4, 1, true, float, true>(
        xp, a, be, br, op, M, K, N, g, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nst_qmatmul_grouped_gemv(const void* x, const void* words,
                                        const void* scales,
                                        const void* row_expert, void* partial,
                                        void* out, int M, int K, int N, int g,
                                        int splits, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<float*>(partial);
  auto op = static_cast<float*>(out);
  cudaError_t err = launch_gemv<1, true>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(words),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const int*>(row_expert), pp, op, M, K, N, g, splits, 0, M,
      st);
  if (err == cudaSuccess && splits > 1)
    err = launch_reduce(pp, op, M, N, splits, st);
  return (int)err;
}
