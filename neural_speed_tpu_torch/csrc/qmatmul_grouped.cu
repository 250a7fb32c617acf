// Grouped int4 dequant-matmul for Hopper (sm_90a), kernel 11: the MoE
// experts' projections over rows sorted by expert.
//
// Replaces: neural_speed_tpu/ops/moe.py, _grouped_pallas (entry
// grouped_qmatmul), which runs ops/matmul.py's _gemm_kernel_int with the
// expert of each M block scalar-prefetched into the weight and scale block
// maps.  Taken here: int4, symmetric, bf16 group scales (kernel A's format);
// the Pallas kernel's LUT packs, widths 1/2/8 and zero points are still to
// port.
//
// Experts are stacked [E, K/8, N] (words) and [E, K/g, N] (scales); the
// output is float32, as the TPU kernel's.  Bodies: qmm_int4.cuh.
//
//  * GEMM (nst_qmatmul_grouped_gemm): xs [M_pad, K] bf16 in bm-row blocks
//    (bm = 128 or 64, the block of ops/moe.route_tokens), block i times
//    expert block_expert[i] (read on the device per M tile: the M tile is
//    the block, so it lies inside one expert's segment).  Bound: operations
//    of the live rows (2 x rows x N x K on the bf16 tensor cores; 2048
//    tokens x top-2 at Mixtral's gate: 481 GFLOP, 0.49 ms).  Padding rows
//    read the zero row; block_rows[i] counts the rows of block i that hold
//    an assignment (they come first in a segment): the tile's warps past
//    them skip their MMAs, and a tile with none writes zeros and stops.  A decode step of B = 4 has 8 live rows in up
//    to 8 of its 9 blocks, so each live block multiplies one warp's 32
//    rows instead of 128: the call is bound by reading and unpacking the
//    experts' words.
//  * GEMV (nst_qmatmul_grouped_gemv): at most 32 rows, row m times expert
//    row_expert[m] (one block column per row, so each block reads one
//    expert's words).  Bound: bytes of the experts the rows touch (0.5 byte
//    per weight).  The MoE layer's single-token decode puts its top_k rows
//    here: one launch reads both selected experts, and the expert ids never
//    reach the host.  Math in f32 on exact weights, as kernel A's GEMV.
//
// Host entries return cudaGetLastError() after their launches.

#include "qmm_int4.cuh"

using namespace nst_int4;

extern "C" int nst_qmatmul_grouped_gemm(const void* x, const void* words,
                                        const void* scales,
                                        const void* block_expert,
                                        const void* block_rows, void* out,
                                        int M, int K, int N, int g, int bm,
                                        void* stream) {
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const uint32_t*>(words);
  auto sp = static_cast<const __nv_bfloat16*>(scales);
  auto be = static_cast<const int*>(block_expert);
  auto br = static_cast<const int*>(block_rows);
  auto op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return (int)launch_gemm<2, true>(xp, wp, sp, be, br, op, M, K, N, g, st);
  if (bm == 64)
    return (int)launch_gemm<1, true>(xp, wp, sp, be, br, op, M, K, N, g, st);
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
