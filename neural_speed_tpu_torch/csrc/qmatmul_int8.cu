// Kernel G: int8-compute matmul over one-plane INT packs (widths 4 and 8)
// for Hopper (sm_90a).
//
// Replaces: neural_speed_tpu/ops/matmul.py, _int8_kernel (launched by
// _qmatmul_int8_pallas from qmatmul_int8).
//
// int8 activations (quantized per token and K group, or per token) x int
// weights with the zero point folded in (code - zp fits int8 for width 4 and
// for 8-bit symmetric), int32 accumulation per K group on the int8 tensor
// cores (wgmma s8 in the GEMM, mma.sync s8 in the GEMV), float32 rescale
// by ascale * wscale, the output written once in bf16 or float32 (times the
// per-token scale where there is one).  Bounds and design: qmm_int8.cuh
// (GEMM: operations at the int8 peak; GEMV: bytes).  The GEMM's tensor
// maps are encoded per call in run_gemm, as qmm_fp.cuh's tc host code does.
//
// Host entries return cudaGetLastError() after their launches; a width the
// kernel does not take returns cudaErrorInvalidValue.

#include "qmm_int8.cuh"

using namespace nsti8;

extern "C" int nst_qmatmul_int8_gemv(
    const void* xq, const void* ascale, const void* rscale, const void* xsum,
    const void* p0, const void* p1, const void* p2, const void* scales,
    const void* zeros, void* out, int M, int K, int N, int g, int bits, int ldx,
    int cr0, int cr1, int cr2, int scale_bf16, int out_bf16, int splits,
    void* stream) {
  const I8Args a = make_args(xq, ascale, rscale, xsum, p0, p1, p2, scales, zeros, out, M,
                             K, N, g, ldx, cr0, cr1, cr2, scale_bf16, out_bf16, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: return (int)run_gemv<4>(a, st);
    case 8: return (int)run_gemv<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nst_qmatmul_int8_gemm(
    const void* xq, const void* ascale, const void* rscale, const void* xsum,
    const void* p0, const void* p1, const void* p2, const void* scales,
    const void* zeros, void* out, int M, int K, int N, int g, int bits, int ldx,
    int cr0, int cr1, int cr2, int scale_bf16, int out_bf16, int splits,
    void* stream) {
  const I8Args a = make_args(xq, ascale, rscale, xsum, p0, p1, p2, scales, zeros, out, M,
                             K, N, g, ldx, cr0, cr1, cr2, scale_bf16, out_bf16, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: return (int)run_gemm<4>(a, st);
    case 8: return (int)run_gemm<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
