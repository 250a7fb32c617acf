// Kernel H: int8-compute matmul over multi-plane INT packs (widths 2, 3, 5,
// 6, 7 as 4/2/1-bit planes) for Hopper (sm_90a).
//
// Replaces: neural_speed_tpu/ops/matmul.py, _int8_kernel_planar (launched by
// _qmatmul_int8_planar from qmatmul_int8).
//
// One int8 tensor-core dot per plane over its raw codes, shifted by the
// plane's position; the zero-point (or symmetric offset) term
// xsum[m, chunk] * zp[group, n] is subtracted once per K step of the most
// significant plane in int32, with xsum the row sum of the quantized
// activations over the step's K (the GEMV takes it from its fragments); then the float32 rescale by
// ascale * wscale, the output written once in bf16 or float32 (times the
// per-token scale where there is one).  Bounds and design: qmm_int8.cuh.
// The GEMM's tensor maps are encoded per call in run_gemm, as qmm_fp.cuh's
// tc host code does.
//
// Host entries return cudaGetLastError() after their launches; a width the
// kernel does not take returns cudaErrorInvalidValue.

#include "qmm_int8.cuh"

using namespace nsti8;

extern "C" int nst_qmatmul_int8_planar_gemv(
    const void* xq, const void* ascale, const void* rscale, const void* xsum,
    const void* p0, const void* p1, const void* p2, const void* scales,
    const void* zeros, void* out, int M, int K, int N, int g, int bits, int ldx,
    int cr0, int cr1, int cr2, int scale_bf16, int out_bf16, int splits,
    void* stream) {
  const I8Args a = make_args(xq, ascale, rscale, xsum, p0, p1, p2, scales, zeros, out, M,
                             K, N, g, ldx, cr0, cr1, cr2, scale_bf16, out_bf16, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return (int)run_gemv<2>(a, st);
    case 3: return (int)run_gemv<3>(a, st);
    case 5: return (int)run_gemv<5>(a, st);
    case 6: return (int)run_gemv<6>(a, st);
    case 7: return (int)run_gemv<7>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nst_qmatmul_int8_planar_gemm(
    const void* xq, const void* ascale, const void* rscale, const void* xsum,
    const void* p0, const void* p1, const void* p2, const void* scales,
    const void* zeros, void* out, int M, int K, int N, int g, int bits, int ldx,
    int cr0, int cr1, int cr2, int scale_bf16, int out_bf16, int splits,
    void* stream) {
  const I8Args a = make_args(xq, ascale, rscale, xsum, p0, p1, p2, scales, zeros, out, M,
                             K, N, g, ldx, cr0, cr1, cr2, scale_bf16, out_bf16, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return (int)run_gemm<2>(a, st);
    case 3: return (int)run_gemm<3>(a, st);
    case 5: return (int)run_gemm<5>(a, st);
    case 6: return (int)run_gemm<6>(a, st);
    case 7: return (int)run_gemm<7>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
