// Kernel F: NF4 / FP4 dequant-matmul for Hopper (sm_90a), out = x @ W with
// W = table[code] * s.
//
// Replaces: neural_speed_tpu/ops/matmul.py, _gemm_kernel_lut (launched by
// _qmatmul_pallas_2d from qmatmul).
//
// One 4-bit plane in the planar pack; the 16 table values are a kernel
// argument (a converter may carry a foreign table), staged in shared memory:
// 16 floats lie in 16 banks, so a lookup by random codes has no conflict.
// Bounds and design: qmm_fp.cuh (GEMV: bytes; GEMM: operations).  The value
// is table[code] * s in float32, rounded once to bf16 at M > 32 with bf16 x;
// the `_f32` entries take float32 x and write float32: the GEMV in float32,
// the GEMM 3xTF32 on the tensor cores (qmm_fp.cuh's tc::gemm_tf32x3_kernel),
// within float32-level error.
//
// Host entries return cudaGetLastError() after their launches.

#include "qmm_fp.cuh"

using namespace nstfp;

namespace {
PackArgs lut_args(const void* plane, const void* scales, const void* table,
                  int scale_bf16) {
  PackArgs a{};
  a.plane[0] = static_cast<const uint32_t*>(plane);
  a.scales = scales;
  a.table = static_cast<const float*>(table);
  a.scale_bf16 = scale_bf16;
  a.zmode = Z_NONE;
  return a;
}
}  // namespace

extern "C" int nst_qmatmul_lut_gemv(const void* x, const void* plane,
                                    const void* scales, const void* table,
                                    void* partial, void* out, int M, int K, int N,
                                    int g, int splits, int scale_bf16, void* stream) {
  return (int)run_gemv<FMT_LUT4>(
      static_cast<const __nv_bfloat16*>(x), lut_args(plane, scales, table, scale_bf16),
      static_cast<float*>(partial), static_cast<__nv_bfloat16*>(out), M, K, N, g,
      splits, static_cast<cudaStream_t>(stream));
}

extern "C" int nst_qmatmul_lut_gemm(const void* xk, const void* plane,
                                    const void* scales, const void* table, void* out,
                                    int M, int K, int N, int g, int scale_bf16,
                                    void* stream) {
  return (int)run_gemm<FMT_LUT4>(
      static_cast<const __nv_bfloat16*>(xk), lut_args(plane, scales, table, scale_bf16),
      static_cast<__nv_bfloat16*>(out), M, K, N, g, static_cast<cudaStream_t>(stream));
}

extern "C" int nst_qmatmul_lut_gemv_f32(const void* x, const void* plane,
                                        const void* scales, const void* table,
                                        void* partial, void* out, int M, int K, int N,
                                        int g, int splits, int scale_bf16,
                                        void* stream) {
  return (int)run_gemv<FMT_LUT4>(
      static_cast<const float*>(x), lut_args(plane, scales, table, scale_bf16),
      static_cast<float*>(partial), static_cast<float*>(out), M, K, N, g, splits,
      static_cast<cudaStream_t>(stream));
}

extern "C" int nst_qmatmul_lut_gemm_f32(const void* xk, const void* plane,
                                        const void* scales, const void* table,
                                        void* out, int M, int K, int N, int g,
                                        int scale_bf16, void* stream) {
  return (int)run_gemm_f32<FMT_LUT4>(
      static_cast<const float*>(xk), lut_args(plane, scales, table, scale_bf16),
      static_cast<float*>(out), M, K, N, g, static_cast<cudaStream_t>(stream));
}
