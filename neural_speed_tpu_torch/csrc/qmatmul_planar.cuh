// Kernel P: dequant-matmul over multi-plane and byte packs for Hopper
// (sm_90a): INT 3/5/6/7 as 4/2/1-bit planes, FP8 e4m3 / e5m2 rows, and packs
// with ggml float offsets (w = s * code + m) at any width; its one-plane INT
// instances (INT1, INT2, INT4, INT8 rows) also take the packs of the int
// kernel that kernel A does not: uint8 zero points, float32 or
// double-quantized scales (decoded to float32 by the wrapper), widths 1, 2
// and 8.
//
// Replaces: neural_speed_tpu/ops/matmul.py, _gemm_kernel_planar (launched by
// _qmatmul_planar_2d from qmatmul), and for the one-plane INT packs
// _gemm_kernel_int (launched by _qmatmul_pallas_2d), whose g >= 128 branch
// dots raw codes and corrects by the row sum of x: here each weight is
// s * (code - zero) in float32 as in the plain version, so the two routes
// differ from the JAX kernel only by where float32 rounds.
//
// The TPU body uses linearity (one dot per plane, the offset through the row
// sum of x); here each code is rebuilt from its planes with computed
// addresses, so the value is the plain version's s * (code - zero) exactly.
// Zero-point modes (run-time): none (FP8), the symmetric offset
// 2^(bits-1), uint8 zero points, float offsets.  Bounds and design:
// qmm_fp.cuh (GEMV: bytes, bits / 8 per weight; GEMM: operations).
//
// One translation unit per format (qmatmul_planar_<format>.cu defines
// NST_PLANAR_FMT and includes this file), each built into its own library
// with the same four entry names: in one unit nvcc compiles the ten formats
// one after another, apart they compile side by side.  The `_f32` entries
// take float32 x and write float32 (the JAX kernels' float32-activation
// branch): the GEMV with a float32 load of x, the GEMM 3xTF32 on the tensor
// cores within float32-level error (qmm_fp.cuh's tc::gemm_tf32x3_kernel).
// Host entries return cudaGetLastError()
// after their launches.

#pragma once

#include "qmm_fp.cuh"

#ifndef NST_PLANAR_FMT
#error "define NST_PLANAR_FMT (nstfp::FMT_INT1 ... nstfp::FMT_INT8) before including this file"
#endif

namespace {
nstfp::PackArgs planar_args(const void* p0, const void* p1, const void* p2,
                            const void* scales, const void* zeros, int scale_bf16,
                            int zmode) {
  nstfp::PackArgs a{};
  a.plane[0] = static_cast<const uint32_t*>(p0);
  a.plane[1] = static_cast<const uint32_t*>(p1);
  a.plane[2] = static_cast<const uint32_t*>(p2);
  a.scales = scales;
  a.zeros = zeros;
  a.scale_bf16 = scale_bf16;
  a.zmode = zmode;
  return a;
}
}  // namespace

extern "C" int nst_qmatmul_planar_gemv(const void* x, const void* p0, const void* p1,
                                       const void* p2, const void* scales,
                                       const void* zeros, void* partial, void* out,
                                       int M, int K, int N, int g, int splits,
                                       int scale_bf16, int zmode, void* stream) {
  return (int)nstfp::run_gemv<NST_PLANAR_FMT>(
      static_cast<const __nv_bfloat16*>(x),
      planar_args(p0, p1, p2, scales, zeros, scale_bf16, zmode),
      static_cast<float*>(partial), static_cast<__nv_bfloat16*>(out), M, K, N, g,
      splits, static_cast<cudaStream_t>(stream));
}

extern "C" int nst_qmatmul_planar_gemm(const void* xk, const void* p0, const void* p1,
                                       const void* p2, const void* scales,
                                       const void* zeros, void* out, int M, int K,
                                       int N, int g, int scale_bf16, int zmode,
                                       void* stream) {
  return (int)nstfp::run_gemm<NST_PLANAR_FMT>(
      static_cast<const __nv_bfloat16*>(xk),
      planar_args(p0, p1, p2, scales, zeros, scale_bf16, zmode),
      static_cast<__nv_bfloat16*>(out), M, K, N, g, static_cast<cudaStream_t>(stream));
}

extern "C" int nst_qmatmul_planar_gemv_f32(const void* x, const void* p0, const void* p1,
                                           const void* p2, const void* scales,
                                           const void* zeros, void* partial, void* out,
                                           int M, int K, int N, int g, int splits,
                                           int scale_bf16, int zmode, void* stream) {
  return (int)nstfp::run_gemv<NST_PLANAR_FMT>(
      static_cast<const float*>(x),
      planar_args(p0, p1, p2, scales, zeros, scale_bf16, zmode),
      static_cast<float*>(partial), static_cast<float*>(out), M, K, N, g, splits,
      static_cast<cudaStream_t>(stream));
}

extern "C" int nst_qmatmul_planar_gemm_f32(const void* xk, const void* p0, const void* p1,
                                           const void* p2, const void* scales,
                                           const void* zeros, void* out, int M, int K,
                                           int N, int g, int scale_bf16, int zmode,
                                           void* stream) {
  return (int)nstfp::run_gemm_f32<NST_PLANAR_FMT>(
      static_cast<const float*>(xk),
      planar_args(p0, p1, p2, scales, zeros, scale_bf16, zmode),
      static_cast<float*>(out), M, K, N, g, static_cast<cudaStream_t>(stream));
}
