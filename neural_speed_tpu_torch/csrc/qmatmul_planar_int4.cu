// Kernel P for INT4 (one 4-bit plane) with float offsets, uint8 zero points,
// or float32 / double-quantized scales: see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT4
#include "qmatmul_planar.cuh"
