// Kernel P for FP8 e4m3 rows: see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_E4M3
#include "qmatmul_planar.cuh"
