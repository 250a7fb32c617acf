// Kernel P for FP8 e5m2 rows: see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_E5M2
#include "qmatmul_planar.cuh"
