// Kernel P for INT1: one 1-bit plane, value s * (2 * code - 1): see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT1
#include "qmatmul_planar.cuh"
