// Kernel P for INT4 with float offsets (one 4-bit plane): see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT4
#include "qmatmul_planar.cuh"
