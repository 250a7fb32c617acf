// Kernel P for INT2: one 2-bit plane, symmetric, uint8 zero points or float offsets: see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT2
#include "qmatmul_planar.cuh"
