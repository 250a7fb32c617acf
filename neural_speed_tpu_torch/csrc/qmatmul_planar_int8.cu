// Kernel P for INT8 byte rows, symmetric, uint8 zero points or float offsets: see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT8
#include "qmatmul_planar.cuh"
