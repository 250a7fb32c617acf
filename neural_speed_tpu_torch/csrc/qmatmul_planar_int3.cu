// Kernel P for INT3 (2- and 1-bit planes): see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT3
#include "qmatmul_planar.cuh"
