// Kernel P for INT6 (4- and 2-bit planes): see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT6
#include "qmatmul_planar.cuh"
