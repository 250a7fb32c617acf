// Kernel P for INT7 (4-, 2- and 1-bit planes): see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT7
#include "qmatmul_planar.cuh"
