// Kernel P for INT5 (4- and 1-bit planes): see qmatmul_planar.cuh.
#define NST_PLANAR_FMT nstfp::FMT_INT5
#include "qmatmul_planar.cuh"
