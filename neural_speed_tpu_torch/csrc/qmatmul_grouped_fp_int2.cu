// Grouped instance for INT2 stacks: see qmatmul_grouped_fp.cuh.
#define NST_GROUPED_FMT nstfp::FMT_INT2
#include "qmatmul_grouped_fp.cuh"
