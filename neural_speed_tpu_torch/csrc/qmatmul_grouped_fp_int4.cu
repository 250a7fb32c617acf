// Grouped instance for INT4 stacks (uint8 zero points or float32 scales): see qmatmul_grouped_fp.cuh.
#define NST_GROUPED_FMT nstfp::FMT_INT4
#include "qmatmul_grouped_fp.cuh"
