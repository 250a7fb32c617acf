// Grouped instance for INT8 byte-row stacks: see qmatmul_grouped_fp.cuh.
#define NST_GROUPED_FMT nstfp::FMT_INT8
#include "qmatmul_grouped_fp.cuh"
