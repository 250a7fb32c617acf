// Grouped instance for INT1 stacks: see qmatmul_grouped_fp.cuh.
#define NST_GROUPED_FMT nstfp::FMT_INT1
#include "qmatmul_grouped_fp.cuh"
