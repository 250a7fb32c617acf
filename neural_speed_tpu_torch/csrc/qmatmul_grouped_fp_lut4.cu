// Grouped instance for NF4 / FP4 stacks (16-entry table): see qmatmul_grouped_fp.cuh.
#define NST_GROUPED_FMT nstfp::FMT_LUT4
#include "qmatmul_grouped_fp.cuh"
