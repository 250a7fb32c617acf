// The decode body of the MQA / odd-KV-head calls (kernel C's function at
// T = 1) and its paged twin at head dim 96: see flash_rows.cuh.
#define NST_FLASH_DIM 96
#include "flash_rows.cuh"
