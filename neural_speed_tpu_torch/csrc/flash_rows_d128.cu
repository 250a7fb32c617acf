// The decode body of the MQA / odd-KV-head calls (kernel C's function at
// T = 1) and its paged twin at head dim 128: see flash_rows.cuh.
#define NST_FLASH_DIM 128
#include "flash_rows.cuh"
