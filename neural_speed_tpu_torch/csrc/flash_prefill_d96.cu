// Kernel C (the contiguous cache) at head dim 96, and at the multiples of 8
// below it down to the next instance's: see flash_prefill.cuh.
#define NST_FLASH_DIM 96
#define NST_FLASH_PAGED 0
#include "flash_prefill.cuh"
