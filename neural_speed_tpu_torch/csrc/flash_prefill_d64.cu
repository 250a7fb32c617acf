// Kernel C and its paged twin (kernel 9) at head dim 64, and at the
// multiples of 8 below it down to the next instance's: see flash_prefill.cuh.
#define NST_FLASH_DIM 64
#include "flash_prefill.cuh"
