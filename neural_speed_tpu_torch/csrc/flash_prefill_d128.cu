// Kernel C and its paged twin (kernel 9) at head dim 128, and at the
// multiples of 8 below it down to the next instance's: see flash_prefill.cuh.
#define NST_FLASH_DIM 128
#include "flash_prefill.cuh"
