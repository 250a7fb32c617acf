// Kernel 9 (kernel C over the page pool) at head dim 256, and at the multiples
// of 8 below it down to the next instance's: see flash_prefill.cuh.
#define NST_FLASH_DIM 256
#define NST_FLASH_PAGED 1
#include "flash_prefill.cuh"
