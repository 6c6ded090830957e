// Instrument `forge_stamps`, on no path: forge.cu's sweep built with
// clock64 stamps (FS_STAMPS), lane 0 of each warp after each of its
// steps, so chip_smoke.py (`forge_stamps`) reads a block's dependent path
// role by role. The shipped kernel (forge.cu alone) has no stamps.
#define FS_STAMPS
#include "forge.cu"
