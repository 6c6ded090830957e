// Instrument `ed_verify_stamps`, on no path: ed_verify.cu's kernel built
// with clock64 stamps (EDV_STAMPS), lane 0 of each warp after each of its
// steps, and the first version's tail (P's compression on warp 0) timed
// after the verdict, so chip_smoke.py (`ed_verify_stamps`) reads a block's
// dependent path role by role. The shipped kernel (ed_verify.cu alone)
// has no stamps.
#define EDV_STAMPS
#include "ed_verify.cu"
