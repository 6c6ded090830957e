// Instrument `agg_stamps`, on no path: agg_prep.cu's kernel built with
// clock64 stamps (AGG_STAMPS), lane 0 of each warp after each of its
// steps, so chip_smoke.py (`agg_stamps`) reads where a block's time goes
// role by role. The shipped kernel (agg_prep.cu alone) has no stamps.
#define AGG_STAMPS
#include "agg_prep.cu"
