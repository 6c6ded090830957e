// Instrument `dedupe_stamps`, on no path: dedupe.cu's kernel built with
// clock64 stamps (DD_STAMPS), thread 0 of each block after each phase's
// barrier (agg.cuh: dd_block), so chip_smoke.py (`dedupe_stamps`) reads
// where a launch's time goes. The shipped kernel (dedupe.cu alone) has no
// stamps.
#define DD_STAMPS
#include "dedupe.cu"
