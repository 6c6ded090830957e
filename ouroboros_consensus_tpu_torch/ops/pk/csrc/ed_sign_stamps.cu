// Instrument `ed_sign_stamps`, on no path: forge.cu's signer built with
// clock64 stamps (ES_STAMPS) at the end of each phase of a signable (r's
// hash, its reduction, R = r·B, R's compression, h's hash, the scalar
// tail), so chip_smoke.py (`ed_sign_stamps`) reads the signer's dependent
// path phase by phase. The shipped kernel (forge.cu alone) has no stamps.
#define ES_STAMPS
#include "forge.cu"
