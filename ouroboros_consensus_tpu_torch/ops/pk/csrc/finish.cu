// Stage kernel `finish`: shared-inversion compression of 7 points, the
// R-byte / challenge / beta compares, Blake2b range extensions and the
// bracketed leader compare. Replaces the TPU kernel
// ouroboros_consensus_tpu/ops/pk/kernels.py:_finish_kernel.
#include "stages.cuh"

__global__ void __launch_bounds__(128) finish_kernel(
    int B, const int32_t *edok, const int32_t *edpt, const int32_t *edr,
    const int32_t *kesok, const int32_t *kespt, const int32_t *kesr,
    const int32_t *vrfok, const int32_t *vrfpts, const int32_t *c,
    const int32_t *beta, const int32_t *tlo, const int32_t *thi,
    int32_t *out, int32_t *eta, int32_t *lv) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B)
    finish_lane(i, B, edok, edpt, edr, kesok, kespt, kesr, vrfok, vrfpts, c,
                beta, tlo, thi, out, eta, lv);
}

extern "C" int pk_finish(int B, const void *edok, const void *edpt,
                         const void *edr, const void *kesok,
                         const void *kespt, const void *kesr,
                         const void *vrfok, const void *vrfpts,
                         const void *c, const void *beta, const void *tlo,
                         const void *thi, void *out, void *eta, void *lv,
                         void *stream) {
  finish_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      B, (const int32_t *)edok, (const int32_t *)edpt, (const int32_t *)edr,
      (const int32_t *)kesok, (const int32_t *)kespt, (const int32_t *)kesr,
      (const int32_t *)vrfok, (const int32_t *)vrfpts, (const int32_t *)c,
      (const int32_t *)beta, (const int32_t *)tlo, (const int32_t *)thi,
      (int32_t *)out, (int32_t *)eta, (int32_t *)lv);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the 128-thread launch above.
extern "C" int pk_finish_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, finish_kernel, 128, 0);
}
