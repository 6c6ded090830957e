// Stage kernel `vrf_prep`: draft-03 ECVRF decode and hash-to-curve (the
// challenge is the proof's own c, so no challenge derivation and no
// compression of H). Replaces the TPU kernel
// ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_prep_kernel.
#include "stages.cuh"

__global__ void __launch_bounds__(128) vrf_prep_kernel(
    int B, const int32_t *pk, const int32_t *gamma, const int32_t *s,
    const int32_t *alpha, int32_t *ok, int32_t *prep) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) vrf_prep_lane(i, B, pk, gamma, s, alpha, ok, prep);
}

extern "C" int pk_vrf_prep(int B, const void *pk, const void *gamma,
                           const void *s, const void *alpha, void *ok,
                           void *prep, void *stream) {
  vrf_prep_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      B, (const int32_t *)pk, (const int32_t *)gamma, (const int32_t *)s,
      (const int32_t *)alpha, (int32_t *)ok, (int32_t *)prep);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the 128-thread launch above.
extern "C" int pk_vrf_prep_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, vrf_prep_kernel, 128, 0);
}
