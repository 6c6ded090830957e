// Stage kernel `vrf_bc_prep`: batch-compatible ECVRF decode, hash-to-curve
// and derived challenge. Replaces the TPU kernel
// ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_bc_prep_kernel.
#include "stages.cuh"

__global__ void __launch_bounds__(128) vrf_bc_prep_kernel(
    int B, const int32_t *pk, const int32_t *gamma, const int32_t *u,
    const int32_t *v, const int32_t *s, const int32_t *alpha, int32_t *ok,
    int32_t *c16, int32_t *prep) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) vrf_bc_prep_lane(i, B, pk, gamma, u, v, s, alpha, ok, c16, prep);
}

extern "C" int pk_vrf_bc_prep(int B, const void *pk, const void *gamma,
                           const void *u, const void *v, const void *s,
                           const void *alpha, void *ok, void *c16,
                           void *prep, void *stream) {
  vrf_bc_prep_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      B, (const int32_t *)pk, (const int32_t *)gamma, (const int32_t *)u,
      (const int32_t *)v, (const int32_t *)s, (const int32_t *)alpha,
      (int32_t *)ok, (int32_t *)c16, (int32_t *)prep);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the 128-thread launch above.
extern "C" int pk_vrf_bc_prep_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, vrf_bc_prep_kernel, 128, 0);
}
