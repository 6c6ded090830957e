// Stage kernel `vrf_ladders`: U' = s·B − c·Y, V' = s·H − c·Γ, 8Γ.
// Replaces the TPU kernel ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_ladder_kernel.
#include "stages.cuh"

__global__ void __launch_bounds__(128) vrf_ladder_kernel(
    int B, const u32 *base8, const int32_t *c16, const int32_t *s,
    const int32_t *prep, int32_t *pts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) vrf_ladder_lane(i, B, base8, c16, s, prep, pts);
}

extern "C" int pk_vrf_ladders(int B, const void *base8, const void *c16,
                              const void *s, const void *prep, void *pts,
                              void *stream) {
  vrf_ladder_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      B, (const u32 *)base8, (const int32_t *)c16, (const int32_t *)s,
      (const int32_t *)prep, (int32_t *)pts);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the 128-thread launch above.
extern "C" int pk_vrf_ladders_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, vrf_ladder_kernel, 128, 0);
}
