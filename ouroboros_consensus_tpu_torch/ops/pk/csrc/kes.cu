// Stage kernel `kes`: CompactSum KES leaf verify-point + Merkle walk.
// Replaces the TPU kernel ouroboros_consensus_tpu/ops/pk/kernels.py:_kes_kernel.
#include "stages.cuh"

__global__ void __launch_bounds__(128) kes_kernel(
    int B, int depth, const u32 *base8, const int32_t *vk,
    const int32_t *period, const int32_t *s, const int32_t *leaf,
    const int32_t *sib, const int32_t *hb, int nb, const int32_t *hnb,
    int32_t *ok, int32_t *pt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B)
    kes_lane(i, B, depth, base8, vk, period, s, leaf, sib, hb, nb, hnb, ok, pt);
}

extern "C" int pk_kes(int B, int depth, const void *base8, const void *vk,
                      const void *period, const void *s, const void *leaf,
                      const void *sib, const void *hb, int nb,
                      const void *hnb, void *ok, void *pt, void *stream) {
  kes_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      B, depth, (const u32 *)base8, (const int32_t *)vk,
      (const int32_t *)period, (const int32_t *)s, (const int32_t *)leaf,
      (const int32_t *)sib, (const int32_t *)hb, nb, (const int32_t *)hnb,
      (int32_t *)ok, (int32_t *)pt);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the 128-thread launch above.
extern "C" int pk_kes_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kes_kernel, 128, 0);
}
