// Stage kernel `ed`: OCert Ed25519 verify-point, one lane per thread.
// Replaces the TPU kernel ouroboros_consensus_tpu/ops/pk/kernels.py:_ed_kernel.
#include "stages.cuh"

__global__ void __launch_bounds__(128) ed_kernel(
    int B, const u32 *base8, const int32_t *pk, const int32_t *s,
    const int32_t *hb, int nb, const int32_t *hnb, int32_t *ok, int32_t *pt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) ed_lane(i, B, base8, pk, s, hb, nb, hnb, ok, pt);
}

extern "C" int pk_ed(int B, const void *base8, const void *pk, const void *s,
                     const void *hb, int nb, const void *hnb, void *ok,
                     void *pt, void *stream) {
  ed_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      B, (const u32 *)base8, (const int32_t *)pk, (const int32_t *)s,
      (const int32_t *)hb, nb, (const int32_t *)hnb, (int32_t *)ok,
      (int32_t *)pt);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the 128-thread launch above.
extern "C" int pk_ed_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ed_kernel, 128, 0);
}
