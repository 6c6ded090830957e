// Stage kernel `vrf_prep`: draft-03 ECVRF decode and hash-to-curve (the
// challenge is the proof's own c, so no challenge derivation and no
// compression of H). Replaces the TPU kernel
// ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_prep_kernel.
//
// Bound: operations, and on the main path the dependent chain of one
// lane (half the launches are one block): three field exponentiations
// (~254 dependent squarings each: the two decompressions and Elligator2's
// square root) and one SHA-512 compression, none of which depends on
// another. So one lane runs over three warps (stages.cuh, vrf_bc_prep's
// Y and Γ roles and d3_role_h): the hash and H's exponentiation on one,
// the decompressions of Y and of Γ on the other two, each storing its own
// rows; the flags meet in shared memory at one barrier. The critical path
// falls from three exponentiation chains to one. A block is 32 lanes, 96
// threads.
// Not used: tensor cores (IMMA multiplies int8 pieces into int32; a
// 25.5-bit limb product would take ~16 of them plus carries, where one
// IMAD.WIDE does it) and TMA (a lane's inputs are four 32-byte columns,
// coalesced limb-first; nothing is staged through shared memory).
#include "stages.cuh"

__global__ void __launch_bounds__(3 * PK_GROUP) vrf_prep_kernel(
    int B, const int32_t *pk, const int32_t *gamma, const int32_t *s,
    const int32_t *alpha, int32_t *ok, int32_t *prep) {
  __shared__ BcPrepScratch sc;
  int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  int i = blockIdx.x * PK_GROUP + lane;
  bool live = i < B;
  int ii = live ? i : B - 1;  // lanes past B run along for the barrier
  if (role == 0) d3_role_h(ii, B, live, pk, alpha, prep);
  else if (role == 1) bc_role_y(ii, B, live, lane, pk, prep, sc);
  else bc_role_gamma(ii, B, live, lane, gamma, s, prep, sc);
  __syncthreads();
  if (live && role == 1) bc_ok(i, lane, sc, ok);
}

extern "C" int pk_vrf_prep(int B, const void *pk, const void *gamma,
                           const void *s, const void *alpha, void *ok,
                           void *prep, void *stream) {
  vrf_prep_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 3 * PK_GROUP, 0,
                    (cudaStream_t)stream>>>(
      B, (const int32_t *)pk, (const int32_t *)gamma, (const int32_t *)s,
      (const int32_t *)alpha, (int32_t *)ok, (int32_t *)prep);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_vrf_prep_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vrf_prep_kernel, 3 * PK_GROUP, 0);
}
