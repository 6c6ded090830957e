// Stage kernel `vrf_bc_prep`: batch-compatible ECVRF decode, hash-to-curve
// and derived challenge. Replaces the TPU kernel
// ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_bc_prep_kernel.
//
// Bound: operations, and on the main path the dependent chain of one
// lane (half the launches are one block): four field exponentiations
// (~254 dependent squarings each), of which only two depend on each other
// (H's compression inverts H's Z). So one lane runs over three warps
// (stages.cuh, bc_role_*): H, its compression and the challenge hash on
// one, the decompressions of Y and of Γ on the other two, each storing its
// own rows; the flags meet in shared memory at one barrier. The critical
// path falls from four exponentiation chains to two. A block is 32 lanes,
// 96 threads.
// Not used: tensor cores (IMMA multiplies int8 pieces into int32; a
// 25.5-bit limb product would take ~16 of them plus carries, where one
// IMAD.WIDE does it) and TMA (a lane's inputs are six 32-byte columns,
// coalesced limb-first; nothing is staged through shared memory).
#include "stages.cuh"

__global__ void __launch_bounds__(3 * PK_GROUP) vrf_bc_prep_kernel(
    int B, const int32_t *pk, const int32_t *gamma, const int32_t *u,
    const int32_t *v, const int32_t *s, const int32_t *alpha, int32_t *ok,
    int32_t *c16, int32_t *prep) {
  __shared__ BcPrepScratch sc;
  int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  int i = blockIdx.x * PK_GROUP + lane;
  bool live = i < B;
  int ii = live ? i : B - 1;  // lanes past B run along for the barrier
  if (role == 0) bc_role_h(ii, B, live, pk, gamma, u, v, alpha, c16, prep);
  else if (role == 1) bc_role_y(ii, B, live, lane, pk, prep, sc);
  else bc_role_gamma(ii, B, live, lane, gamma, s, prep, sc);
  __syncthreads();
  if (live && role == 1) bc_ok(i, lane, sc, ok);
}

extern "C" int pk_vrf_bc_prep(int B, const void *pk, const void *gamma,
                              const void *u, const void *v, const void *s,
                              const void *alpha, void *ok, void *c16,
                              void *prep, void *stream) {
  vrf_bc_prep_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 3 * PK_GROUP, 0,
                       (cudaStream_t)stream>>>(
      B, (const int32_t *)pk, (const int32_t *)gamma, (const int32_t *)u,
      (const int32_t *)v, (const int32_t *)s, (const int32_t *)alpha,
      (int32_t *)ok, (int32_t *)c16, (int32_t *)prep);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_vrf_bc_prep_occupancy(int *out) {
  return pk_occupancy((const void *)vrf_bc_prep_kernel, 3 * PK_GROUP, 0, out);
}

// The same kernel's registers, local bytes, static shared bytes and
// max threads a block (obs/resources.py).
extern "C" int pk_vrf_bc_prep_attributes(int *out) {
  return pk_func_attributes((const void *)vrf_bc_prep_kernel, out);
}
