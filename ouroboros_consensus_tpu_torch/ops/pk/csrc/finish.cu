// Stage kernel `finish`: shared-inversion compression of 7 points, the
// R-byte / challenge / beta compares, Blake2b range extensions and the
// bracketed leader compare. Replaces the TPU kernel
// ouroboros_consensus_tpu/ops/pk/kernels.py:_finish_kernel.
//
// Bound: operations, and on the main path the dependent chain of one
// lane (half the launches are one block): one field inversion (~254
// dependent squarings) behind the seven points' Montgomery products, then
// three SHA-512 and three Blake2b compressions. The Blake2b work and the
// threshold compares read only the declared β, and the ed and KES
// compares, c' (over H, Γ, U', V') and β' (over 8Γ) each need only their
// own points' encodings. So one lane runs over three warps (stages.cuh,
// finish_role_*), each compressing its own points on an inversion of its
// own: H, Γ, U', V' and c' on one (the critical path), 8Γ and β' on
// another, the ed and KES points, their compares and the Blake2b work on
// the third; the two VRF flags meet in shared memory at one barrier. The
// path falls from inversion + seven points + three SHA-512 + three Blake2b
// to inversion + four points + two SHA-512 compressions; the lane does
// three inversions where it did one. (A two-warp design that kept one
// inversion a lane was slower at every width measured: PERF.md §6.)
// A block is 32 lanes, 96 threads.
// Not used: tensor cores (IMMA multiplies int8 pieces into int32; a
// 25.5-bit limb product would take ~16 of them plus carries, where one
// IMAD.WIDE does it) and TMA (a lane's inputs are point and byte columns,
// coalesced limb-first; nothing is staged through shared memory).
#include "stages.cuh"

__global__ void __launch_bounds__(3 * PK_GROUP) finish_kernel(
    int B, const int32_t *edok, const int32_t *edpt, const int32_t *edr,
    const int32_t *kesok, const int32_t *kespt, const int32_t *kesr,
    const int32_t *vrfok, const int32_t *vrfpts, const int32_t *c,
    const int32_t *beta, const int32_t *tlo, const int32_t *thi,
    int32_t *out, int32_t *eta, int32_t *lv) {
  __shared__ FinishScratch sc;
  int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  int i = blockIdx.x * PK_GROUP + lane;
  bool live = i < B;
  int ii = live ? i : B - 1;  // lanes past B run along for the barrier
  if (role == 0) finish_role_vrf(ii, B, lane, vrfpts, c, sc);
  else if (role == 1) finish_role_beta(ii, B, lane, vrfpts, beta, sc);
  else finish_role_sig(ii, B, live, edok, edpt, edr, kesok, kespt, kesr, beta,
                       tlo, thi, out, eta, lv);
  __syncthreads();
  if (live && role == 0) finish_vrf_ok(i, B, lane, vrfok, sc, out);
}

extern "C" int pk_finish(int B, const void *edok, const void *edpt,
                         const void *edr, const void *kesok,
                         const void *kespt, const void *kesr,
                         const void *vrfok, const void *vrfpts,
                         const void *c, const void *beta, const void *tlo,
                         const void *thi, void *out, void *eta, void *lv,
                         void *stream) {
  finish_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 3 * PK_GROUP, 0,
                  (cudaStream_t)stream>>>(
      B, (const int32_t *)edok, (const int32_t *)edpt, (const int32_t *)edr,
      (const int32_t *)kesok, (const int32_t *)kespt, (const int32_t *)kesr,
      (const int32_t *)vrfok, (const int32_t *)vrfpts, (const int32_t *)c,
      (const int32_t *)beta, (const int32_t *)tlo, (const int32_t *)thi,
      (int32_t *)out, (int32_t *)eta, (int32_t *)lv);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_finish_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, finish_kernel, 3 * PK_GROUP, 0);
}
