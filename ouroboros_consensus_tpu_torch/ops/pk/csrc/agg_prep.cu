// Kernel `agg_prep`: the per-lane half of the window aggregate — the
// eight decompressions, the challenge digests, the KES Merkle walk, H and
// 8Γ with their compressions, c and β, the leader value and eta, the
// Fiat–Shamir coefficients and the mod-L products the MSM takes.
// Replaces the per-lane part of the plain-XLA aggregate_window of
// ouroboros_consensus_tpu/ops/pk/aggregate.py:232-326.
//
// Bound: operations — nine field exponentiations (eight square roots,
// one Elligator2) and two inversions a lane, SHA-512 and Blake2b
// compressions beside them; no ladder. The lane's independent parts run
// on four warps of one block (agg.cuh, agg_role_*), as the stage kernels
// split theirs: the OCert digest, A_e, R_e and V (warp 0); the KES digest,
// Merkle walk, A_l and R_k, then the leader value and eta (1); H, its
// compression, c, and Y (2); Γ, 8Γ's compression and β, and U (3); three
// exponentiation chains on the longest path. They meet in shared memory
// (AggScratch); warp 0 hashes the lane's transcript into z1..z4 (the
// transcript reads both digests), then each warp forms its coefficient's
// mod-L products. A block is 32 lanes, 128 threads.
// Not used: tensor cores and TMA, for the stage kernels' reasons (the
// field products are 32x32->64 IMADs; a lane's inputs are a few hundred
// bytes of coalesced limb-first columns).
#include "agg.cuh"

__global__ void __launch_bounds__(4 * PK_GROUP) agg_prep_kernel(
    AggShape s, AggIn in, AggOut o) {
  __shared__ AggScratch sc;
  int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  int i = blockIdx.x * PK_GROUP + lane;
  bool live = i < s.B;
  int ii = live ? i : s.B - 1;  // lanes past B run along for the barriers
  if (role == 0) agg_role_ed(ii, live, lane, s, in, o, sc);
  else if (role == 1) agg_role_kes(ii, live, lane, s, in, o, sc);
  else if (role == 2) agg_role_h(ii, live, lane, s, in, o, sc);
  else agg_role_gamma(ii, live, lane, s, in, o, sc);
  __syncthreads();
  if (role == 0) agg_fs(ii, lane, s, in, sc);
  __syncthreads();
  agg_products(role, ii, live, lane, s, in, o, sc);
}

extern "C" int pk_agg_prep(int B, int depth, int nb_ed, int nb_kes,
                           void *const *cols, void *pts, void *scal,
                           void *flags, void *eta, void *lv, void *stream) {
  AggShape s{B, depth, nb_ed, nb_kes};
  AggIn in;
  for (int k = 0; k < AI_N; k++) in.c[k] = (const int32_t *)cols[k];
  AggOut o{(int32_t *)pts, (u8 *)scal, (int32_t *)flags, (int32_t *)eta, (int32_t *)lv};
  agg_prep_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 4 * PK_GROUP, 0,
                    (cudaStream_t)stream>>>(s, in, o);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_agg_prep_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, agg_prep_kernel, 4 * PK_GROUP, 0);
}
