// The forge's two kernels (csrc/forge.cuh has their lane bodies):
//
//   forge_sweep — the leader-election sweep of one election window, one
//                 lane per (slot, pool) pair. Replaces the plain-XLA
//                 `forge_sweep` of ouroboros_consensus_tpu/protocol/
//                 forge.py:91 (ops/ecvrf_batch.alpha_from_slots, :83;
//                 hash_to_curve, :130; prove, :265; the leader bracket).
//   ed_sign     — Ed25519 signing of the window's deduplicated OCert
//                 signables, one lane each. Replaces the plain-XLA
//                 `forge_sign` of protocol/forge.py:125 (ops/
//                 ed25519_batch.sign, :140).
//
// Bound: operations. A prove is two 65-digit variable-base ladders (x·H,
// k·H), a 32-add fixed-base walk (k·B), the Elligator2 exponentiation
// and two inversions; the sweep splits the two ladders over two warps of
// a 32-lane block (x·H beside k·B and k·H), so the dependent path is one
// hash to the curve, one inversion, k·B, one ladder and the final
// inversion. A sign is one fixed-base walk and one inversion.
// Not used: tensor cores and TMA, for the reasons pk.cuh gives; shared
// memory holds only the points that cross from the Γ warp to the k warp.
#include "forge.cuh"

__global__ void __launch_bounds__(2 * PK_GROUP) forge_sweep_kernel(ForgeArgs a,
                                                                   const u32 *base8) {
  __shared__ ForgeScratch sc;
  const int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  const int i = blockIdx.x * PK_GROUP + lane;
  const bool live = i < a.B;
  const int ii = live ? i : a.B - 1;  // lanes past B run along for the barrier
  if (role == 0) fs_role_k(ii, lane, a, base8, sc);
  else fs_role_gamma(ii, lane, a, sc);
  __syncthreads();
  if (role == 0 && live) fs_finish(i, lane, a, sc);
}

__global__ void __launch_bounds__(PK_GROUP) ed_sign_kernel(
    int B, int NB, const u32 *base8, const u8 *a, const u8 *aenc, const u8 *rblocks,
    const int32_t *rnb, const u8 *hblocks, const int32_t *hnb, u8 *out) {
  const int i = blockIdx.x * PK_GROUP + threadIdx.x;
  if (i < B) ed_sign_lane(i, NB, base8, a, aenc, rblocks, rnb, hblocks, hnb, out);
}

extern "C" int pk_forge_sweep(int B, int P, long long slot0, const void *base8,
                              const void *pools, const void *nonce, void *out,
                              void *stream) {
  ForgeArgs a{B, P, (int64_t)slot0, (const u8 *)pools, (const u8 *)nonce, (u8 *)out};
  forge_sweep_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 2 * PK_GROUP, 0,
                       (cudaStream_t)stream>>>(a, (const u32 *)base8);
  return (int)cudaGetLastError();
}

extern "C" int pk_ed_sign(int B, int NB, const void *base8, const void *a,
                          const void *aenc, const void *rblocks, const void *rnb,
                          const void *hblocks, const void *hnb, void *out, void *stream) {
  ed_sign_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, PK_GROUP, 0, (cudaStream_t)stream>>>(
      B, NB, (const u32 *)base8, (const u8 *)a, (const u8 *)aenc, (const u8 *)rblocks,
      (const int32_t *)rnb, (const u8 *)hblocks, (const int32_t *)hnb, (u8 *)out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the sweep, the source's heavier kernel.
extern "C" int pk_forge_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, forge_sweep_kernel, 2 * PK_GROUP, 0);
}

extern "C" int pk_ed_sign_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ed_sign_kernel, PK_GROUP, 0);
}
