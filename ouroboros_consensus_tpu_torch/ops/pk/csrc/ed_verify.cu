// Kernel `ed_verify`: standalone RFC 8032 cofactorless Ed25519 verify of
// a batch of (A, R ‖ s, M), one verdict a lane: A decodes, s < L and
// compress(s·B − h·A) == R with h = SHA-512(R ‖ A ‖ M) mod L over each
// lane's own count of SHA-512 blocks (messages of any length in one batch).
// Replaces the plain-XLA verify of ouroboros_consensus_tpu/ops/ed25519_batch.py
// (verify_point, verify: the Byron signatures of the mixed-era composite and
// the standalone witness signatures of batched verification).
//
// The design is ed's (csrc/ed.cu, stages.cuh: EdScratch and the same role
// and chain functions): a block of 32 lanes on four warps; the SHA-512 and
// its mod-L reduction, the decompression of A and its table, and s·B
// beside each other on three warps; then the 65-digit h·(−A) chain on the
// four warps as a quad. Then warp 0 compresses P (one inversion a lane)
// and compares it with R (ed_quad_verify). 128 threads, 60 KB of shared
// memory a block.
// Bound: operations (a lane moves under 1 KB through device memory): ed's
// field work plus one inversion.
// Not used: tensor cores and TMA, for ed's reasons (a 25.5-bit limb product
// is one IMAD.WIDE; a lane's inputs are a few hundred bytes of coalesced
// limb-first columns).
#include "stages.cuh"

__global__ void __launch_bounds__(4 * PK_GROUP) ed_verify_kernel(
    int B, const u32 *base8, const int32_t *pk, const int32_t *r, const int32_t *s,
    const int32_t *hb, int nb, const int32_t *hnb, int32_t *ok) {
  extern __shared__ __align__(16) u32 smem[];
  EdScratch &sc = *reinterpret_cast<EdScratch *>(smem);
  int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  int i = blockIdx.x * PK_GROUP + lane;
  bool live = i < B;
  int ii = live ? i : B - 1;  // lanes past B run along for the barriers
  if (role == 0) ed_role_hash(ii, B, lane, hb, nb, hnb, sc);
  else if (role == 1) ed_role_table(ii, B, lane, pk, sc);
  else if (role == 2) ed_role_base(ii, B, lane, base8, s, sc);
  __syncthreads();
  Quad qd{sc.qx, role, lane, 1, 0};
  ed_quad_verify(ii, B, live, sc, qd, r, ok);
}

static cudaError_t with_smem() {
  return cudaFuncSetAttribute(ed_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(EdScratch));
}

extern "C" int pk_ed_verify(int B, const void *base8, const void *pk, const void *r,
                            const void *s, const void *hb, int nb, const void *hnb,
                            void *ok, void *stream) {
  cudaError_t e = with_smem();
  if (e != cudaSuccess) return (int)e;
  ed_verify_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 4 * PK_GROUP, sizeof(EdScratch),
                     (cudaStream_t)stream>>>(
      B, (const u32 *)base8, (const int32_t *)pk, (const int32_t *)r, (const int32_t *)s,
      (const int32_t *)hb, nb, (const int32_t *)hnb, (int32_t *)ok);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_ed_verify_occupancy(int *blocks) {
  cudaError_t e = with_smem();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ed_verify_kernel, 4 * PK_GROUP, sizeof(EdScratch));
}
