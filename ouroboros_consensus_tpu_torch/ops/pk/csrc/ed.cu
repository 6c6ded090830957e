// Stage kernel `ed`: OCert Ed25519 verify-point, P = s·B − h·A.
// Replaces the TPU kernel ouroboros_consensus_tpu/ops/pk/kernels.py:_ed_kernel.
//
// Bound: operations, and on the main path the dependent chain of one
// lane (half the launches are one block), where a lone warp issues an
// instruction every few cycles. So one lane runs over four warps, as in
// kes (stages.cuh, EdScratch, the same role and chain functions): the
// SHA-512 of R ‖ A ‖ M and its mod-L reduction, the decompression of A and
// its table, and s·B run beside each other (the fourth warp has no phase-1
// role); then the 65-digit h·(−A) chain runs on the four warps as a quad,
// each warp one product of every point operation. A block is 32 lanes,
// 128 threads, 60 KB of shared memory.
// Not used: tensor cores (IMMA multiplies int8 pieces into int32; a
// 25.5-bit limb product would take ~16 of them plus carries, where one
// IMAD.WIDE does it) and TMA (a lane's inputs are a few hundred bytes of
// coalesced limb-first columns; the w8 base table stays in L2 behind
// __ldg).
#include "stages.cuh"

__global__ void __launch_bounds__(4 * PK_GROUP) ed_kernel(
    int B, const u32 *base8, const int32_t *pk, const int32_t *s,
    const int32_t *hb, int nb, const int32_t *hnb, int32_t *ok, int32_t *pt) {
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
  ed_quad_chain(ii, B, live, 2, sc, qd, ok, pt);
}

static cudaError_t with_smem() {
  return cudaFuncSetAttribute(ed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(EdScratch));
}

extern "C" int pk_ed(int B, const void *base8, const void *pk, const void *s,
                     const void *hb, int nb, const void *hnb, void *ok,
                     void *pt, void *stream) {
  cudaError_t e = with_smem();
  if (e != cudaSuccess) return (int)e;
  ed_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 4 * PK_GROUP, sizeof(EdScratch),
              (cudaStream_t)stream>>>(
      B, (const u32 *)base8, (const int32_t *)pk, (const int32_t *)s,
      (const int32_t *)hb, nb, (const int32_t *)hnb, (int32_t *)ok,
      (int32_t *)pt);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_ed_occupancy(int *blocks) {
  cudaError_t e = with_smem();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ed_kernel, 4 * PK_GROUP, sizeof(EdScratch));
}
