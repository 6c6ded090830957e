// Stage kernel `kes`: CompactSum KES leaf verify-point + Merkle walk.
// Replaces the TPU kernel ouroboros_consensus_tpu/ops/pk/kernels.py:_kes_kernel.
//
// Bound: operations, and on the main path the dependent chain of one
// lane (half the launches are one block), where a lone warp issues an
// instruction every few cycles. So one lane runs over four warps
// (stages.cuh, EdScratch: ed's roles and chain, plus the Merkle walk): the
// SHA-512 of the body and its mod-L reduction, the decompression of the
// leaf key and its table, s·B, and the Merkle walk run beside each other;
// then the 65-digit h·(−A) chain
// runs on the four warps as a quad, each warp one product of every point
// operation. A block is 32 lanes, 128 threads, 60 KB of shared memory.
// Not used: tensor cores (IMMA multiplies int8 pieces into int32; a
// 25.5-bit limb product would take ~16 of them plus carries, where one
// IMAD.WIDE does it) and TMA (a lane's inputs are a few hundred bytes of
// coalesced limb-first columns; the w8 base table stays in L2 behind
// __ldg).
#include "stages.cuh"

__global__ void __launch_bounds__(4 * PK_GROUP) kes_kernel(
    int B, int depth, const u32 *base8, const int32_t *vk,
    const int32_t *period, const int32_t *s, const int32_t *leaf,
    const int32_t *sib, const int32_t *hb, int nb, const int32_t *hnb,
    int32_t *ok, int32_t *pt) {
  extern __shared__ __align__(16) u32 smem[];
  EdScratch &sc = *reinterpret_cast<EdScratch *>(smem);
  int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  int i = blockIdx.x * PK_GROUP + lane;
  bool live = i < B;
  int ii = live ? i : B - 1;  // lanes past B run along for the barriers
  if (role == 0) ed_role_hash(ii, B, lane, hb, nb, hnb, sc);
  else if (role == 1) ed_role_table(ii, B, lane, leaf, sc);
  else if (role == 2) ed_role_base(ii, B, lane, base8, s, sc);
  else kes_role_merkle(ii, B, lane, depth, vk, period, leaf, sib, sc);
  __syncthreads();
  Quad qd{sc.qx, role, lane, 1, 0};
  ed_quad_chain(ii, B, live, 3, sc, qd, ok, pt);
}

extern "C" int pk_kes(int B, int depth, const void *base8, const void *vk,
                      const void *period, const void *s, const void *leaf,
                      const void *sib, const void *hb, int nb,
                      const void *hnb, void *ok, void *pt, void *stream) {
  typedef const int32_t *CI;
  int smem = (int)sizeof(EdScratch);
  cudaError_t e = cudaFuncSetAttribute(
      kes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kes_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 4 * PK_GROUP, smem,
               (cudaStream_t)stream>>>(
      B, depth, (const u32 *)base8, (CI)vk, (CI)period, (CI)s, (CI)leaf,
      (CI)sib, (CI)hb, nb, (CI)hnb, (int32_t *)ok, (int32_t *)pt);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_kes_occupancy(int *blocks) {
  int smem = (int)sizeof(EdScratch);
  cudaError_t e = cudaFuncSetAttribute(
      kes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kes_kernel, 4 * PK_GROUP, smem);
}
