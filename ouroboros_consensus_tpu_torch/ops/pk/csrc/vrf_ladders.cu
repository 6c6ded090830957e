// Stage kernel `vrf_ladders`: U' = s·B − c·Y, V' = s·H − c·Γ, 8Γ.
// Replaces the TPU kernel ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_ladder_kernel.
//
// Bound: operations, and on the main path the dependent chain of one
// lane (half the launches are one block), where a lone warp issues an
// instruction every few cycles. So one lane runs over eight warps
// (stages.cuh, QLadderScratch): the tables of H, −Γ and −Y and 8Γ are
// formed beside s·B; then V' (256 doublings, the critical path) runs on
// one quad of four warps beside U' on the other, each warp one product of
// every point operation. A block is 32 lanes, 256 threads, 145 KB of
// shared memory: one block an SM.
// Not used: tensor cores (IMMA multiplies int8 pieces into int32; a
// 25.5-bit limb product would take ~16 of them plus carries, where one
// IMAD.WIDE does it) and TMA (a lane's inputs are a few hundred bytes of
// coalesced limb-first columns; the w8 base table stays in L2 behind
// __ldg).
#include "stages.cuh"

__global__ void __launch_bounds__(8 * PK_GROUP) vrf_ladder_kernel(
    int B, const u32 *base8, const int32_t *c16, const int32_t *s,
    const int32_t *prep, int32_t *pts) {
  extern __shared__ __align__(16) u32 smem[];
  QLadderScratch &sc = *reinterpret_cast<QLadderScratch *>(smem);
  int lane = threadIdx.x % PK_GROUP, warp = threadIdx.x / PK_GROUP;
  int i = blockIdx.x * PK_GROUP + lane;
  bool live = i < B;
  int ii = live ? i : B - 1;  // lanes past B run along for the barriers
  LaneTab th{sc.tab_h, lane}, tg{sc.tab_g, lane}, ty{sc.tab_y, lane};
  Quad qv{sc.qx, warp, lane, 1, 0};
  Quad qu{sc.qx + PK_QUAD_WORDS, warp - 4, lane, 2, 0};
  if (warp == 0) ladder_table_h(ii, B, prep, th);
  else if (warp == 1) ladder_table_g(ii, B, prep, tg);
  else if (warp == 2) ladder_table_y(ii, B, prep, ty);
  else if (warp == 3) { if (live) ladder_passthrough(i, B, prep, pts); }
  else ladder_qbase(ii, B, base8, s, qu, sc.sb);
  __syncthreads();
  if (warp < 4) ladder_qv(ii, B, live, c16, s, th, tg, qv, pts);
  else ladder_qu(ii, B, live, c16, ty, sc.sb, qu, pts);
}

template <class K>
static cudaError_t with_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

extern "C" int pk_vrf_ladders(int B, const void *base8, const void *c16,
                              const void *s, const void *prep, void *pts,
                              void *stream) {
  int smem = (int)sizeof(QLadderScratch);
  cudaError_t e = with_smem(vrf_ladder_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  vrf_ladder_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 8 * PK_GROUP, smem,
                      (cudaStream_t)stream>>>(
      B, (const u32 *)base8, (const int32_t *)c16, (const int32_t *)s,
      (const int32_t *)prep, (int32_t *)pts);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_vrf_ladders_occupancy(int *blocks) {
  int smem = (int)sizeof(QLadderScratch);
  cudaError_t e = with_smem(vrf_ladder_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vrf_ladder_kernel, 8 * PK_GROUP, smem);
}
