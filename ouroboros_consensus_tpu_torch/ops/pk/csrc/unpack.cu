// Kernel `unpack`: the packed window's columns -> every limb-first int32
// row the five stage kernels read, in one launch (wire.cuh: the rows
// segment by segment, the OCert and KES SHA-512 messages padded into
// blocks, the VRF alpha, the KES evolution). Replaces the plain-XLA
// unpack stage of the TPU path: ouroboros_consensus_tpu/protocol/
// batch.py:unpack_packed with ops/pk/kernels.py:staged_to_limb_first(_bc)
// (one program, ops/pk/kernels.py:_mk_packed_unpack).
//
// Bound: bytes. A lane reads its body and table rows (about 830 bytes on
// the replay's chains) and writes R int32 rows (R = 1,000 to 2,000): the
// writes are nine tenths of the bytes. Design: a block owns a tile of 32
// lanes (fewer for a smaller window) and a group of its rows. It first
// stages the tile's sources in shared memory, transposed (byte k of lane
// l at [k * 32 + l]): each lane's body, KES signature, tail and threshold
// rows (16-byte loads where aligned, a warp's threads on 32 lanes' chunks
// so the shared stores do not conflict), while its last warp hashes the
// lanes' VRF alphas with the unrolled one-thread compression (b2b_256_1,
// not pk.cuh's looped blake2b_256, 1.7x slower on one thread). Then it
// writes its rows segment by segment, a thread 4 lanes of a row with one
// 16-byte store, so reads and writes both coalesce and no row walks a
// segment table. The
// geometry comes from a small table computed once a launch on the host
// (unpack_grid): a full window is one group (256 blocks), an 8-lane one
// 26 groups of 64 rows, so it spreads over the SMs.
#include "wire.cuh"

#define UNPACK_THREADS 256

__global__ void __launch_bounds__(UNPACK_THREADS) unpack_kernel(
    int B, WireLayout L, WireIn in, UnpackGrid g, int32_t *out) {
  extern __shared__ __align__(16) u8 sm[];
  const WireTile t = wire_tile(sm, L, g.tl, g.lt);
  const int l0 = blockIdx.x * g.tl, n = min(g.tl, B - l0);
  int rb, re;
  unpack_group_rows(g, blockIdx.y, rb, re);
  // the last warp hashes the alphas (if the rows hold them), the others copy
  if (threadIdx.x < UNPACK_THREADS - 32)
    unpack_stage(L, in, t, l0, n, g.vec, threadIdx.x, UNPACK_THREADS - 32);
  else if (unpack_has_alpha(L, rb, re))
    unpack_alphas(L, in, t, l0, n, threadIdx.x - (UNPACK_THREADS - 32), 32);
  __syncthreads();
  unpack_rows(L, t, rb, re, l0, n, B, out, g.v4, threadIdx.x, UNPACK_THREADS);
}

extern "C" int pk_unpack(int B, const int *lay, const void *body,
                         const void *kes_rs, const void *tail_idx,
                         const void *tail_tab, const void *slot,
                         const void *counter, const void *c0,
                         const void *thr_idx, const void *thr_tab,
                         const void *nonce, void *out, void *stream) {
  WireLayout L{lay[0], lay[1], lay[2], lay[3], lay[4], lay[5],
               lay[6], lay[7], lay[8], lay[9], lay[10]};
  WireIn in{(const u8 *)body, (const u8 *)kes_rs, (const int32_t *)tail_idx,
            (const u8 *)tail_tab, (const int32_t *)slot,
            (const int32_t *)counter, (const int32_t *)c0,
            (const int32_t *)thr_idx, (const u8 *)thr_tab, (const u8 *)nonce};
  const UnpackGrid g = unpack_grid(L, in, B);
  if (g.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + g.tl - 1) / g.tl, g.groups);
  unpack_kernel<<<grid, UNPACK_THREADS, g.smem, (cudaStream_t)stream>>>(
      B, L, in, g, (int32_t *)out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches, at a full
// window's tile (32 lanes of 1,024-byte bodies, depth 7).
extern "C" int pk_unpack_occupancy(int *out) {
  WireLayout L{1024, 0, 0, 0, 0, 0, 0, 7, 1, 0, 128};
  return pk_occupancy((const void *)unpack_kernel, UNPACK_THREADS, wire_tile_bytes(L, 32),
                      out);
}

// The same kernel's registers, local bytes, static shared bytes and
// max threads a block (obs/resources.py).
extern "C" int pk_unpack_attributes(int *out) {
  return pk_func_attributes((const void *)unpack_kernel, out);
}
