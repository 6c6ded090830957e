// Kernel `unpack`: the packed window's columns -> every limb-first int32
// row the five stage kernels read, in one launch (wire.cuh: the rows
// segment by segment, the OCert and KES SHA-512 messages padded into
// blocks, the VRF alpha, the KES evolution). Replaces the plain-XLA
// unpack stage of the TPU path: ouroboros_consensus_tpu/protocol/
// batch.py:unpack_packed with ops/pk/kernels.py:staged_to_limb_first(_bc)
// (one program, ops/pk/kernels.py:_mk_packed_unpack).
//
// Bound: bytes. A lane reads its body and table rows (a few hundred
// bytes) and writes R int32 rows (R = 1,000 to 2,000 for the chains the
// replay sees); its one Blake2b compression for the alpha is ~2,100
// instructions, under the byte time at any width. Design: one thread a
// (lane, row), lanes fastest within a block of 128, so each row's writes
// are 512 contiguous bytes; a block walks rows blockIdx.y, +gridDim.y,
// ... and its branch on the row's segment is the same for all its
// threads. The byte reads of one row stride across lanes by the body
// width and are left to L1 and L2 (a window's body is a few MB); a
// transpose through shared memory would make them coalesce, not done.
// The alpha's first row's threads hash and write all 32 alpha rows.
#include "wire.cuh"

#define UNPACK_LANES 128
#define UNPACK_ROW_BLOCKS 64

__global__ void __launch_bounds__(UNPACK_LANES) unpack_kernel(
    int B, WireLayout L, WireIn in, int32_t *out) {
  int start[W_NSEG + 1];
  wire_rows(L, start);
  int i = blockIdx.x * UNPACK_LANES + threadIdx.x;
  if (i >= B) return;
  for (int r = blockIdx.y; r < start[W_NSEG]; r += gridDim.y)
    unpack_row_lane(L, in, start, r, i, B, out);
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
  dim3 grid((B + UNPACK_LANES - 1) / UNPACK_LANES, UNPACK_ROW_BLOCKS);
  unpack_kernel<<<grid, UNPACK_LANES, 0, (cudaStream_t)stream>>>(
      B, L, in, (int32_t *)out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_unpack_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, unpack_kernel, UNPACK_LANES, 0);
}
