// Kernel `agg_tables`: the window aggregate's mod-L reductions — each
// dedupe table slot's scatter-added coefficient bytes, and the window's
// collected B coefficient (the lane sums of z1·s_e + z2·s_k + z3·s_v),
// from un-carried int64 byte rows to 32 bytes below L. Replaces the
// plain-XLA reduce_raw_sums of the dedupe tables and the window-wide
// sum_mod_l (ouroboros_consensus_tpu/ops/pk/limbs.py:489, :502;
// aggregate.py:153, :299).
//
// Bound: bytes on paper (R rows of 256 bytes in, 32 out: 4 · 256 + 1 rows
// a window), launch latency in practice. A thread a row: one carry into
// 64 bytes, then pk.cuh's sc_reduce512.
#include "agg.cuh"

__global__ void __launch_bounds__(128) agg_tables_kernel(int R, const int64_t *raw, u8 *out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) agg_table_row(r, raw, out);
}

extern "C" int pk_agg_tables(int R, const void *raw, void *out, void *stream) {
  agg_tables_kernel<<<(R + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      R, (const int64_t *)raw, (u8 *)out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_agg_tables_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, agg_tables_kernel, 128, 0);
}
