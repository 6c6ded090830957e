// Kernel `dedupe`: the window aggregate's four repeated-key columns (R_e,
// A_e, A_l, Y), each collapsed into at most `cap` slots by its exact
// 32-byte key, the slots' coefficient sums reduced mod L, and the window's
// B coefficient (the lane sums of z1·s_e + z2·s_k + z3·s_v) reduced mod L.
// Replaces the plain-XLA _dedupe_column ×4 of
// ouroboros_consensus_tpu/ops/pk/aggregate.py:153 (a lax.sort over 32 key
// bytes and the lane index, cumsum, scatter-adds), reduce_raw_sums of its
// tables and the window-wide sum_mod_l of the B coefficient
// (ops/pk/limbs.py:489, :502; aggregate.py:189, :295).
//
// Bound: bytes (each key, coefficient and B row read once, the slots
// written once) — about 2.6 MB at 8,192 lanes. One launch, one path for
// every width: a block of 256 threads a tile of 256 lanes of one column
// (4 · 32 = 128 blocks at 8,192 lanes, one wave), no sorting network:
//   1. the tile: each thread packs its lane's key into four big-endian
//      words in shared memory and compares it with the tile's lanes
//      (broadcast reads; a warp's distinct keys in turn, 8 lanes a thread,
//      where the warp holds at most 8): the lanes below it, the lanes
//      equal, and whether it is its key's lowest lane (the leader). A scan
//      over the leaders' sorted positions ranks the tile's distinct keys;
//      a warp a slice of lanes, a lane a coefficient byte, sums each
//      group's bytes; columns 0-2 also sum the tile's lanes of one B row.
//      The tile's list (keys in order, lanes, lanes below, lowest lane;
//      the groups' byte sums beside it) goes to scratch. It is whole (256
//      lanes hold at most 256 keys), so the merges see every key even when
//      a column overflows;
//   2. a tree of tickets, DD_FAN (4) children a node: the last child to
//      finish (an atomic ticket after a fence; the last arrival resets it)
//      merges the children's sorted lists of keys, staged in shared memory
//      (4 · cap keys fit while a column is within its cap): each entry
//      placed by lower bounds in every other child, equal keys joined into
//      their first (lanes added, the lowest lane kept), then compacted by
//      a scan;
//   3. the block that completes a column's root ranks every tile group in
//      the root's first cap keys and adds its byte sums to its slot's (in
//      shared memory; groups past rank cap - 2 fall in the last slot, as
//      the reference's), then a thread a slot: the carry into words and
//      sc_reduce_words in registers, 32 bytes a slot, and the slot's point
//      (its key's lowest lane: the reference's stable sort puts it first);
//      past the cap the last slot's lane is the one at sorted position
//      min(Σ starts, B - 1).
//   The last tile of columns 0-2 to finish (a ticket of its own) reduces
//   the B row, off the columns' path.
// Never a hash. The slots' un-reduced rows never reach device memory (the
// tiles' group sums do, a u32 a byte, for the root). Not used: tensor
// cores and TMA (a few hundred KB of gathers and comparisons; its time is
// the dependent L2 round trips of the merge levels and the root).
#include "agg.cuh"

// two blocks an SM (128 registers a thread): past 132 tiles a launch
// takes fewer waves
__global__ void __launch_bounds__(DD_TILE, 2) dedupe_kernel(DedupeArgs a) {
  __shared__ DedupeSmem s;
  dd_block(blockIdx.x, a, s);
}

// keys k0..k3: [32][B] int32 byte columns; coeffs [DD_KEYS][B][32] uint8;
// pts [DD_KEYS][B][40] int32; brows [DD_BROWS][B][32] uint8; scratch of
// dd_scratch_bytes(T) bytes (T the tiles a column, any contents); tickets
// dd_ticket_count(T) int32, zero (each launch leaves them zero) -> red
// [DD_KEYS * cap + 1][32] uint8, tpts [DD_KEYS * cap][40] int32, ok
// [DD_KEYS] uint8
static int dedupe_launch(int B, int cap, const void *k0, const void *k1,
                         const void *k2, const void *k3, const void *coeffs, const void *pts,
                         const void *brows, void *scratch, size_t scratch_bytes,
                         void *tickets, void *red, void *tpts, void *ok, void *stamps,
                         void *stream) {
  if (!dd_shape_ok(B, cap) || scratch_bytes < dd_scratch_bytes(dd_tiles(B)))
    return (int)cudaErrorInvalidValue;
  const void *keys[DD_KEYS] = {k0, k1, k2, k3};
  DedupeArgs a = dd_args(B, cap, keys, coeffs, pts, brows, scratch, tickets, red, tpts, ok);
#ifdef DD_STAMPS
  a.stamps = (long long *)stamps;
#else
  (void)stamps;
#endif
  dedupe_kernel<<<DD_KEYS * a.T, DD_TILE, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#ifdef DD_STAMPS
// stamps: [DD_KEYS * T][DD_NSTAMP] int64, zeroed by the caller
extern "C" int pk_dedupe_stamps(int B, int cap, const void *k0, const void *k1,
                                const void *k2, const void *k3, const void *coeffs,
                                const void *pts, const void *brows, void *scratch,
                                size_t scratch_bytes, void *tickets, void *red, void *tpts,
                                void *ok, void *stamps, void *stream) {
  return dedupe_launch(B, cap, k0, k1, k2, k3, coeffs, pts, brows, scratch, scratch_bytes,
                       tickets, red, tpts, ok, stamps, stream);
}
#else
extern "C" int pk_dedupe(int B, int cap, const void *k0, const void *k1,
                         const void *k2, const void *k3, const void *coeffs, const void *pts,
                         const void *brows, void *scratch, size_t scratch_bytes, void *tickets,
                         void *red, void *tpts, void *ok, void *stream) {
  return dedupe_launch(B, cap, k0, k1, k2, k3, coeffs, pts, brows, scratch, scratch_bytes,
                       tickets, red, tpts, ok, nullptr, stream);
}

// Resident blocks per SM of the kernel (256 threads, its static shared
// memory).
extern "C" int pk_dedupe_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dedupe_kernel, DD_TILE, 0);
}
#endif
