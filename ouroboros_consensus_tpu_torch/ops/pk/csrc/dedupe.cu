// Kernel `dedupe`: the window aggregate's four repeated-key columns (R_e,
// A_e, A_l, Y), each collapsed into at most `cap` slots by its exact
// 32-byte key, and the window's B row. Replaces the plain-XLA
// _dedupe_column of ouroboros_consensus_tpu/ops/pk/aggregate.py:153 (a
// lax.sort over 32 byte keys and the lane index, cumsum, scatter-adds)
// and the lane sums of the B coefficient (aggregate.py:299), which the
// port's first version ran as some forty small torch launches.
//
// Bound: bytes (each key, coefficient and point read once, the slots
// written once) — about 2.6 MB at 8,192 lanes; the sort's steps are the
// dependent path. One launch, a block of 1,024 threads a column and one
// for the B row:
//   1. the column's keys packed into four big-endian words a lane (global
//      scratch: 32 KB of the 256 KB of keys fit no block's shared memory);
//   2. a stable sort by the first word (ties by lane): a bitonic sort in
//      shared memory of (word, position) pairs over the next power of
//      two (its steps that pair elements less than 64 apart stay inside
//      a warp: a warp's barrier, not the block's), the order gathered
//      after it, skipped when the words are
//      already in order (the one-pool chain's columns hold a key or two).
//      Past 8,192 lanes (16 bytes a lane and the slots no longer fit a
//      block's 227 KB) the same sort runs in global scratch, slower, so
//      a window as wide as an epoch still dedupes.
//      It is the reference's lexicographic order unless two keys tie on
//      their first 8 bytes and differ after them; then four such passes,
//      least significant word first, from the lanes' order;
//   3. group starts where a sorted key differs from the one before, an
//      inclusive scan of them (a thread's slice, then the threads' totals
//      on warp 0), ok_cap = groups <= cap;
//   4. a warp a slice of the sorted lanes, lane k coefficient byte k (the
//      loads sixteen at a time): a running sum over each run of one slot,
//      added to the slot's integer accumulator in shared memory (exact:
//      integers in any order), and each group start's position added to
//      its slot's start;
//   5. a thread a slot: its sums as int64, the point of the lane at its
//      start (clamped; unused slots: the first sorted lane's, sum 0).
// Never a hash. Not used: tensor cores and TMA (a few hundred KB of
// gathers and a sort).
#include "agg.cuh"

__device__ void dd_sync_scan(int t, int n, int *gid, int *part) {
  // inclusive scan of gid[0, n) in place: thread t a slice of per
  int per = (n + DD_THREADS - 1) / DD_THREADS, lo = t * per, hi = lo + per < n ? lo + per : n;
  int sum = 0;
  for (int i = lo; i < hi; i++) sum += gid[i];
  int lane = t & 31, wp = t >> 5, x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[wp] = x;
  __syncthreads();
  if (wp == 0) {
    int v = part[lane], z = v;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    part[lane] = z - v;
  }
  __syncthreads();
  int run = part[wp] + x - sum;
  for (int i = lo; i < hi; i++) {
    run += gid[i];
    gid[i] = run;
  }
  __syncthreads();
}

// a stable sort pass over word w from the current order: skipped when
// the words are already in order (flag: shared)
__device__ void dd_pass(int t, int w, int B, int np, const DedupeIn &in, const DedupeSmem &sm,
                        int *flag) {
  if (t == 0) *flag = 0;
  for (int i = t; i < np; i += DD_THREADS) dd_load(i, w, B, in, sm);
  __syncthreads();
  bool desc = false;
  for (int i = t; i < np; i += DD_THREADS) desc = desc || dd_descent(i, sm);
  if (desc) *flag = 1;
  __syncthreads();
  if (!*flag) return;
  // a step with j <= 32 pairs elements within 64-element segments, and
  // a warp's pairs (p = 32w + lane + 1024r) lie in segments of its own:
  // such steps need the warp's barrier alone
  bool block_prev = true;
  for (int kk = 2; kk <= np; kk <<= 1)
    for (int j = kk >> 1; j > 0; j >>= 1) {
      bool block = j > 32;
      if (block && !block_prev) __syncthreads();
      for (int p = t; p < np / 2; p += DD_THREADS) dd_cmpx(p, j, kk, sm);
      if (block) __syncthreads();
      else __syncwarp();
      block_prev = block;
    }
  __syncthreads();
  u32 *got = (u32 *)sm.sk;  // the sorted words are spent
  for (int i = t; i < np; i += DD_THREADS) got[i] = dd_gathered(i, sm);
  __syncthreads();
  for (int i = t; i < np; i += DD_THREADS) sm.perm[i] = got[i];
  __syncthreads();
}

// blocks 0 .. DD_KEYS - 1: column c; block DD_KEYS: the B row, the byte
// sums of the DD_BROWS · B rows of 32 bytes. `gscr` null: the sort's
// arrays in shared memory, else in gscr, 16 np bytes a column
__global__ void __launch_bounds__(DD_THREADS) dedupe_kernel(
    int B, int np, int cap, DedupeIn in0, DedupeIn in1, DedupeIn in2, DedupeIn in3,
    const u8 *brows, u8 *gscr, int64_t *raw, int32_t *tpts, u8 *ok) {
  extern __shared__ __align__(16) u8 dd_smem[];
  __shared__ int part[32];
  __shared__ int flag, refine;
  int t = threadIdx.x, c = blockIdx.x;
  if (c == DD_KEYS) {
    int *sums = (int *)dd_smem;  // [DD_THREADS / 8][32]
    dd_brow_part(t, DD_BROWS * B, brows, sums + (t >> 3) * 32 + 4 * (t & 7));
    __syncthreads();
    if (t < 32) {
      int64_t v = 0;
      for (int g = 0; g < DD_THREADS / 8; g++) v += sums[g * 32 + t];
      raw[(size_t)DD_KEYS * cap * 32 + t] = v;
    }
    return;
  }
  const DedupeIn in = c == 0 ? in0 : c == 1 ? in1 : c == 2 ? in2 : in3;
  u8 *sort = gscr ? gscr + (size_t)c * np * 16 : dd_smem;
  DedupeSmem sm;
  sm.sk = (u64 *)sort;
  sm.gid = (int *)sort;  // after the sort
  sm.sp = (u32 *)(sort + (size_t)np * 8);
  sm.perm = sm.sp + np;
  sm.acc = (int *)(gscr ? dd_smem : sort + (size_t)np * 16);
  sm.starts = sm.acc + cap * 32;
  for (int l = t; l < B; l += DD_THREADS) dd_pack(l, B, in);
  for (int i = t; i < np; i += DD_THREADS) sm.perm[i] = (u32)i;
  if (t == 0) refine = 0;
  __syncthreads();
  // the first word alone decides unless a tie on it hides different keys
  dd_pass(t, 0, B, np, in, sm, &flag);
  bool tie = false;
  for (int i = t; i < B; i += DD_THREADS) tie = tie || dd_tie_differs(i, B, in, sm);
  if (tie) refine = 1;
  __syncthreads();
  if (refine) {
    for (int i = t; i < np; i += DD_THREADS) sm.perm[i] = (u32)i;
    __syncthreads();
    for (int w = 3; w >= 0; w--) dd_pass(t, w, B, np, in, sm, &flag);
  }
  for (int i = t; i < B; i += DD_THREADS) sm.gid[i] = dd_newgrp(i, B, in, sm);
  for (int i = t; i < cap * 33; i += DD_THREADS) sm.acc[i] = 0;  // acc and starts
  __syncthreads();
  dd_sync_scan(t, B, sm.gid, part);
  dd_sums(t >> 5, t & 31, DD_THREADS / 32, B, cap, in, sm);
  __syncthreads();
  DedupeOut o{raw + (size_t)c * cap * 32, tpts + (size_t)c * cap * 40, ok};
  for (int s = t; s < cap; s += DD_THREADS) dd_store(s, B, in, sm, o);
  if (t == 0) ok[c] = sm.gid[B - 1] <= cap ? 1 : 0;
}

// keys: DD_KEYS pointers to [32][B] int32 byte columns; coeffs
// [DD_KEYS][B][32] uint8; pts [DD_KEYS][B][40] int32; brows
// [DD_BROWS][B][32] uint8; words: scratch [DD_KEYS][4][B] u64; gscr: past
// DD_SMEM_LANES lanes, scratch of 16 np bytes a column (np the power of
// two >= B), else unread -> raw [DD_KEYS * cap + 1][32] int64, tpts
// [DD_KEYS * cap][40] int32, ok [DD_KEYS] uint8
extern "C" int pk_dedupe(int B, int cap, const void *const *keys, const void *coeffs,
                         const void *pts, const void *brows, void *words, void *gscr, void *raw,
                         void *tpts, void *ok, void *stream) {
  if (B < 1 || B > DD_MAXN || cap < 1 || cap > DD_MAXCAP) return (int)cudaErrorInvalidValue;
  int np = 1;
  while (np < B) np <<= 1;
  bool smem = np <= DD_SMEM_LANES;
  if (!smem && gscr == nullptr) return (int)cudaErrorInvalidValue;
  size_t bytes = (smem ? (size_t)np * 16 : 0) + (size_t)cap * 33 * 4;
  if (bytes < DD_THREADS / 8 * 32 * 4) bytes = DD_THREADS / 8 * 32 * 4;  // the B row's block
  cudaError_t e = cudaFuncSetAttribute(dedupe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  DedupeIn in[DD_KEYS];
  for (int c = 0; c < DD_KEYS; c++)
    in[c] = DedupeIn{(const int32_t *)keys[c], (const u8 *)coeffs + (size_t)c * B * 32,
                     (const int32_t *)pts + (size_t)c * B * 40,
                     (u64 *)words + (size_t)c * 4 * B};
  dedupe_kernel<<<DD_KEYS + 1, DD_THREADS, bytes, (cudaStream_t)stream>>>(
      B, np, cap, in[0], in[1], in[2], in[3], (const u8 *)brows,
      smem ? nullptr : (u8 *)gscr, (int64_t *)raw, (int32_t *)tpts, (u8 *)ok);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the main path's shape (8,192 lanes, cap 256).
extern "C" int pk_dedupe_occupancy(int *blocks) {
  size_t bytes = (size_t)8192 * 16 + (size_t)256 * 33 * 4;
  cudaError_t e = cudaFuncSetAttribute(dedupe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dedupe_kernel, DD_THREADS,
                                                            bytes);
}
