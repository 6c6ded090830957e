// Kernel `msm`: the window aggregate's shared signed-digit bucket
// machine, Σ k_i·P_i + b·B and the exact identity test. Replaces the
// plain-XLA msm_shared of ouroboros_consensus_tpu/ops/pk/msm.py:381 (its
// argsort bucketing, chunked segment scans, Abel pass and Horner walk) and
// the B term's fixed-base mul (aggregate.py:304).
//
// Bound: operations — the bucket additions (one a nonzero digit: 11
// windows over the 128-bit group, 22 over the wide one; 9 field products
// each) and the weighted-sum tree's four a node — and, at a replay
// window's size, the dependent path: the Horner chain's 252 doublings
// and 21 additions on one warp. Ten launches of this source on one
// stream (nine kernels, msm_wide twice), the bucketing by counts, a scan
// and atomics (no sort), every phase spread over the card but the last:
//   1. recode, a thread a point: balanced 12-bit digits, a count per
//      (window, |digit|) for each nonzero digit (digit 0 weighs nothing);
//   2. one block: the exclusive scan of the counts, a warp a slice, its
//      loads coalesced;
//   3. scatter, a thread a point: its index (sign in bit 31) and the
//      bucket's key into each of its buckets at the next free place;
//   4. a thread a chunk of 16 consecutive entries: the running sums of the
//      buckets it meets (at most 15 additions, whatever the buckets'
//      sizes): a whole bucket into its place, the pieces of a bucket that
//      crosses chunks beside them;
//   5. a thread a bucket: the pieces of a bucket that crosses up to 8
//      chunks, added; a bigger one is listed for
//   5b. a block a listed bucket: a tree over its pieces;
//   6. the weighted sums as a tree (W and N a node), its three widest
//      levels a thread a node and role: the first two as running sums
//      over four buckets a node, the third a launch of its own (one more
//      block of the first forms the B term from the fixed-base table on a
//      quad, beside them);
//   7. a block a window, two quads (one the W of each node, the other its
//      N), a node a lane: the tree's last eight levels, 256 nodes to the
//      window's sum, each level in a part of the scratch that is the
//      window's alone;
//   8. one warp: the Horner chain and the B term with a field element over
//      ten lanes, three products a round (agg.cuh: w_mul), then X = 0 and
//      Y = Z.
// Not used: tensor cores (the field products are 32x32->64 IMADs) and TMA
// (the bucket phase gathers 160-byte points at random; the working set,
// 7 MB of points and 7 MB of buckets, stays in L2).
#include "agg.cuh"

#define MSM_THREADS 128

__global__ void __launch_bounds__(MSM_THREADS) msm_recode_kernel(
    MsmShape s, const u8 *scalars, int32_t *digits, int *counts) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < s.n) msm_recode(p, s, scalars, digits, counts);
}

// exclusive scan of counts[m] -> offsets[m + 1] and the scatter's cursor:
// warp k scans a slice of the counts 32 at a time (coalesced loads, a
// shuffle scan), after a first pass that sums each slice
__global__ void __launch_bounds__(1024) msm_scan_kernel(
    int m, const int *counts, int *offsets, int *cursor) {
  __shared__ int part[32];
  int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  int per = ((m + 31) / 32 + 31) & ~31;
  int lo = wp * per, hi = lo + per < m ? lo + per : m;
  int sum = 0;
#pragma unroll 4
  for (int i = lo + lane; i < hi; i += 32) sum += counts[i];
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) part[wp] = sum;
  __syncthreads();
  if (wp == 0) {
    int v = part[lane], x = v;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    part[lane] = x - v;
    if (lane == 31) offsets[m] = x;
  }
  __syncthreads();
  int base = part[wp];
  for (int i0 = lo; i0 < hi; i0 += 32) {
    int i = i0 + lane, c = i < hi ? counts[i] : 0, x = c;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (i < hi) {
      offsets[i] = base + x - c;
      cursor[i] = base + x - c;
    }
    base += __shfl_sync(0xffffffffu, x, 31);
  }
}

__global__ void __launch_bounds__(MSM_THREADS) msm_scatter_kernel(
    MsmShape s, const int32_t *digits, int *cursor, u32 *ent, int *ekey) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < s.n) msm_scatter(p, s, digits, cursor, ent, ekey);
}

__global__ void __launch_bounds__(MSM_THREADS) msm_chunk_kernel(
    int nch, int m, const int *offsets, const u32 *ent, const int *ekey,
    const int32_t *pts, int32_t *buckets, int32_t *part, int32_t *tailp) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nch) msm_chunk(t, m, offsets, ent, ekey, pts, buckets, part, tailp);
}

__global__ void __launch_bounds__(MSM_THREADS) msm_span_kernel(
    int m, const int *offsets, const int32_t *part, const int32_t *tailp,
    int32_t *buckets, int *big) {
  int key = blockIdx.x * blockDim.x + threadIdx.x;
  if (key < m) msm_span(key, offsets, part, tailp, buckets, big);
}

// a block a listed bucket; the grid is the list's bound, the blocks past
// its length return at once
__global__ void __launch_bounds__(MSM_BIG) msm_big_kernel(
    const int *big, const int *offsets, const int32_t *part, const int32_t *tailp,
    int32_t *buckets) {
  __shared__ __align__(16) int32_t tree[MSM_BIG * 40];
  if ((int)blockIdx.x >= big[0]) return;
  int key = big[1 + blockIdx.x], j = threadIdx.x;
  msm_big_partial(key, j, offsets, part, tailp, tree);
  for (int half = MSM_BIG / 2; half > 0; half >>= 1) {
    __syncthreads();
    msm_big_round(j, half, tree);
  }
  if (j == 0) msm_big_store(key, tree, buckets);
}

// a wide tree level, warps 0-1 of a block the W of 64 nodes, warps 2-3
// their N: the first (`first`: levels 0 and 1, running sums over four
// buckets a node) with one more block that forms the B term on a quad,
// then level 2 from `in`
__global__ void __launch_bounds__(MSM_THREADS) msm_wide_kernel(
    int first, int t, const int *offsets, const int32_t *buckets, const int32_t *in,
    int32_t *out, const u32 *base8, const u8 *base, int32_t *bterm) {
  int q = blockIdx.x * (MSM_THREADS / 2) + threadIdx.x % (MSM_THREADS / 2);
  int role = threadIdx.x / (MSM_THREADS / 2);
  if ((int)blockIdx.x == (t + MSM_THREADS / 2 - 1) / (MSM_THREADS / 2)) {
    __shared__ u32 qx[PK_QUAD_WORDS];
    Quad qd{qx, (int)threadIdx.x / PK_GROUP, (int)threadIdx.x % PK_GROUP, 1, 0};
    u8 b[32];
    for (int k = 0; k < 32; k++) b[k] = base[k];
    ge r = qbase_mul_w8(qd, base8, b);
    if (threadIdx.x == 0) msm_store(bterm, 0, r);
    return;
  }
  if (q >= t) return;
  if (first) msm_leaf4(q, role, t, offsets, buckets, out);
  else msm_wide_node(q, role, t, in, out);
}

// a block a window, two quads (quad 0 the W of each node, quad 1 its N),
// a node a lane: the levels after the wide ones, from the window's
// MSM_JOIN nodes of level MSM_WIDE - 1 (in `a`, [2][ww · MSM_JOIN], which
// no block writes) to one, each level in the window's own part of `b`
// (msm_join_level: blocks run in no set order, so none may write where
// another reads); the window's W into wsum[w]
__global__ void __launch_bounds__(8 * PK_GROUP) msm_join_kernel(
    int ww, const int32_t *a, int32_t *b, int32_t *wsum) {
  __shared__ u32 qx[2][PK_QUAD_WORDS];
  int role = threadIdx.x / (4 * PK_GROUP), lane = threadIdx.x % PK_GROUP, w = blockIdx.x;
  Quad qd{qx[role], (int)(threadIdx.x / PK_GROUP) % 4, lane, 1 + role, 0};
  const int32_t *iw = a + (size_t)w * MSM_JOIN * 40, *in = a + ((size_t)ww + w) * MSM_JOIN * 40;
  for (int n = MSM_JOIN / 2; n >= 1; n >>= 1) {
    int32_t *ow = msm_join_level(b, w, n), *on = ow + (size_t)n * 40;
    for (int p = 0; p < n; p += PK_GROUP) {
      int q = p + lane;
      ge v = msm_join_node(role, q < n ? q : n - 1, iw, in, qd);
      if (q < n && qd.w == 0) msm_store(role ? on : ow, q, v);
    }
    __threadfence_block();
    __syncthreads();
    iw = ow;
    in = on;
  }
  if (threadIdx.x == 0) msm_store(wsum, w, msm_load(iw, 0));
}

// one warp: the Horner chain over the window sums and the B term, a field
// element over ten lanes (msm_horner_warp), then the identity test
__global__ void __launch_bounds__(32) msm_final_kernel(
    int ww, const int32_t *wsum, const int32_t *bterm, int32_t *total, int32_t *ident) {
  __shared__ __align__(16) int32_t sums[MSM_WMAX * 40];
  __shared__ __align__(16) int32_t tot[40];
  for (int k = threadIdx.x; k < ww * 40; k += 32) sums[k] = wsum[k];
  __syncwarp();
  msm_horner_warp(sums, ww, bterm, tot);
  __syncwarp();
  for (int k = threadIdx.x; k < 40; k += 32) total[k] = tot[k];
  if (threadIdx.x == 0) ident[0] = msm_identity(tot);
}

static cudaError_t launched() { return cudaGetLastError(); }

static int grid(int n) { return (n + MSM_THREADS - 1) / MSM_THREADS; }

// zero on entry: counts [ww * D], big [maxbig + 1]; ent and ekey [emax],
// part and tailp [nch][40] (nch = ceil(emax / MSM_CH)), buckets
// [ww * HALF][40], treea [2][ww * HALF / 2][40] and treeb [2][ww * HALF /
// 4][40] (the tree's levels in turns), wsum [ww][40], bterm [40]
extern "C" int pk_msm(int n, int n_small, int ws, int ww, const void *base8,
                      const void *points, const void *scalars, const void *base,
                      void *digits, void *counts, void *offsets, void *cursor, void *big,
                      void *ent, void *ekey, void *part, void *tailp, void *buckets,
                      void *treea, void *treeb, void *wsum, void *bterm, void *total,
                      void *ident, void *stream) {
  if (ww > MSM_WMAX || ws > ww) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MsmShape s{n, n_small, ws, ww};
  int m = ww * MSM_D;
  int emax = n_small * ws + (n - n_small) * ww;
  int nch = (emax + MSM_CH - 1) / MSM_CH;
  int maxbig = emax / ((MSM_SPAN - 1) * MSM_CH + 2);
  if (maxbig > m) maxbig = m;
  const int *off = (const int *)offsets;
  cudaError_t e;
  if (n > 0) {
    msm_recode_kernel<<<grid(n), MSM_THREADS, 0, st>>>(s, (const u8 *)scalars,
                                                      (int32_t *)digits, (int *)counts);
    if ((e = launched()) != cudaSuccess) return (int)e;
  }
  msm_scan_kernel<<<1, 1024, 0, st>>>(m, (const int *)counts, (int *)offsets,
                                      (int *)cursor);
  if ((e = launched()) != cudaSuccess) return (int)e;
  if (n > 0) {
    msm_scatter_kernel<<<grid(n), MSM_THREADS, 0, st>>>(
        s, (const int32_t *)digits, (int *)cursor, (u32 *)ent, (int *)ekey);
    if ((e = launched()) != cudaSuccess) return (int)e;
    msm_chunk_kernel<<<grid(nch), MSM_THREADS, 0, st>>>(
        nch, m, off, (const u32 *)ent, (const int *)ekey, (const int32_t *)points,
        (int32_t *)buckets, (int32_t *)part, (int32_t *)tailp);
    if ((e = launched()) != cudaSuccess) return (int)e;
    msm_span_kernel<<<grid(m), MSM_THREADS, 0, st>>>(
        m, off, (const int32_t *)part, (const int32_t *)tailp, (int32_t *)buckets,
        (int *)big);
    if ((e = launched()) != cudaSuccess) return (int)e;
  }
  if (maxbig > 0) {
    msm_big_kernel<<<maxbig, MSM_BIG, 0, st>>>((const int *)big, off,
                                               (const int32_t *)part,
                                               (const int32_t *)tailp, (int32_t *)buckets);
    if ((e = launched()) != cudaSuccess) return (int)e;
  }
  int32_t *ta = (int32_t *)treea, *tb = (int32_t *)treeb, *lin = nullptr;
  for (int lvl = 1; lvl < MSM_WIDE; lvl++) {
    int t = ww * (MSM_HALF >> (lvl + 1));
    int32_t *lout = lvl % 2 ? ta : tb;
    msm_wide_kernel<<<(t + MSM_THREADS / 2 - 1) / (MSM_THREADS / 2) + (lvl == 1), MSM_THREADS,
                      0, st>>>(lvl == 1, t, off, (const int32_t *)buckets, lin, lout,
                               (const u32 *)base8, (const u8 *)base, (int32_t *)bterm);
    if ((e = launched()) != cudaSuccess) return (int)e;
    lin = lout;
  }
  msm_join_kernel<<<ww, 8 * PK_GROUP, 0, st>>>(ww, lin, lin == ta ? tb : ta,
                                                (int32_t *)wsum);
  if ((e = launched()) != cudaSuccess) return (int)e;
  msm_final_kernel<<<1, 32, 0, st>>>(ww, (const int32_t *)wsum,
                                               (const int32_t *)bterm, (int32_t *)total,
                                               (int32_t *)ident);
  return (int)launched();
}

// Resident blocks per SM of the chunk phase, the launch that does most of
// the bucket additions.
extern "C" int pk_msm_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, msm_chunk_kernel, MSM_THREADS, 0);
}
