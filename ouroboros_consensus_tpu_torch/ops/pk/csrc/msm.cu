// Kernel `msm`: the window aggregate's shared signed-digit bucket
// machine, Σ k_i·P_i + b·B and the exact identity test. Replaces the
// plain-XLA msm_shared of ouroboros_consensus_tpu/ops/pk/msm.py:381 (its
// argsort bucketing, chunked segment scans, Abel pass and Horner walk) and
// the B term's fixed-base mul (aggregate.py:304).
//
// Bound: operations — the bucket additions (one a nonzero digit: 11
// windows over the 128-bit group, 22 over the wide one; 9 field products
// each) — and, at a replay window's size, the dependent path of the
// joins: a segment's 128 additions, a window's 96, the 273 steps of the
// Horner chain. Six launches of this source on one stream, the bucketing
// by counts, a scan and atomics (no sort):
//   1. recode, a thread a point: balanced 12-bit digits, a count per
//      (window, |digit|) for each nonzero digit (digit 0 weighs nothing);
//   2. one block: the exclusive scan of the counts;
//   3. scatter, a thread a point: its index (sign in bit 31) into each of
//      its buckets at the next free place (atomicAdd on a cursor);
//   4. a thread a bucket: the sum of its entries (any order: the points
//      are exact, only their projective coordinates differ);
//   5. a thread a segment of 64 buckets: its running sums from the top;
//   6. one block: a thread a window joins its 32 segments (summation by
//      parts), a thread of its own forms the B term from the fixed-base
//      table, then thread 0 runs the Horner chain, adds the B term and
//      tests X = 0 and Y = Z.
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

// exclusive scan of counts[m] -> offsets[m + 1] and the scatter's
// cursor; the buckets of more than MSM_SMALL entries listed in big[1..]
// (big[0] their count, zero on entry)
__global__ void __launch_bounds__(1024) msm_scan_kernel(
    int m, const int *counts, int *offsets, int *cursor, int *big) {
  __shared__ int part[1024];
  int t = threadIdx.x, per = (m + 1023) / 1024;
  int lo = t * per, hi = lo + per < m ? lo + per : m;
  int sum = 0;
  for (int i = lo; i < hi; i++) {
    sum += counts[i];
    if (counts[i] > MSM_SMALL) big[1 + atomicAdd(big, 1)] = i;
  }
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int base = t ? part[t - 1] : 0;
  for (int i = lo; i < hi; i++) {
    offsets[i] = base;
    cursor[i] = base;
    base += counts[i];
  }
  if (t == 1023) offsets[m] = part[1023];
}

__global__ void __launch_bounds__(MSM_THREADS) msm_scatter_kernel(
    MsmShape s, const int32_t *digits, int *cursor, u32 *ent) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < s.n) msm_scatter(p, s, digits, cursor, ent);
}

__global__ void __launch_bounds__(MSM_THREADS) msm_bucket_kernel(
    int nb, const int32_t *pts, const int *offsets, const u32 *ent, int32_t *buckets) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nb) msm_bucket(t, pts, offsets, ent, buckets);
}

// a block a listed bucket; the grid is the list's bound, the blocks past
// its length return at once
__global__ void __launch_bounds__(MSM_BIG) msm_big_kernel(
    const int *big, const int32_t *pts, const int *offsets, const u32 *ent,
    int32_t *buckets) {
  __shared__ int32_t tree[MSM_BIG * 40];
  if ((int)blockIdx.x >= big[0]) return;
  int key = big[1 + blockIdx.x], j = threadIdx.x;
  msm_big_partial(key, j, pts, offsets, ent, tree);
  for (int half = MSM_BIG / 2; half > 0; half >>= 1) {
    __syncthreads();
    msm_big_round(j, half, tree);
  }
  if (j == 0) msm_big_store(key, tree, buckets);
}

// 32 segments a block, each on a quad of the block's four warps
__global__ void __launch_bounds__(4 * PK_GROUP) msm_segment_kernel(
    int nseg, const int32_t *buckets, int32_t *segs) {
  __shared__ u32 qx[PK_QUAD_WORDS];
  int lane = threadIdx.x % PK_GROUP, t = blockIdx.x * PK_GROUP + lane;
  Quad qd{qx, (int)(threadIdx.x / PK_GROUP), lane, 1, 0};
  msm_segment(t < nseg ? t : nseg - 1, t < nseg, nseg, buckets, segs, qd);
}

// one block, a quad: lane w joins window w's segments; then every lane
// the B term and the Horner chain, lane 0 of warp 0 stores
__global__ void __launch_bounds__(4 * PK_GROUP) msm_final_kernel(
    int ww, const u32 *base8, const u8 *base, const int32_t *segs,
    int32_t *total, int32_t *ident) {
  __shared__ u32 qx[PK_QUAD_WORDS];
  __shared__ int32_t sums[MSM_WMAX * 40];
  int lane = threadIdx.x % PK_GROUP, wp = threadIdx.x / PK_GROUP;
  Quad qd{qx, wp, lane, 1, 0};
  ge s = msm_window(lane < ww ? lane : ww - 1, ww * MSM_NSEG, segs, qd);
  if (wp == 0 && lane < ww) msm_store(sums, lane, s);
  __syncthreads();
  u8 b[32];
  for (int k = 0; k < 32; k++) b[k] = base[k];
  ge bterm = qbase_mul_w8(qd, base8, b), tot;
  bool id = msm_horner(sums, ww, bterm, tot, qd);
  if (threadIdx.x == 0) {
    msm_store(total, 0, tot);
    ident[0] = id ? 1 : 0;
  }
}

static cudaError_t launched() { return cudaGetLastError(); }

extern "C" int pk_msm(int n, int n_small, int ws, int ww, const void *base8,
                      const void *points, const void *scalars, const void *base,
                      void *digits, void *counts, void *offsets, void *cursor,
                      void *big, void *ent, void *buckets, void *segs, void *total,
                      void *ident, void *stream) {
  if (ww > MSM_WMAX || ws > ww) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MsmShape s{n, n_small, ws, ww};
  int m = ww * MSM_D, nb = ww * MSM_HALF, nseg = ww * MSM_NSEG;
  int gp = (n + MSM_THREADS - 1) / MSM_THREADS;
  int entries = n_small * ws + (n - n_small) * ww;
  int maxbig = entries / (MSM_SMALL + 1) < m ? entries / (MSM_SMALL + 1) : m;
  cudaError_t e;
  if (n > 0) {
    msm_recode_kernel<<<gp, MSM_THREADS, 0, st>>>(s, (const u8 *)scalars,
                                                 (int32_t *)digits, (int *)counts);
    if ((e = launched()) != cudaSuccess) return (int)e;
  }
  msm_scan_kernel<<<1, 1024, 0, st>>>(m, (const int *)counts, (int *)offsets,
                                      (int *)cursor, (int *)big);
  if ((e = launched()) != cudaSuccess) return (int)e;
  if (n > 0) {
    msm_scatter_kernel<<<gp, MSM_THREADS, 0, st>>>(s, (const int32_t *)digits,
                                                  (int *)cursor, (u32 *)ent);
    if ((e = launched()) != cudaSuccess) return (int)e;
  }
  msm_bucket_kernel<<<(nb + MSM_THREADS - 1) / MSM_THREADS, MSM_THREADS, 0, st>>>(
      nb, (const int32_t *)points, (const int *)offsets, (const u32 *)ent,
      (int32_t *)buckets);
  if ((e = launched()) != cudaSuccess) return (int)e;
  if (maxbig > 0) {
    msm_big_kernel<<<maxbig, MSM_BIG, 0, st>>>(
        (const int *)big, (const int32_t *)points, (const int *)offsets,
        (const u32 *)ent, (int32_t *)buckets);
    if ((e = launched()) != cudaSuccess) return (int)e;
  }
  msm_segment_kernel<<<(nseg + PK_GROUP - 1) / PK_GROUP, 4 * PK_GROUP, 0, st>>>(
      nseg, (const int32_t *)buckets, (int32_t *)segs);
  if ((e = launched()) != cudaSuccess) return (int)e;
  msm_final_kernel<<<1, 4 * PK_GROUP, 0, st>>>(ww, (const u32 *)base8, (const u8 *)base,
                                               (const int32_t *)segs, (int32_t *)total,
                                               (int32_t *)ident);
  return (int)launched();
}

// Resident blocks per SM of the bucket phase, the launch with the most
// blocks of the seven.
extern "C" int pk_msm_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, msm_bucket_kernel, MSM_THREADS, 0);
}
