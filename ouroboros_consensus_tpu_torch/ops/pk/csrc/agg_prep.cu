// Kernel `agg_prep`: the per-lane half of the window aggregate — the
// eight decompressions, the challenge digests, the KES Merkle walk, H and
// 8Γ with their compressions, c and β, the leader value and eta, the
// Fiat–Shamir coefficients and the mod-L products the MSM takes.
// Replaces the per-lane part of the plain-XLA aggregate_window of
// ouroboros_consensus_tpu/ops/pk/aggregate.py:232-326.
//
// Bound: operations — nine field exponentiations a lane (eight square
// roots, one Elligator2) and a block's one inversion, with the SHA-512
// and Blake2b compressions beside them (sixteen and ten on a bench
// window); no ladder. The design keeps a
// lane's dependent path near one exponentiation: a block is 32 lanes over
// ten warps, a role a warp (agg.cuh: AW_*). Eight warps decompress a key
// each; AW_H hashes to the curve; AW_HASH hashes the KES challenge and the
// transcript beside them, so z does not wait on any point. H and 8Γ are
// compressed with one inversion a block (Montgomery's trick as a product
// tree over the block's 64 Z coordinates in shared memory, the root
// inverted on AW_H's warp with a field element over ten lanes). Named
// barriers join only the warps that hand something on:
//
//   AB_ED        AW_AE's OCert digest   -> AW_HASH's transcript
//   AB_Z         AW_G's 8Γ leaves       -> AW_H's tree
//   AB_INV       the tree's inverses    -> AW_G's β
//   AB_C         AW_H's c               -> AW_G's z4·c
//   AB_COEF + r  AW_HASH's z            -> role r's products (AE, RE, V, RK, U, G, H)
//
// each a pair (the producer arrives, the one reader waits: a barrier
// completes only when all its warps are in), then one block barrier
// before the flag rows. __launch_bounds__(320, 2) holds ptxas to the
// registers of two blocks an SM: a full 8,192-lane window's 256 blocks
// run as one wave, 20 warps an SM.
//
// Warp w issues on the SM's sub-partition w mod 4, so which role a warp
// runs decides who shares issue slots with whom. A block alone on its SM
// (a small window) puts AW_H and AW_G, the two long paths, on the two
// sub-partitions that hold two warps, beside AW_HASH and AW_AL
// (AGG_ORDER row 1); with two blocks an SM the roles run in their own
// order, which loads the sub-partitions more evenly (the A/B of both
// orders: PERF.md §6).
// Not used: tensor cores and TMA, for the stage kernels' reasons (the
// field products are 32x32->64 IMADs; a lane's inputs are a few hundred
// bytes of coalesced limb-first columns).
#include "agg.cuh"

#define AGG_THREADS (AGG_WARPS * PK_GROUP)
// the role of warp w: with two blocks an SM (row 0), alone (row 1)
__constant__ int AGG_ORDER[2][AGG_WARPS] = {
    {AW_AE, AW_RE, AW_V, AW_AL, AW_RK, AW_Y, AW_U, AW_G, AW_H, AW_HASH},
    {AW_AE, AW_V, AW_H, AW_G, AW_RE, AW_U, AW_HASH, AW_AL, AW_RK, AW_Y}};
enum { AB_ED = 1, AB_Z, AB_INV, AB_C, AB_COEF };  // AB_COEF + role: 5 .. 13 of 16
#define AB_PAIR (2 * PK_GROUP)

PK_DEV void agg_bar_sync(int id, int n) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

PK_DEV void agg_bar_arrive(int id, int n) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// the instrument build (agg_stamps.cu): lane 0 of each warp stamps
// clock64 into [block][role][AGG_NSTAMP] after each of its steps; none
// right after a wait (ptxas may read the clock before the barrier), so a
// step that follows a wait includes it
#define AGG_NSTAMP 12
#ifdef AGG_STAMPS
#define AGG_STAMP(k)                                                              \
  do {                                                                            \
    if (lane == 0)                                                                \
      o.stamps[((size_t)blockIdx.x * AGG_WARPS + w) * AGG_NSTAMP + (k)] = clock64(); \
  } while (0)
#else
#define AGG_STAMP(k) ((void)0)
#endif

__global__ void __launch_bounds__(AGG_THREADS, 2) agg_prep_kernel(AggShape s, AggIn in,
                                                                  AggOut o) {
  __shared__ AggScratch sc;
  const int lane = threadIdx.x % PK_GROUP;
  const int w = AGG_ORDER[s.alone][threadIdx.x / PK_GROUP];  // the role
  const int i = blockIdx.x * PK_GROUP + lane;
  const bool live = i < s.B;
  const int ii = live ? i : s.B - 1;  // lanes past B run along for the barriers
  AGG_STAMP(0);
  if (w == AW_AE) {
    agg_ae_digest(ii, lane, s, in, sc);
    AGG_STAMP(1);
    agg_bar_arrive(AB_ED, AB_PAIR);
    agg_ae_point(ii, live, lane, s, in, o, sc);
    AGG_STAMP(2);
  } else if (w == AW_RE) {
    agg_re_point(ii, live, lane, s, in, o, sc);
  } else if (w == AW_V) {
    agg_decompress(AI_VRF_V, PT_V, OK_V, ii, live, lane, s, in, o, sc);
  } else if (w == AW_AL) {
    agg_al_point(ii, live, lane, s, in, o, sc);
  } else if (w == AW_RK) {
    agg_rk_point(ii, live, lane, s, in, o, sc);
  } else if (w == AW_Y) {
    agg_y_point(ii, live, lane, s, in, o, sc);
  } else if (w == AW_U) {
    agg_decompress(AI_VRF_U, PT_U, OK_U, ii, live, lane, s, in, o, sc);
  } else if (w == AW_G) {
    agg_g_point(ii, live, lane, s, in, o, sc);
    AGG_STAMP(1);
    agg_bar_arrive(AB_Z, AB_PAIR);
    agg_bar_sync(AB_INV, AB_PAIR);
    agg_g_beta(ii, lane, s, in, sc);
    AGG_STAMP(3);
    agg_bar_sync(AB_C, AB_PAIR);
  } else if (w == AW_H) {
    agg_h_point(ii, live, lane, s, in, o, sc);
    AGG_STAMP(1);
    agg_bar_sync(AB_Z, AB_PAIR);
    for (int n = PK_GROUP; n >= 1; n >>= 1) {
      if (lane < n) agg_tree_up(sc, n, lane);
      __syncwarp();
    }
    AGG_STAMP(3);
    agg_tree_invert(sc);
    __syncwarp();
    AGG_STAMP(4);
    for (int n = 1; n <= PK_GROUP; n <<= 1) {
      if (lane < n) agg_tree_down(sc, n, lane);
      __syncwarp();
    }
    AGG_STAMP(5);
    agg_bar_arrive(AB_INV, AB_PAIR);
    agg_h_challenge(ii, lane, s, in, sc);
    AGG_STAMP(6);
    agg_bar_arrive(AB_C, AB_PAIR);
  } else {  // AW_HASH
    agg_kes_digest(ii, lane, s, in, sc);
    AGG_STAMP(1);
    agg_bar_sync(AB_ED, AB_PAIR);
    agg_fs(ii, lane, s, in, sc);
    AGG_STAMP(3);
    const int readers[7] = {AW_AE, AW_RE, AW_V, AW_RK, AW_U, AW_G, AW_H};
    for (int r = 0; r < 7; r++) agg_bar_arrive(AB_COEF + readers[r], AB_PAIR);
  }
  if (w != AW_AL && w != AW_Y) {  // the products, once z is published
    if (w != AW_HASH) {
      AGG_STAMP(8);
      agg_bar_sync(AB_COEF + w, AB_PAIR);
    }
    agg_products(w, ii, live, lane, s, in, o, sc);
  }
  AGG_STAMP(10);
  __syncthreads();
  if (w == AW_HASH) agg_flags(ii, live, lane, s, o, sc);
  AGG_STAMP(11);
}

static int agg_prep_launch(int B, int depth, int nb_ed, int nb_kes, void *const *cols,
                           void *pts, void *scal, void *flags, void *eta, void *lv,
                           void *stamps, void *stream) {
  static int sms = 0;  // the card's SMs (one card a process)
  int dev = 0;
  if (sms == 0 && (cudaGetDevice(&dev) != 0 ||
                   cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0))
    return (int)cudaGetLastError();
  const int blocks = (B + PK_GROUP - 1) / PK_GROUP;
  AggShape s{B, depth, nb_ed, nb_kes, blocks <= sms ? 1 : 0};
  AggIn in;
  for (int k = 0; k < AI_N; k++) in.c[k] = (const int32_t *)cols[k];
  AggOut o{(int32_t *)pts, (u8 *)scal, (int32_t *)flags, (int32_t *)eta, (int32_t *)lv,
           (u64 *)stamps};
  agg_prep_kernel<<<blocks, AGG_THREADS, 0, (cudaStream_t)stream>>>(s, in, o);
  return (int)cudaGetLastError();
}

#ifdef AGG_STAMPS
// stamps: [ceil(B / 32)][AGG_WARPS][AGG_NSTAMP] u64, zeroed by the caller
extern "C" int pk_agg_prep_stamps(int B, int depth, int nb_ed, int nb_kes,
                                  void *const *cols, void *pts, void *scal, void *flags,
                                  void *eta, void *lv, void *stamps, void *stream) {
  return agg_prep_launch(B, depth, nb_ed, nb_kes, cols, pts, scal, flags, eta, lv, stamps,
                         stream);
}
#else
extern "C" int pk_agg_prep(int B, int depth, int nb_ed, int nb_kes,
                           void *const *cols, void *pts, void *scal,
                           void *flags, void *eta, void *lv, void *stream) {
  return agg_prep_launch(B, depth, nb_ed, nb_kes, cols, pts, scal, flags, eta, lv, nullptr,
                         stream);
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_agg_prep_occupancy(int *out) {
  return pk_occupancy((const void *)agg_prep_kernel, AGG_THREADS, 0, out);
}

// The same kernel's registers, local bytes, static shared bytes and
// max threads a block (obs/resources.py).
extern "C" int pk_agg_prep_attributes(int *out) {
  return pk_func_attributes((const void *)agg_prep_kernel, out);
}
#endif
