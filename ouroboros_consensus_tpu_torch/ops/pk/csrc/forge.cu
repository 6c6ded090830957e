// The forge's two kernels (csrc/forge.cuh has their lane bodies):
//
//   forge_sweep — the leader-election sweep of one election window, one
//                 lane per (slot, pool) pair. Replaces the plain-XLA
//                 `forge_sweep` of ouroboros_consensus_tpu/protocol/
//                 forge.py:91 (ops/ecvrf_batch.alpha_from_slots, :83;
//                 hash_to_curve, :130; prove, :265; the leader bracket).
//   ed_sign     — Ed25519 signing of the window's deduplicated OCert
//                 signables, 32 a block. Replaces the plain-XLA
//                 `forge_sign` of protocol/forge.py:125 (ops/
//                 ed25519_batch.sign, :140).
//
// Bound: operations. A prove is two 65-digit variable-base ladders (x·H,
// k·H), a 32-add fixed-base walk (k·B), the Elligator2 exponentiation,
// H's inversion and the finish's compressions: 463,980 wide products a
// lane (the twin's count, which hashes to the curve once), over 132 SMs ×
// 32 a clock × 1,980 MHz (0.91 ms at a full election window of 16,384
// lanes). What held the first
// version at 3.9x that bound: two warps a block, each hashing to the
// curve and building its own table of H in local memory (3,632 bytes of
// stack), one whole ladder on each, and the k warp also compressing H,
// deriving k, walking k·B and running the finish (272,460 of a lane's
// 463,980 products on one thread's dependent path), at 8 warps an SM.
//
// The sweep's design (forge.cuh): 32 lanes a block over four warps, two
// pairs (pk.cuh: Pair, two of each point operation's four products a warp,
// so each ladder's dependent path is near half a one-thread ladder's).
// Warp 0 hashes to the curve once a lane; pair A builds the one table of H
// in shared memory (LaneTab), which both ladders read, while warp 2
// compresses H and derives k. Pair A then runs part of k·B, Γ = x·H and
// 8Γ, pair B k·H and the rest of k·B beside it. The finish compresses the lane's four points on one
// inversion a block: a product tree over the block's 32 lanes in shared
// memory, its root inverted by the whole of warp 0 (a field element over
// ten lanes), then the challenge and s on warp 0 beside β and the leader
// value on warp 1. H's compression takes its inversion from a product
// tree over the block's lanes too (warp 2, beside the table), and k·B is
// split between the pairs (pair A's first FS_KA windows before x·H, pair
// B's rest walked onto them after k·H), so the two pairs end together. The dependent path:
// the hash to the curve, the table, a ladder and half the walk, the
// tree, the challenge.
// Barriers: __syncthreads after H and after the ladders; named barriers
// between the warps that hand something on (FS_BAR_*: the producer
// arrives, its readers wait). Sums and differences carry on 32-bit words
// (pk.cuh: fe_carry32). 56 KB of shared memory a block (one exchange
// buffer a pair; the finish's tree, points and encodings in the table's
// space once both ladders are done), so the registers decide the blocks an
// SM: __launch_bounds__(128, 4) holds ptxas to 128 registers, 4 blocks, 16
// warps and 128 lanes an SM, its spill stores in the one-time
// exponentiations, none in the ladders: the ladders' products are
// dependent IMAD chains, so warps in flight count more than registers a
// thread, and at 4 a full window is one wave (16,384 lanes, 512 blocks of
// the 528 resident).
// Not used: tensor cores and TMA, for the reasons pk.cuh gives.
#include "forge.cuh"

// named barrier helpers: a producer arrives, its readers wait
PK_DEV void fs_arrive(int id, int n) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

PK_DEV void fs_sync(int id, int n) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// the instrument build (forge_stamps.cu): lane 0 of each warp stamps
// clock64 into [block][warp][FS_NSTAMP] after each of its steps, none
// right after a wait (ptxas may read the clock before it), so a step
// after a wait includes it: 0 start; warp 0: 1 H; pair A: 2 the table of
// H (with the wait for H), 3 its part of k·B (with the wait for k), 4 Γ
// and 8Γ; warp 2: 2 H's tree and k; pair B: 3 V = k·H (with the wait for
// the table and k), 5 the rest of k·B; warp 0: 8 the pairs' wait, the
// points stored, the leaves and the tree, 9 the encodings, 10 c and s;
// warp 1: 10 β and the leader value
#define FS_NSTAMP 11
#ifdef FS_STAMPS
#define FS_STAMP(k)                                                               \
  do {                                                                            \
    if (lane == 0)                                                                \
      stamps[((size_t)blockIdx.x * 4 + role) * FS_NSTAMP + (k)] = clock64();      \
  } while (0)
#else
#define FS_STAMP(k) ((void)0)
#endif

__global__ void __launch_bounds__(4 * PK_GROUP, 4) forge_sweep_kernel(
    ForgeArgs a, const u32 *base8, u64 *stamps) {
  extern __shared__ __align__(16) u32 smem[];
  ForgeScratch &sc = *reinterpret_cast<ForgeScratch *>(smem);
  const int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  const int i = blockIdx.x * PK_GROUP + lane;
  const bool live = i < a.B;
  const int ii = live ? i : a.B - 1;  // lanes past B run along for the barriers
  (void)stamps;
  FS_STAMP(0);
  if (role == 0) {
    fs_role_h(ii, lane, a, sc);
    FS_STAMP(1);
  }
  __syncthreads();
  ge g, g8, v;
  if (role < 2) {
    Pair pa{sc.x[0], role, lane, FS_BAR_A, 0};
    fs_pair_table(lane, sc, pa);
    FS_STAMP(2);
    fs_arrive(FS_BAR_TAB, 4 * PK_GROUP);
    fs_sync(FS_BAR_K, 3 * PK_GROUP);  // k, and warp 2 done with U's space
    fs_pair_ua(lane, base8, sc, pa);
    FS_STAMP(3);
    fs_arrive(FS_BAR_U, 4 * PK_GROUP);
    fs_pair_gamma(ii, lane, a, sc, pa, g, g8);
    FS_STAMP(4);
  } else {
    if (role == 2) {
      fs_k_leaf(lane, sc);
      fs_tree(sc.ht.node, lane);
      fs_k_derive(ii, lane, a, sc);
      FS_STAMP(2);
      fs_arrive(FS_BAR_K, 3 * PK_GROUP);
    }
    fs_sync(FS_BAR_TAB, 4 * PK_GROUP);  // the table, and k
    Pair pb{sc.x[1], role - 2, lane, FS_BAR_B, 0};
    v = fs_pair_v(lane, sc, pb);
    FS_STAMP(3);
    fs_sync(FS_BAR_U, 4 * PK_GROUP);  // pair A's part of k·B
    fs_pair_u(lane, base8, sc, pb);
    FS_STAMP(5);
  }
  __syncthreads();  // both pairs done: no warp reads the table now
  if (role == 0) {
    fs_put_xyz(sc.fin.pts[0], lane, g);
    fs_put_xyz(sc.fin.pts[2], lane, g8);
  } else if (role == 2) {
    fs_put_xyz(sc.fin.pts[1], lane, v);
  }
  __syncthreads();
  if (role == 0) {
    fs_leaf(lane, sc);
    fs_tree(sc.fin.node, lane);
    FS_STAMP(8);
    fs_compress(lane, sc);
    FS_STAMP(9);
    fs_arrive(FS_BAR_FIN, 2 * PK_GROUP);
    if (live) fs_challenge(i, lane, a, sc);
    FS_STAMP(10);
  } else if (role == 1) {
    fs_sync(FS_BAR_FIN, 2 * PK_GROUP);
    if (live) fs_beta(i, lane, a, sc);
    FS_STAMP(10);
  }
}

// ed_sign (forge.cuh: es_*): 32 signables a block on eight warps. A
// signable's chain is its two hashes, R = r·B and R's inversion, so one
// signable on one thread (the first version) left 131 SMs idle and paced
// the launch by a 32-add walk and a 265-step inversion on one thread.
// Bound: the dependent path (a launch of a few signables is 1e-5 of the
// card's products), not throughput. What the design does about it:
// R = r·B on a team of eight threads a signable, four windows a thread
// and a pairwise sum in three levels (the walk's 32 dependent additions
// become 3 + 3, the entries loaded a step ahead and added as affine
// points: 8 products), four teams a warp; a warp whose slots all lie
// past B skips the walk, so at two signables warp 0 has its scheduler to
// itself (a thread's additions are paced by its scheduler's issue of
// products: a second chain a thread gained nothing, and four threads a
// signable with every warp walking were 1.09x slower at two signables
// on an H100, equal at 256 and 4,096). R's Z is inverted once a block
// (a tree over the block's 32 signables, the root on warp 0 as a field
// element over ten lanes: w_inv, ≈ 0.11 µs a step where a one-thread
// step took ≈ 0.35). The hashes and the mod-L tail stay on a thread a
// signable (a compression's 80 rounds are one chain), h's message staged
// in shared memory by warps 1-7 while warp 0 hashes r, so that h's hash
// waits on R alone. Issue slots, in a warp's wide products a full block
// of 32 signables: the walk 44,000 (eight warps of 55: 3 additions of 8,
// the entries' 2d·T, the team's 3 additions of 9, most lanes idle in the
// levels) where one warp took 28,800 (32 additions of 9); R's inversion
// about 3,200 (the tree and w_inv's 265 steps at about six products a
// lane) where the first version's one-thread inversions took 15,070:
// 47,200 against 44,070 in all, 7 % more, which shows once the blocks
// fill every SM (past 4,224 signables; no path launches so many). The
// block counts are checked on the card (bad[], read by the wrapper after
// the launch), so nothing is read back before it. Not used: tensor
// cores, TMA, wgmma (10 × 25.5-bit limbs on 32×32 → 64-bit products,
// pk.cuh); shared memory holds the staged message, the teams' exchange
// and the tree. Teams of 16 or 32 do not fit this body: 512 threads cap
// a thread at 128 registers against its 190, and their exchange takes
// the static shared memory past 48 KB.
__global__ void __launch_bounds__(ES_THREADS, 1) ed_sign_kernel(SignArgs a, u64 *stamps) {
  __shared__ __align__(16) SignScratch sc;
  const int t = threadIdx.x, lane = t % PK_GROUP, g = blockIdx.x * PK_GROUP;
  (void)stamps;
  if (t < PK_GROUP) {
    const bool bad = es_r(lane, g, a, sc, stamps);
    const bool any = __any_sync(0xffffffffu, bad);
    if (lane == 0) a.bad[blockIdx.x] = any ? 1 : 0;
  } else {
    es_stage(t - PK_GROUP, g, a, sc);
  }
  __syncthreads();  // r, and h's staged blocks
  ge p = ge_identity();
  if (es_warp_live(t, g, a.B)) {  // uniform over the warp
    p = es_walk(t, a.base8, sc);
#pragma unroll 1
    for (int d = 1; d < ES_TEAM; d <<= 1) {  // a team's lanes lie in one warp
      es_level_put(t, d, p, sc);
      __syncwarp();
      es_level_add(t, d, p, sc);
      __syncwarp();
    }
  }
  const int s = t / ES_TEAM;
  if (t % ES_TEAM == 0) {
    es_publish(s, p, sc);
    ES_STAMP(g + s < a.B, g + s, 3, p.z.v[0]);
  }
  __syncthreads();  // every R's X, Y, Z and leaf
  if (t >= PK_GROUP) return;
  fs_tree(sc.node, lane);
  es_finish(lane, g, a, sc, stamps);
}

static int ed_sign_launch(int B, int NB, const void *base8, const void *a, const void *aenc,
                          const void *rblocks, const void *rnb, const void *hblocks,
                          const void *hnb, void *out, void *bad, void *stamps, void *stream) {
  SignArgs sa{B, NB, (const u32 *)base8, (const u8 *)a, (const u8 *)aenc,
              (const u8 *)rblocks, (const int32_t *)rnb, (const u8 *)hblocks,
              (const int32_t *)hnb, (u8 *)out, (int32_t *)bad};
  ed_sign_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, ES_THREADS, 0, (cudaStream_t)stream>>>(
      sa, (u64 *)stamps);
  return (int)cudaGetLastError();
}

static cudaError_t sweep_smem() {
  return cudaFuncSetAttribute(forge_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(ForgeScratch));
}

static int forge_sweep_launch(int B, int P, long long slot0, const void *base8,
                              const void *pools, const void *nonce, void *out, void *stamps,
                              void *stream) {
  cudaError_t e = sweep_smem();
  if (e != cudaSuccess) return (int)e;
  ForgeArgs a{B, P, (int64_t)slot0, (const u8 *)pools, (const u8 *)nonce, (u8 *)out};
  forge_sweep_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 4 * PK_GROUP, sizeof(ForgeScratch),
                       (cudaStream_t)stream>>>(a, (const u32 *)base8, (u64 *)stamps);
  return (int)cudaGetLastError();
}

#if defined(ES_STAMPS)
// stamps: [B][ES_NSTAMP] u64, zeroed by the caller
extern "C" int pk_ed_sign_stamps(int B, int NB, const void *base8, const void *a,
                                 const void *aenc, const void *rblocks, const void *rnb,
                                 const void *hblocks, const void *hnb, void *out, void *bad,
                                 void *stamps, void *stream) {
  return ed_sign_launch(B, NB, base8, a, aenc, rblocks, rnb, hblocks, hnb, out, bad, stamps,
                        stream);
}
#elif defined(FS_STAMPS)
// stamps: [ceil(B / 32)][4][FS_NSTAMP] u64, zeroed by the caller
extern "C" int pk_forge_sweep_stamps(int B, int P, long long slot0, const void *base8,
                                     const void *pools, const void *nonce, void *out,
                                     void *stamps, void *stream) {
  return forge_sweep_launch(B, P, slot0, base8, pools, nonce, out, stamps, stream);
}
#else
extern "C" int pk_forge_sweep(int B, int P, long long slot0, const void *base8,
                              const void *pools, const void *nonce, void *out,
                              void *stream) {
  return forge_sweep_launch(B, P, slot0, base8, pools, nonce, out, nullptr, stream);
}

extern "C" int pk_ed_sign(int B, int NB, const void *base8, const void *a,
                          const void *aenc, const void *rblocks, const void *rnb,
                          const void *hblocks, const void *hnb, void *out, void *bad,
                          void *stream) {
  return ed_sign_launch(B, NB, base8, a, aenc, rblocks, rnb, hblocks, hnb, out, bad, nullptr,
                        stream);
}

// Resident blocks per SM of the sweep, the source's heavier kernel.
extern "C" int pk_forge_occupancy(int *blocks) {
  cudaError_t e = sweep_smem();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, forge_sweep_kernel, 4 * PK_GROUP, sizeof(ForgeScratch));
}

extern "C" int pk_ed_sign_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ed_sign_kernel, ES_THREADS,
                                                            0);
}
#endif
