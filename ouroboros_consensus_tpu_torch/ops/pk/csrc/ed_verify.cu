// Kernel `ed_verify`: standalone RFC 8032 cofactorless Ed25519 verify of
// a batch of (A, R ‖ s, M), one verdict a lane: A decodes, s < L and
// s·B − h·A = R with h = SHA-512(R ‖ A ‖ M) mod L over each lane's own
// count of SHA-512 blocks (messages of any length in one batch).
// Replaces the plain-XLA verify of ouroboros_consensus_tpu/ops/ed25519_batch.py
// (verify_point, verify: the Byron signatures of the mixed-era composite and
// the standalone witness signatures of batched verification).
//
// Bound: operations (a lane moves under 1 KB through device memory): the
// twin's field work, 252,615 wide products a lane (R's decompression here
// takes the place of its P compression: one exponentiation each), over
// 132 SMs × 32 a clock × 1,980 MHz (0.65 ms at 21,600 lanes). What held the
// first version (ed's design, then P compressed on warp 0) at 4.5–5.1x that
// bound: P's compression, an inversion of ≈ 265 serial field operations on
// one warp while three waited, at the end of every block's dependent path;
// an idle warp in phase 1; and 255 registers a thread, so two blocks (8
// warps) an SM and waves of 264 blocks (8,448 lanes), the last of 21,600
// lanes 56 % full.
//
// The design (stages.cuh: VerifyScratch and the edv_* functions): 32 lanes
// a block on four warps. Phase 1 on all four, beside each other, each
// near one exponentiation long: the hash and s·B's windows 0 .. 9 (warp
// 0), A's decompression (warp 1), R's decompression (warp 2), s < L and
// windows 10 .. 24 (warp 3). Phase 2 on a quad of one exchange buffer
// (pk.cuh: Quad1): the two parts of s·B added, the table of −A (its seven
// additions on the quad, not on one warp), the h·(−A) chain, s·B's last 7
// windows walked onto the chain's point, the parts' sum added, and a
// projective compare with the decompressed R in one step (X_P = x_R·Z_P,
// Y_P = y_R·Z_P). Of two ways to take P's compression off the path, this
// one moves the inversion into R's decompression in phase 1, where one
// inversion a block (Montgomery's trick over the block's lanes) would
// still leave a product tree and a root inversion after the chain; the
// `ed_verify_stamps` build (EDV_STAMPS) still times the old tail on warp 0
// after the verdict, so chip_smoke.py reads both on the card. Sums and
// differences carry on 32-bit words (pk.cuh: fe_carry32), the same limbs
// in fewer instructions.
// 54 KB of shared memory a block (the table's 40 KB hold phase 1's part of
// s·B and −A, then the table; one exchange buffer; the other part of s·B),
// so the registers decide the blocks an SM: __launch_bounds__(128, 4)
// holds ptxas to 128 registers, 4 blocks, 16 warps and 128 lanes an SM.
// The chain's products are a dependent IMAD chain a warp, so the SM needs
// warps in flight more than registers a thread: 4 blocks, not the first
// version's 2 of 255 registers, with the spill stores in phase 1's
// exponentiations and none in the chain. Waves of 528 blocks (16,896
// lanes): 1.28 at 21,600 lanes, 3.88 at 65,536.
// Not used: tensor cores and TMA, for ed's reasons (a 25.5-bit limb product
// is one IMAD.WIDE; a lane's inputs are a few hundred bytes of coalesced
// limb-first columns).
#include "stages.cuh"

// the instrument build (ed_verify_stamps.cu): lane 0 of each warp stamps
// clock64 into [block][warp][EDV_NSTAMP]: 0 its start, 1 its phase-1
// role, 2 the parts' sum and the table of −A (with the block barrier's
// wait: none is stamped right after a wait, ptxas may read the clock
// before it), 3 the chain, 4 s·B's last windows and the addition, 5 the
// compare; then warp 0, after the verdict is stored and off the path,
// compresses P as the first version did: 6 its end, 7 the encoding's
// first and last bytes (so the compression is kept)
#define EDV_NSTAMP 8
#ifdef EDV_STAMPS
#define EDV_STAMP(k)                                                              \
  do {                                                                            \
    if (lane == 0)                                                                \
      stamps[((size_t)blockIdx.x * 4 + role) * EDV_NSTAMP + (k)] = clock64();     \
  } while (0)
#else
#define EDV_STAMP(k) ((void)0)
#endif

__global__ void __launch_bounds__(4 * PK_GROUP, 4) ed_verify_kernel(
    int B, const u32 *base8, const int32_t *pk, const int32_t *r, const int32_t *s,
    const int32_t *hb, int nb, const int32_t *hnb, int32_t *ok, u64 *stamps) {
  extern __shared__ __align__(16) u32 smem[];
  VerifyScratch &sc = *reinterpret_cast<VerifyScratch *>(smem);
  const int lane = threadIdx.x % PK_GROUP, role = threadIdx.x / PK_GROUP;
  const int i = blockIdx.x * PK_GROUP + lane;
  const bool live = i < B;
  const int ii = live ? i : B - 1;  // lanes past B run along for the barriers
  (void)stamps;
  EDV_STAMP(0);
  if (role == 0) {
    ed_role_hash(ii, B, lane, hb, nb, hnb, sc);
    edv_base_part(ii, B, lane, base8, s, 0, EDV_W0, edv_part0(sc));
  } else if (role == 1) {
    edv_role_a(ii, B, lane, pk, sc);
  } else if (role == 2) {
    edv_role_r(ii, B, lane, r, sc);
  } else {
    edv_role_s(ii, B, lane, base8, s, sc);
  }
  EDV_STAMP(1);
  __syncthreads();
  Quad1 qd{sc.qx, role, lane, 1, 0};
  edv_quad_table(sc, qd);
  EDV_STAMP(2);
  ge p = edv_quad_chain(sc, qd);
  EDV_STAMP(3);
  p = edv_quad_sb(ii, B, base8, s, p, sc, qd);
  EDV_STAMP(4);
  edv_quad_compare(i, live, p, sc, qd, ok);
  EDV_STAMP(5);
#ifdef EDV_STAMPS
  if (role == 0) {
    u8 enc[32];
    ge_compress_many(&p, 1, enc);
    EDV_STAMP(6);
    if (lane == 0)
      stamps[((size_t)blockIdx.x * 4) * EDV_NSTAMP + 7] = enc[0] | (u64)enc[31] << 8;
  }
#endif
}

static cudaError_t with_smem() {
  return cudaFuncSetAttribute(ed_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(VerifyScratch));
}

static int ed_verify_launch(int B, const void *base8, const void *pk, const void *r,
                            const void *s, const void *hb, int nb, const void *hnb, void *ok,
                            void *stamps, void *stream) {
  cudaError_t e = with_smem();
  if (e != cudaSuccess) return (int)e;
  ed_verify_kernel<<<(B + PK_GROUP - 1) / PK_GROUP, 4 * PK_GROUP, sizeof(VerifyScratch),
                     (cudaStream_t)stream>>>(
      B, (const u32 *)base8, (const int32_t *)pk, (const int32_t *)r, (const int32_t *)s,
      (const int32_t *)hb, nb, (const int32_t *)hnb, (int32_t *)ok, (u64 *)stamps);
  return (int)cudaGetLastError();
}

#ifdef EDV_STAMPS
// stamps: [ceil(B / 32)][4][EDV_NSTAMP] u64, zeroed by the caller
extern "C" int pk_ed_verify_stamps(int B, const void *base8, const void *pk, const void *r,
                                   const void *s, const void *hb, int nb, const void *hnb,
                                   void *ok, void *stamps, void *stream) {
  return ed_verify_launch(B, base8, pk, r, s, hb, nb, hnb, ok, stamps, stream);
}
#else
extern "C" int pk_ed_verify(int B, const void *base8, const void *pk, const void *r,
                            const void *s, const void *hb, int nb, const void *hnb,
                            void *ok, void *stream) {
  return ed_verify_launch(B, base8, pk, r, s, hb, nb, hnb, ok, nullptr, stream);
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_ed_verify_occupancy(int *blocks) {
  cudaError_t e = with_smem();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ed_verify_kernel, 4 * PK_GROUP, sizeof(VerifyScratch));
}
#endif
