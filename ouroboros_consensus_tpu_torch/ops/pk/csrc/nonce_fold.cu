// Kernel `nonce_fold`: the window's sequential Praos nonce fold, from a
// carry-in to a carry-out, over the lanes' eta, which it derives itself
// from the header's declared VRF output β (wire.cuh: fold_produce,
// fold_step). Replaces the plain-XLA reduce stage's
// ouroboros_consensus_tpu/ops/blake2b.py:nonce_fold_scan (in
// protocol/batch.py:verdict_reduce; ops/pk/kernels.py:_mk_reduce).
//
// Bound: operations, in one dependent chain: each lane's Blake2b-256
// compression hashes the evolving nonce the lane before produced, so no
// two of them overlap (kernels.B2B_CHAIN_INSTRUCTIONS a compression).
// Design: one block of four warps. Warp 0 runs the chain, a compression's
// four G columns (then diagonals) on four lanes with shuffles between
// (wire.cuh, b2b_compress4); lanes 4..31 repeat the group and hold the
// message words. Warps 1-3, on the SM's other three schedulers, produce
// the etas, two compressions a lane on one thread each (b2b_256_1),
// independent across lanes: chunk c of 32 lanes by warp 1 + c % 3, into
// a ring of six slots in shared memory guarded by mbarriers (full: the
// producing warp's 32 threads arrive; empty: the chain's lane 0 arrives).
// So the chain waits for no global load: a lane's eta comes from shared
// memory. A whole compression on one thread (b2b_256_1 in the chain's
// place) measured 1.6x slower at 8,192 lanes: 1,777 of its 2,061
// instructions go to the integer pipe, which takes a warp instruction
// every two cycles, where four lanes split them (PERF.md, section 6).
#include "wire.cuh"

__global__ void __launch_bounds__(128, 1) nonce_fold_kernel(
    int B, int n_real, const int32_t *beta, const u8 *within, const u8 *cin,
    u8 *cout) {
  __shared__ FoldRing ring;
  __shared__ u64 full[FOLD_SLOTS], empty[FOLD_SLOTS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    for (int s = 0; s < FOLD_SLOTS; s++) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 1);
    }
  __syncthreads();
  const int chunks = (n_real + FOLD_CHUNK - 1) / FOLD_CHUNK;
  if (warp == 0) {
    const B2bCols init = b2b_init4(lane & 3);
    FoldState st = fold_load(cin, lane & 3);
#pragma unroll 1
    for (int c = 0; c < chunks; c++) {
      const int s = c % FOLD_SLOTS;
      mbar_wait(&full[s], (c / FOLD_SLOTS) & 1);
      const int n = min(FOLD_CHUNK, n_real - c * FOLD_CHUNK);
#pragma unroll 1
      for (int l = 0; l < n; l++) fold_step(st, init, ring, s, l, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (lane < 4) fold_store(st, cout);
    return;
  }
#pragma unroll 1
  for (int c = warp - 1; c < chunks; c += FOLD_PRODUCERS) {
    const int s = c % FOLD_SLOTS;
    if (c >= FOLD_SLOTS) mbar_wait(&empty[s], (c / FOLD_SLOTS - 1) & 1);
    const int i = c * FOLD_CHUNK + lane;
    if (i < n_real) fold_produce(beta, within, B, i, ring, s, lane);
    mbar_arrive(&full[s]);
  }
}

extern "C" int pk_nonce_fold(int B, int n_real, const void *beta,
                             const void *within, const void *cin, void *cout,
                             void *stream) {
  nonce_fold_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      B, n_real, (const int32_t *)beta, (const u8 *)within, (const u8 *)cin,
      (u8 *)cout);
  return (int)cudaGetLastError();
}

// Instrument: `reps` dependent steps on one warp, timed in SM cycles
// (clock64) by lane 0. Modes 0-2 are chains of compressions of the
// fold's form, ev <- Blake2b-256(ev ‖ e): 0 on one thread (b2b_256_1),
// 1 on one thread through pk.cuh's looped blake2b_256 (bytes in and out:
// the stage kernels' hash), 2 on four lanes (b2b_compress4, the
// chain's). Modes 3 and 4 split the four-lane
// compression's critical path: 3 runs its 24 dependent G steps on one
// lane with no exchange, 4 its 24 exchanges (a 64-bit shuffle within the
// group, each the step before's result). in: ev ‖ e (8 words); out: the
// last ev (4 words); cycles: [1].
template <int MODE>
__global__ void b2b_bench_kernel(int reps, const u64 *in, u64 *out,
                                 long long *cycles) {
  const int lane = threadIdx.x & 31, col = lane & 3, k = lane & 15;
  if (MODE < 2 && lane != 0) return;
  u64 ev[4], e[4];
  for (int j = 0; j < 4; j++) {
    ev[j] = in[j];
    e[j] = in[4 + j];
  }
  const B2bCols init = b2b_init4(col);
  u64 w = ev[col];
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
    if (MODE == 0) {
      b2b_combine(ev, e);
    } else if (MODE == 1) {
      u8 msg[64], dg[32];
      for (int j = 0; j < 4; j++) {
        word_bytes(msg, j, ev[j]);
        word_bytes(msg + 32, j, e[j]);
      }
      blake2b_256(msg, 64, dg);
      for (int j = 0; j < 4; j++) ev[j] = bytes_word(dg, j);
    } else if (MODE == 2) {
      const u64 mw = k < 4 ? w : k < 8 ? e[k - 4] : 0;
      b2b_compress4(init, nullptr, mw, &w);
    } else if (MODE == 3) {
#pragma unroll
      for (int g = 0; g < 24; g++) b2b_g1(ev[0], ev[1], ev[2], ev[3], e[0], e[1]);
    } else {
#pragma unroll
      for (int g = 0; g < 24; g++) w = __shfl_sync(0xffffffffu, w, (lane + 1) & 3, 4);
    }
  }
  const long long t1 = clock64();
  if (MODE >= 2) {
    if (lane < 4) out[lane] = w;
  } else if (lane == 0) {
    for (int j = 0; j < 4; j++) out[j] = ev[j];
  }
  if (MODE == 3 && lane == 0) out[0] = ev[0] ^ ev[1] ^ ev[2] ^ ev[3];
  if (lane == 0) cycles[0] = t1 - t0;
}

extern "C" int pk_b2b_bench(int reps, int mode, const void *in, void *out,
                            void *cycles, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const u64 *i = (const u64 *)in;
  u64 *o = (u64 *)out;
  long long *c = (long long *)cycles;
  switch (mode) {
    case 0: b2b_bench_kernel<0><<<1, 32, 0, s>>>(reps, i, o, c); break;
    case 1: b2b_bench_kernel<1><<<1, 32, 0, s>>>(reps, i, o, c); break;
    case 2: b2b_bench_kernel<2><<<1, 32, 0, s>>>(reps, i, o, c); break;
    case 3: b2b_bench_kernel<3><<<1, 32, 0, s>>>(reps, i, o, c); break;
    case 4: b2b_bench_kernel<4><<<1, 32, 0, s>>>(reps, i, o, c); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_nonce_fold_occupancy(int *out) {
  return pk_occupancy((const void *)nonce_fold_kernel, 128, 0, out);
}

// The same kernel's registers, local bytes, static shared bytes and
// max threads a block (obs/resources.py).
extern "C" int pk_nonce_fold_attributes(int *out) {
  return pk_func_attributes((const void *)nonce_fold_kernel, out);
}
