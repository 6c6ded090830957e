// Kernel `nonce_fold`: the window's sequential Praos nonce fold over the
// finish kernel's eta column, from a carry-in to a carry-out (wire.cuh,
// nonce_fold_chain). Replaces the plain-XLA reduce stage's
// ouroboros_consensus_tpu/ops/blake2b.py:nonce_fold_scan (in
// protocol/batch.py:verdict_reduce; ops/pk/kernels.py:_mk_reduce).
//
// Bound: operations, in one dependent chain: each lane's Blake2b-256
// compression hashes the evolving nonce the lane before produced, so no
// two compressions of a window overlap, and the window runs on one warp.
// Design: a compression's four G columns (then its four diagonals) are
// independent, so four lanes of the warp run one each (wire.cuh,
// b2b_compress4), exchanging the state's b, c, d words with shuffles
// between the column and diagonal steps; a lane issues a quarter of the
// G work and the shuffles, 772 instructions a compression against the
// function's 532-instruction chain (kernels.B2B_CHAIN_INSTRUCTIONS), and
// the chain is 24 G steps and 48 shuffles deep. The rounds are
// unrolled with the message schedule as compile-time constants, message
// words are read from the lanes that hold them with a shuffle, and the
// next lane's eta is loaded while the current one is hashed. The other
// 28 lanes of the warp repeat the group's work and hold message words.
#include "wire.cuh"

__global__ void __launch_bounds__(32) nonce_fold_kernel(
    int B, int n_real, const int32_t *eta, const u8 *within, const u8 *cin,
    u8 *cout) {
  nonce_fold_chain(B, n_real, eta, within, cin, cout, threadIdx.x);
}

extern "C" int pk_nonce_fold(int B, int n_real, const void *eta,
                             const void *within, const void *cin, void *cout,
                             void *stream) {
  nonce_fold_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      B, n_real, (const int32_t *)eta, (const u8 *)within, (const u8 *)cin,
      (u8 *)cout);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel the wrapper launches.
extern "C" int pk_nonce_fold_occupancy(int *blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, nonce_fold_kernel, 32, 0);
}
