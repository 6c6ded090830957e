// Per-lane bodies of the packed window's two wire kernels:
//
//   unpack.cu     — the packed columns (stage_packed's wire format) ->
//                   every limb-first int32 row the five stage kernels
//                   read, written as one [R, B] array (wire_rows);
//   nonce_fold.cu — the sequential nonce fold over finish's eta column.
//
// Each is a function of (row, lane) or of the whole window, so the host
// build (csrc/host_emu.cpp) runs the same code and the CPU tests hold it
// to the plain twins (protocol/batch.unpack_packed + kernels._limb_first,
// kernels.nonce_fold_plain).
#pragma once
#include "pk.cuh"

// ---------------------------------------------------------------------------
// unpack
// ---------------------------------------------------------------------------

// batch.PackedLayout (kernels._layout_ints): offsets into the body of
// the fields the stages read, and the window's constants
struct WireLayout {
  int lb, o_issuer, o_vrf_vk, o_vrf_out, o_vrf_proof, o_vk_hot, o_sigma;
  int depth, spk, has_nonce, plen;
};

// the packed columns of a window (batch.Packed): bytes and int32
struct WireIn {
  const u8 *body;         // [B, lb]
  const u8 *kes_rs;       // [B, 64] KES leaf signature R ‖ s
  const int32_t *tail_idx;  // [B] into tail_tab
  const u8 *tail_tab;     // [Kt, 32 + 32 depth] leaf vk ‖ siblings
  const int32_t *slot, *counter, *c0;  // [B], each in [0, 2^31)
  const int32_t *thr_idx;   // [B] into thr_tab
  const u8 *thr_tab;      // [Kr, 64] thr_lo ‖ thr_hi
  const u8 *nonce;        // [32] epoch nonce bytes
};

// the output's row segments, in order (kernels.unpack_segments)
enum {
  W_ISSUER, W_SIGMA, W_EDHB, W_EDHNB, W_VKHOT, W_PERIOD, W_KESRS, W_TAIL,
  W_KESHB, W_KESHNB, W_VRFVK, W_PROOF, W_ALPHA, W_BETA, W_THR, W_NSEG
};

#define WIRE_ED_MSG 112  // R ‖ issuer ‖ vk_hot ‖ counter_be8 ‖ c0_be8

// SHA-512 blocks of an n-byte message: n bytes, 0x80, the 16-byte length
PK_DEV int wire_nb(int n) { return (n + 17 + 127) / 128; }

// start[s] = first row of segment s; start[W_NSEG] = R
PK_DEV void wire_rows(const WireLayout &L, int *start) {
  const int len[W_NSEG] = {
      32, 64, wire_nb(WIRE_ED_MSG) * 128, 1, 32, 1, 64, 32 + 32 * L.depth,
      wire_nb(64 + L.lb) * 128, 1, 32, L.plen, 32, 64, 64};
  start[0] = 0;
  for (int s = 0; s < W_NSEG; s++) start[s + 1] = start[s] + len[s];
}

// byte j of the 8-byte big-endian form of x in [0, 2^31)
PK_DEV int32_t be8_byte(int32_t x, int j) {
  return j < 4 ? 0 : (int32_t)(((u32)x >> (8 * (7 - j))) & 0xFF);
}

// byte p >= n of an n-byte message's SHA-512 padding over nb blocks:
// 0x80, zeros, then 8n as a 16-byte big-endian number
PK_DEV int32_t sha_pad_byte(int p, int n, int nb) {
  if (p == n) return 0x80;
  int j = p - (nb * 128 - 8);  // 8n < 2^64: its top 8 bytes are 0
  if (j < 0) return 0;
  return (int32_t)((((u64)n * 8) >> (8 * (7 - j))) & 0xFF);
}

// byte p of lane i's padded OCert message R ‖ issuer ‖ vk_hot ‖
// counter_be8 ‖ c0_be8
PK_DEV int32_t wire_ed_msg(const WireLayout &L, const WireIn &in, int i, int p) {
  const u8 *row = in.body + (size_t)i * L.lb;
  if (p < 32) return row[L.o_sigma + p];
  if (p < 64) return row[L.o_issuer + p - 32];
  if (p < 96) return row[L.o_vk_hot + p - 64];
  if (p < 104) return be8_byte(in.counter[i], p - 96);
  if (p < WIRE_ED_MSG) return be8_byte(in.c0[i], p - 104);
  return sha_pad_byte(p, WIRE_ED_MSG, wire_nb(WIRE_ED_MSG));
}

// byte p of lane i's padded KES message kes_r ‖ vk_leaf ‖ body
PK_DEV int32_t wire_kes_msg(const WireLayout &L, const WireIn &in, int i, int p) {
  int n = 64 + L.lb;
  if (p < 32) return in.kes_rs[(size_t)i * 64 + p];
  if (p < 64)
    return in.tail_tab[(size_t)in.tail_idx[i] * (32 + 32 * L.depth) + p - 32];
  if (p < n) return in.body[(size_t)i * L.lb + p - 64];
  return sha_pad_byte(p, n, wire_nb(n));
}

// row k of segment s (any but W_ALPHA) at lane i
PK_DEV int32_t wire_value(const WireLayout &L, const WireIn &in, int s, int k,
                          int i) {
  const u8 *row = in.body + (size_t)i * L.lb;
  switch (s) {
    case W_ISSUER: return row[L.o_issuer + k];
    case W_SIGMA: return row[L.o_sigma + k];
    case W_EDHB: return wire_ed_msg(L, in, i, k);
    case W_EDHNB: return wire_nb(WIRE_ED_MSG);
    case W_VKHOT: return row[L.o_vk_hot + k];
    // lanes that fail the KES window check get an out-of-range period,
    // as the twin gives them (their precheck error comes first)
    case W_PERIOD: return in.slot[i] / L.spk - in.c0[i];
    case W_KESRS: return in.kes_rs[(size_t)i * 64 + k];
    case W_TAIL: return in.tail_tab[(size_t)in.tail_idx[i] * (32 + 32 * L.depth) + k];
    case W_KESHB: return wire_kes_msg(L, in, i, k);
    case W_KESHNB: return wire_nb(64 + L.lb);
    case W_VRFVK: return row[L.o_vrf_vk + k];
    case W_PROOF: return row[L.o_vrf_proof + k];
    case W_BETA: return row[L.o_vrf_out + k];
    case W_THR: return in.thr_tab[(size_t)in.thr_idx[i] * 64 + k];
  }
  return 0;
}

// the VRF alpha of lane i, Blake2b-256(slot_be8 ‖ nonce), into its 32
// rows from `row0`; the neutral nonce adds no bytes
PK_DEV void wire_alpha(const WireLayout &L, const WireIn &in, int i, int B,
                       int row0, int32_t *out) {
  u8 msg[40], a[32];
  for (int j = 0; j < 8; j++) msg[j] = (u8)be8_byte(in.slot[i], j);
  int n = 8;
  if (L.has_nonce) {
    for (int j = 0; j < 32; j++) msg[8 + j] = in.nonce[j];
    n = 40;
  }
  blake2b_256(msg, n, a);
  for (int j = 0; j < 32; j++) out[(size_t)(row0 + j) * B + i] = a[j];
}

// output row r at lane i: the alpha's first row writes all 32 of its rows
PK_DEV void unpack_row_lane(const WireLayout &L, const WireIn &in,
                            const int *start, int r, int i, int B,
                            int32_t *out) {
  int s = 0;
  while (r >= start[s + 1]) s++;
  int k = r - start[s];
  if (s == W_ALPHA) {
    if (k == 0) wire_alpha(L, in, i, B, r, out);
    return;
  }
  out[(size_t)r * B + i] = wire_value(L, in, s, k, i);
}

// ---------------------------------------------------------------------------
// nonce fold
// ---------------------------------------------------------------------------

// carry bytes (protocol/nonces.pack_carry): evolving ‖ set ‖ candidate ‖ set
#define WIRE_CARRY 66

// One Blake2b compression on a group of four lanes: lane j of the group
// holds column j of the state (a, b, c, d = v[j], v[4 + j], v[8 + j],
// v[12 + j]) and runs the G of column j, then, after the group rotates
// b, c and d by 1, 2 and 3 lanes, the G of diagonal j, and rotates them
// back. The message word m[k] lives in lane k of the warp (k < 16) and
// is read with a shuffle. The host build runs the four columns in one
// thread (B2B_COLS arrays), the rotations as permutations, m as an array.
#ifdef PK_HOST
#define B2B_COLS 4
#else
#define B2B_COLS 1
#endif

struct B2bCols {
  u64 a[B2B_COLS], b[B2B_COLS], c[B2B_COLS], d[B2B_COLS];
  int col0;  // the first column this thread runs: lane % 4, or 0 on the host
};

PK_DEV void b2b_g1(u64 &a, u64 &b, u64 &c, u64 &d, u64 x, u64 y) {
  a = a + b + x; d = rotr64(d ^ a, 32);
  c = c + d;     b = rotr64(b ^ c, 24);
  a = a + b + y; d = rotr64(d ^ a, 16);
  c = c + d;     b = rotr64(b ^ c, 63);
}

// column j takes column (j + k) % 4's x
PK_DEV void b2b_rot(u64 x[B2B_COLS], int k) {
#ifdef PK_HOST
  u64 t[4];
  for (int j = 0; j < 4; j++) t[j] = x[(j + k) & 3];
  for (int j = 0; j < 4; j++) x[j] = t[j];
#else
  x[0] = __shfl_sync(0xffffffffu, x[0], (threadIdx.x + k) & 3, 4);
#endif
}

// message word k: m[k] on the host, lane k's mw on the card
PK_DEV u64 b2b_msg(const u64 *m, u64 mw, int k) {
#ifdef PK_HOST
  (void)mw;
  return m[k];
#else
  (void)m;
  return __shfl_sync(0xffffffffu, mw, k);
#endif
}

// one round with the message schedule S (PK_B2B_SIGMA_NIB<r>: index k
// in nibble 15 - k)
template <u64 S>
PK_DEV void b2b_round4(B2bCols &v, const u64 *m, u64 mw) {
  u64 x[B2B_COLS], y[B2B_COLS];
  for (int q = 0; q < B2B_COLS; q++) {
    int j = v.col0 + q;
    x[q] = b2b_msg(m, mw, (int)(S >> (60 - 8 * j)) & 15);
    y[q] = b2b_msg(m, mw, (int)(S >> (56 - 8 * j)) & 15);
  }
  for (int q = 0; q < B2B_COLS; q++) b2b_g1(v.a[q], v.b[q], v.c[q], v.d[q], x[q], y[q]);
  b2b_rot(v.b, 1);
  b2b_rot(v.c, 2);
  b2b_rot(v.d, 3);
  for (int q = 0; q < B2B_COLS; q++) {
    int j = v.col0 + q;
    x[q] = b2b_msg(m, mw, (int)(S >> (28 - 8 * j)) & 15);
    y[q] = b2b_msg(m, mw, (int)(S >> (24 - 8 * j)) & 15);
  }
  for (int q = 0; q < B2B_COLS; q++) b2b_g1(v.a[q], v.b[q], v.c[q], v.d[q], x[q], y[q]);
  b2b_rot(v.b, 3);
  b2b_rot(v.c, 2);
  b2b_rot(v.d, 1);
}

// Blake2b-256 of the 64-byte message m[0..7] (m[8..15] = 0): column j's
// word of the digest into out[q]; init holds each column's first state
// (b2b_init4)
PK_DEV void b2b_compress4(const B2bCols &init, const u64 *m, u64 mw,
                          u64 out[B2B_COLS]) {
  B2bCols v = init;
  b2b_round4<PK_B2B_SIGMA_NIB0>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB1>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB2>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB3>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB4>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB5>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB6>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB7>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB8>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB9>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB0>(v, m, mw);
  b2b_round4<PK_B2B_SIGMA_NIB1>(v, m, mw);
  for (int q = 0; q < B2B_COLS; q++) out[q] = init.a[q] ^ v.a[q] ^ v.c[q];
}

// the unkeyed 32-byte digest's first state for a 64-byte final block:
// v[0..7] = h (h[0] carries the parameter block), v[8..15] = IV,
// v[12] ^= 64 (bytes), v[14] inverted (last block)
PK_DEV B2bCols b2b_init4(int col0) {
  B2bCols v;
  v.col0 = col0;
  for (int q = 0; q < B2B_COLS; q++) {
    int j = col0 + q;
    v.a[q] = PK_SHA512_H0[j] ^ (j == 0 ? 0x01010000ull ^ 32 : 0);
    v.b[q] = PK_SHA512_H0[4 + j];
    v.c[q] = PK_SHA512_H0[j];
    v.d[q] = PK_SHA512_H0[4 + j] ^ (j == 0 ? 64 : 0);
    if (j == 2) v.d[q] = ~v.d[q];
  }
  return v;
}

// word j (8 little-endian bytes) of a 32-byte column of eta [32, B] at
// lane i, or of carry bytes
PK_DEV u64 eta_word(const int32_t *eta, int i, int B, int j) {
  u64 x = 0;
  for (int k = 7; k >= 0; k--)
    x = (x << 8) | (u8)PK_LDG(eta + (size_t)(8 * j + k) * B + i);
  return x;
}

PK_DEV u64 bytes_word(const u8 *c, int j) {
  u64 x = 0;
  for (int k = 7; k >= 0; k--) x = (x << 8) | c[8 * j + k];
  return x;
}

PK_DEV void word_bytes(u8 *c, int j, u64 x) {
  for (int k = 0; k < 8; k++) c[8 * j + k] = (u8)(x >> (8 * k));
}

// The fold over lanes 0 .. n_real - 1, in order: evolving <- evolving ⭒
// eta_i (eta_i itself while evolving is neutral), then candidate <-
// evolving where within_i. One warp: each compression needs the one
// before, and a group of four lanes runs it (b2b_compress4; lanes 4..31
// repeat lanes 0..3 and also serve the message words: lane k < 4 holds
// m[k] = evolving word k, lane 4 + j holds eta_i word j, lanes 8..15
// hold 0). Lane i + 1's eta and flag are loaded before lane i's
// compression. `lane` is the thread's lane (ignored on the host, whose
// one thread runs the four columns); lanes 0..3 store the carry-out.
PK_DEV void nonce_fold_chain(int B, int n_real, const int32_t *eta,
                             const u8 *within, const u8 *cin, u8 *cout,
                             int lane) {
#ifdef PK_HOST
  const int col0 = 0;
#else
  const int col0 = lane & 3;
#endif
  const B2bCols init = b2b_init4(col0);
  u64 ev[B2B_COLS], cand[B2B_COLS], e[B2B_COLS], nxt[B2B_COLS];
  for (int q = 0; q < B2B_COLS; q++) {
    ev[q] = bytes_word(cin, col0 + q);
    cand[q] = bytes_word(cin + 33, col0 + q);
  }
  bool ev_set = cin[32] != 0, cand_set = cin[65] != 0;
  bool w_nxt = false;
  if (n_real > 0) {
    for (int q = 0; q < B2B_COLS; q++) nxt[q] = eta_word(eta, 0, B, col0 + q);
    w_nxt = within[0] != 0;
  }
#pragma unroll 1
  for (int i = 0; i < n_real; i++) {
    for (int q = 0; q < B2B_COLS; q++) e[q] = nxt[q];
    bool w = w_nxt;
    if (i + 1 < n_real) {
      for (int q = 0; q < B2B_COLS; q++) nxt[q] = eta_word(eta, i + 1, B, col0 + q);
      w_nxt = within[i + 1] != 0;
    }
    if (ev_set) {
#ifdef PK_HOST
      u64 m[16] = {ev[0], ev[1], ev[2], ev[3], e[0], e[1], e[2], e[3]}, mw = 0;
#else
      const u64 *m = nullptr;
      int k = lane & 15;
      u64 mw = k < 4 ? ev[0] : k < 8 ? e[0] : 0;
#endif
      b2b_compress4(init, m, mw, ev);
    } else {
      for (int q = 0; q < B2B_COLS; q++) ev[q] = e[q];
    }
    ev_set = true;
    if (w) {
      for (int q = 0; q < B2B_COLS; q++) cand[q] = ev[q];
      cand_set = true;
    }
  }
#ifndef PK_HOST
  if (lane >= 4) return;
#endif
  for (int q = 0; q < B2B_COLS; q++) {
    word_bytes(cout, col0 + q, ev[q]);
    word_bytes(cout + 33, col0 + q, cand[q]);
  }
  if (col0 == 0) {
    cout[32] = ev_set;
    cout[65] = cand_set;
  }
}
