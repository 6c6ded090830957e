// Bodies of the packed window's two wire kernels, and their Blake2b-256
// compressions, on one thread (b2b_256_1: the alpha, the etas) and on a
// group of four lanes (b2b_compress4: the fold's chain):
//
//   unpack.cu     — the packed columns (stage_packed's wire format) ->
//                   every limb-first int32 row the five stage kernels
//                   read, written as one [R, B] array (wire_rows): a
//                   block stages a tile of lanes' sources in shared
//                   memory, then writes a group of its rows;
//   nonce_fold.cu — the sequential nonce fold over the lanes' eta, which
//                   it derives from the header's declared VRF output β
//                   (producer warps) and folds on four lanes (the chain).
//
// Each piece is a function of (block, thread) or of (lane, ring slot), so
// the host build (csrc/host_emu.cpp) runs the same code, thread after
// thread, and the CPU tests hold it to the plain twins
// (protocol/batch.unpack_packed + kernels._limb_first,
// kernels.nonce_fold_plain) and to hashlib.
#pragma once
#include "pk.cuh"

#ifdef PK_HOST
#define WIRE_HD static inline
#else
#define WIRE_HD __host__ __device__ inline
#endif

// the fold's combine on one thread, ev <- Blake2b-256(ev ‖ e), 32-byte
// words each (the compression instrument, nonce_fold.cu)
PK_DEV void b2b_combine(u64 *ev, const u64 *e) {
  u64 m[16] = {ev[0], ev[1], ev[2], ev[3], e[0], e[1], e[2], e[3],
               0, 0, 0, 0, 0, 0, 0, 0};
  b2b_256_1(m, 64, ev);
}

PK_DEV u64 bytes_word(const u8 *c, int j) {
  u64 x = 0;
  for (int k = 7; k >= 0; k--) x = (x << 8) | c[8 * j + k];
  return x;
}

PK_DEV void word_bytes(u8 *c, int j, u64 x) {
  for (int k = 0; k < 8; k++) c[8 * j + k] = (u8)(x >> (8 * k));
}

// ---------------------------------------------------------------------------
// Blake2b-256 on four lanes
// ---------------------------------------------------------------------------

// Blake2b-256 on a group of four lanes (the fold's chain): lane j of the group
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
WIRE_HD int wire_nb(int n) { return (n + 17 + 127) / 128; }

// start[s] = first row of segment s; start[W_NSEG] = R
WIRE_HD void wire_rows(const WireLayout &L, int *start) {
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

// A block's tile: tl lanes (a power of two, at most 32), l0 .. l0 + tl - 1,
// whose source bytes it stages in shared memory once, transposed so that
// byte k of lane l is at [k * tl + l]: each lane's body, KES signature,
// KES tail row, threshold row and VRF alpha, and its integers.
struct WireTile {
  u8 *body, *kes_rs, *tail, *thr, *alpha;
  int32_t *slot, *counter, *c0;
  int tl, lt;  // tl and log2 tl
};

// the tail row's width: leaf vk ‖ depth siblings
WIRE_HD int wire_tail_w(const WireLayout &L) { return 32 + 32 * L.depth; }

// shared-memory bytes of a tile of tl lanes
WIRE_HD int wire_tile_bytes(const WireLayout &L, int tl) {
  return tl * (3 * 4 + L.lb + 64 + wire_tail_w(L) + 64 + 32);
}

PK_DEV WireTile wire_tile(u8 *sm, const WireLayout &L, int tl, int lt) {
  WireTile t;
  t.tl = tl;
  t.lt = lt;
  t.slot = (int32_t *)sm;
  t.counter = t.slot + tl;
  t.c0 = t.counter + tl;
  t.body = (u8 *)(t.c0 + tl);
  t.kes_rs = t.body + tl * L.lb;
  t.tail = t.kes_rs + tl * 64;
  t.thr = t.tail + tl * wire_tail_w(L);
  t.alpha = t.thr + tl * 64;
  return t;
}

// The VRF alpha of lane i, Blake2b-256(slot_be8 ‖ nonce) (the neutral
// nonce adds no bytes), into the tile's alpha bytes as lane l.
PK_DEV void wire_alpha(const WireLayout &L, const WireIn &in, int i, const WireTile &t,
                       int l) {
  u64 m[16], h[4];
#pragma unroll
  for (int j = 0; j < 16; j++) m[j] = 0;
  for (int j = 0; j < 8; j++) m[0] |= (u64)be8_byte(PK_LDG(in.slot + i), j) << (8 * j);
#pragma unroll
  for (int j = 0; j < 4; j++) m[1 + j] = L.has_nonce ? bytes_word(in.nonce, j) : 0;
  b2b_256_1(m, L.has_nonce ? 40 : 8, h);
  for (int k = 0; k < 32; k++) t.alpha[k * t.tl + l] = (u8)(h[k >> 3] >> (8 * (k & 7)));
}

// 16 bytes at a 16-byte aligned address
PK_DEV void ld16(const u8 *p, u8 *b) {
#ifdef PK_HOST
  for (int j = 0; j < 16; j++) b[j] = p[j];
#else
  const uint4 x = __ldg((const uint4 *)p);
  const u32 w[4] = {x.x, x.y, x.z, x.w};
  for (int j = 0; j < 16; j++) b[j] = (u8)(w[j >> 2] >> (8 * (j & 3)));
#endif
}

// Stage rows 0 .. rows - 1 of w bytes each, row j's bytes at row(j), into
// dst[k * tl + j]. Threads t0, t0 + dt, ... take a row's 16-byte chunk
// each, the rows fastest, so that the 16 shared stores of a warp's chunks
// go to consecutive bytes (no bank conflict); the chunk is one 16-byte
// load when `vec` (rows 16-byte aligned, w a multiple of 16), else 16
// byte loads, independent of each other.
template <class Row>
PK_DEV void stage_rows(u8 *dst, int tl, int rows, int w, Row row, bool vec,
                       int t0, int dt) {
  const int chunks = (w + 15) / 16;
  for (int e = t0; e < rows * chunks; e += dt) {
    const int j = e % rows, k = 16 * (e / rows);
    const u8 *src = row(j) + k;
    u8 b[16];
    if (vec) {
      ld16(src, b);
    } else {
      for (int q = 0; q < 16; q++) b[q] = k + q < w ? PK_LDG(src + q) : 0;
    }
    for (int q = 0; q < 16 && k + q < w; q++) dst[(k + q) * tl + j] = b[q];
  }
}

// vec flags: the body tile, the KES signatures, the two tables
#define WIRE_VEC_BODY 1
#define WIRE_VEC_RS 2
#define WIRE_VEC_TABS 4

// Phase 1: stage the tile's sources for its n live lanes (n <= tl) on
// threads t0, t0 + dt, ...
PK_DEV void unpack_stage(const WireLayout &L, const WireIn &in, const WireTile &t,
                         int l0, int n, int vec, int t0, int dt) {
  for (int j = t0; j < n; j += dt) {
    t.slot[j] = PK_LDG(in.slot + l0 + j);
    t.counter[j] = PK_LDG(in.counter + l0 + j);
    t.c0[j] = PK_LDG(in.c0 + l0 + j);
  }
  const u8 *body = in.body + (size_t)l0 * L.lb, *rs = in.kes_rs + (size_t)l0 * 64;
  stage_rows(t.body, t.tl, n, L.lb, [&](int j) { return body + (size_t)j * L.lb; },
             vec & WIRE_VEC_BODY, t0, dt);
  stage_rows(t.kes_rs, t.tl, n, 64, [&](int j) { return rs + (size_t)j * 64; },
             vec & WIRE_VEC_RS, t0, dt);
  const int tw = wire_tail_w(L);
  stage_rows(t.tail, t.tl, n, tw, [&](int j) {
    return in.tail_tab + (size_t)PK_LDG(in.tail_idx + l0 + j) * tw;
  }, vec & WIRE_VEC_TABS, t0, dt);
  stage_rows(t.thr, t.tl, n, 64, [&](int j) {
    return in.thr_tab + (size_t)PK_LDG(in.thr_idx + l0 + j) * 64;
  }, vec & WIRE_VEC_TABS, t0, dt);
}

// Phase 1 too, for a block that writes alpha rows: each live lane's alpha
// hashed on threads t0, t0 + dt, ... (a warp of its own on the card,
// beside the copies)
PK_DEV void unpack_alphas(const WireLayout &L, const WireIn &in, const WireTile &t,
                          int l0, int n, int t0, int dt) {
  for (int j = t0; j < n; j += dt) wire_alpha(L, in, l0 + j, t, j);
}

// The tile's byte row (its lanes' bytes, transposed) that row k of segment
// s copies, or null for a computed row: a big-endian integer byte, the
// SHA-512 padding, a block count, the KES period.
PK_DEV const u8 *tile_row(const WireLayout &L, const WireTile &t, int s, int k) {
  const int tl = t.tl;
  switch (s) {
    case W_ISSUER: return t.body + (L.o_issuer + k) * tl;
    case W_SIGMA: return t.body + (L.o_sigma + k) * tl;
    case W_EDHB:  // R ‖ issuer ‖ vk_hot ‖ counter_be8 ‖ c0_be8, padded
      return k < 32 ? t.body + (L.o_sigma + k) * tl
             : k < 64 ? t.body + (L.o_issuer + k - 32) * tl
             : k < 96 ? t.body + (L.o_vk_hot + k - 64) * tl : nullptr;
    case W_VKHOT: return t.body + (L.o_vk_hot + k) * tl;
    case W_KESRS: return t.kes_rs + k * tl;
    case W_TAIL: return t.tail + k * tl;
    case W_KESHB:  // kes_r ‖ vk_leaf ‖ body, padded
      return k < 32 ? t.kes_rs + k * tl
             : k < 64 ? t.tail + (k - 32) * tl
             : k < 64 + L.lb ? t.body + (k - 64) * tl : nullptr;
    case W_VRFVK: return t.body + (L.o_vrf_vk + k) * tl;
    case W_PROOF: return t.body + (L.o_vrf_proof + k) * tl;
    case W_ALPHA: return t.alpha + k * tl;
    case W_BETA: return t.body + (L.o_vrf_out + k) * tl;
    case W_THR: return t.thr + k * tl;
  }
  return nullptr;
}

// a computed row k of segment s at the tile's lane l
PK_DEV int32_t tile_computed(const WireLayout &L, const WireTile &t, int s, int k, int l) {
  switch (s) {
    case W_EDHB:
      if (k < 104) return be8_byte(t.counter[l], k - 96);
      if (k < WIRE_ED_MSG) return be8_byte(t.c0[l], k - 104);
      return sha_pad_byte(k, WIRE_ED_MSG, wire_nb(WIRE_ED_MSG));
    case W_EDHNB: return wire_nb(WIRE_ED_MSG);
    // lanes that fail the KES window check get an out-of-range period,
    // as the twin gives them (their precheck error comes first)
    case W_PERIOD: return t.slot[l] / L.spk - t.c0[l];
    case W_KESHB: return sha_pad_byte(k, 64 + L.lb, wire_nb(64 + L.lb));
    case W_KESHNB: return wire_nb(64 + L.lb);
  }
  return 0;
}

PK_DEV void store4(int32_t *p, const int32_t *v) {
#ifdef PK_HOST
  for (int q = 0; q < 4; q++) p[q] = v[q];
#else
  *(int4 *)p = make_int4(v[0], v[1], v[2], v[3]);
#endif
}

// Phase 2: output rows rb .. re - 1 of the tile's n live lanes, segment
// by segment. With `v4` (n = tl, a multiple of 4, and B too) a thread
// writes 4 lanes of a row with one 16-byte store, their bytes one 4-byte
// shared load, so 32 threads write 4 rows' 32 lanes or more rows' fewer;
// else one lane, so 32 threads write a row's 32 lanes or 32 / tl rows'.
PK_DEV void unpack_rows(const WireLayout &L, const WireTile &t, int rb, int re,
                        int l0, int n, int B, int32_t *out, bool v4, int t0, int dt) {
  int start[W_NSEG + 1];
  wire_rows(L, start);
  const int lq = v4 ? t.lt - 2 : t.lt;  // log2 of the threads a row takes
  for (int s = 0; s < W_NSEG; s++) {
    const int a = start[s] > rb ? start[s] : rb;
    const int b = start[s + 1] < re ? start[s + 1] : re;
    for (int e = t0; e < (b - a) << lq; e += dt) {
      const int r = a + (e >> lq), k = r - start[s];
      const int l = (e & ((1 << lq) - 1)) << (v4 ? 2 : 0);
      const u8 *row = tile_row(L, t, s, k);
      int32_t *o = out + (size_t)r * B + l0 + l;
      if (v4) {
        int32_t v[4];
        if (row) {
          const u32 w = *(const u32 *)(row + l);
          for (int q = 0; q < 4; q++) v[q] = (int32_t)((w >> (8 * q)) & 0xFF);
        } else {
          for (int q = 0; q < 4; q++) v[q] = tile_computed(L, t, s, k, l + q);
        }
        store4(o, v);
      } else if (l < n) {
        *o = row ? row[l] : tile_computed(L, t, s, k, l);
      }
    }
  }
}

// The launch's geometry, computed once on the host: the tile's lanes (32,
// or fewer for a window of fewer lanes or bodies too long for 32 in
// shared memory); the groups each lane tile's rows are cut into, so that
// a small window still spreads over the SMs (each group stages its tile's
// sources again: two groups a tile made a full window 1.3x slower); the
// rows; the shared-memory bytes; the vector-copy flags; and whether the
// rows go out 4 lanes a store.
struct UnpackGrid { int tl, lt, groups, rows, smem, vec, v4; };

#define UNPACK_SMEM_MAX (200 * 1024)
#define UNPACK_BLOCKS 132  // one block an SM

WIRE_HD UnpackGrid unpack_grid(const WireLayout &L, const WireIn &in, int B) {
  UnpackGrid g;
  int start[W_NSEG + 1];
  wire_rows(L, start);
  g.rows = start[W_NSEG];
  g.tl = 32;
  while (g.tl > 1 && (g.tl >= 2 * B || wire_tile_bytes(L, g.tl) > UNPACK_SMEM_MAX))
    g.tl /= 2;
  for (g.lt = 0; (1 << g.lt) < g.tl; g.lt++) {}
  const int tiles = (B + g.tl - 1) / g.tl, most = g.rows / 64 > 0 ? g.rows / 64 : 1;
  g.groups = (UNPACK_BLOCKS + tiles - 1) / tiles;
  if (g.groups > most) g.groups = most;
  g.smem = wire_tile_bytes(L, g.tl);
  // 16-byte stores of 4 lanes: every tile full, rows 16-byte aligned
  g.v4 = g.tl >= 4 && B % g.tl == 0 && B % 4 == 0;
  const size_t tw = wire_tail_w(L);
  g.vec = ((size_t)in.body % 16 == 0 && L.lb % 16 == 0 ? WIRE_VEC_BODY : 0) |
          ((size_t)in.kes_rs % 16 == 0 ? WIRE_VEC_RS : 0) |
          ((size_t)in.tail_tab % 16 == 0 && (size_t)in.thr_tab % 16 == 0 &&
           tw % 16 == 0 ? WIRE_VEC_TABS : 0);
  return g;
}

// the rows of row group y: [rb, re)
WIRE_HD void unpack_group_rows(const UnpackGrid &g, int y, int &rb, int &re) {
  rb = (int)((long long)g.rows * y / g.groups);
  re = (int)((long long)g.rows * (y + 1) / g.groups);
}

// whether rows [rb, re) hold any of the alpha's
WIRE_HD bool unpack_has_alpha(const WireLayout &L, int rb, int re) {
  int start[W_NSEG + 1];
  wire_rows(L, start);
  return rb < start[W_ALPHA + 1] && re > start[W_ALPHA];
}

// ---------------------------------------------------------------------------
// nonce fold
// ---------------------------------------------------------------------------

// a ring slot holds FOLD_CHUNK consecutive lanes' eta (one a producer
// thread); FOLD_SLOTS slots; warps 1 .. FOLD_PRODUCERS produce
#define FOLD_CHUNK 32
#define FOLD_SLOTS 6
#define FOLD_PRODUCERS 3

// The etas of FOLD_SLOTS chunks in flight: word j of the eta of the
// chunk's lane l at eta[slot][j][l], its stability flag at within[slot][l].
struct FoldRing {
  u64 eta[FOLD_SLOTS][4][FOLD_CHUNK];
  u8 within[FOLD_SLOTS][FOLD_CHUNK];
};

// The chain's carry in registers: the evolving and candidate words of the
// columns this thread runs (column lane % 4 on the card, all four on the
// host), as b2b_compress4 holds a digest.
struct FoldState {
  u64 ev[B2B_COLS], cand[B2B_COLS];
  bool ev_set, cand_set;
  int col0;
};

PK_DEV FoldState fold_load(const u8 *cin, int col0) {
  FoldState st;
  st.col0 = col0;
  for (int q = 0; q < B2B_COLS; q++) {
    st.ev[q] = bytes_word(cin, col0 + q);
    st.cand[q] = bytes_word(cin + 33, col0 + q);
  }
  st.ev_set = cin[32] != 0;
  st.cand_set = cin[65] != 0;
  return st;
}

// the carry-out: each column's words (lanes 0..3 of the group on the
// card), the set bytes from column 0
PK_DEV void fold_store(const FoldState &st, u8 *cout) {
  for (int q = 0; q < B2B_COLS; q++) {
    word_bytes(cout, st.col0 + q, st.ev[q]);
    word_bytes(cout + 33, st.col0 + q, st.cand[q]);
  }
  if (st.col0 == 0) {
    cout[32] = st.ev_set;
    cout[65] = st.cand_set;
  }
}

// Producer: lane i's eta, Blake2b-256(Blake2b-256("N" ‖ β_i)) (the
// reference's vrf_nonce_value, which finish also computes), from the
// declared VRF output's rows beta [64, B], and its flag, into entry l of
// ring slot s. A warp's 32 lanes read each β row as 128 contiguous bytes;
// the two compressions are one thread's (b2b_256_1), independent across
// lanes.
PK_DEV void fold_produce(const int32_t *beta, const u8 *within, int B, int i,
                         FoldRing &r, int s, int l) {
  u64 m[16], e[4];
#pragma unroll
  for (int j = 0; j < 16; j++) m[j] = 0;
  m[0] = 'N';
#pragma unroll
  for (int k = 0; k < 64; k++)
    m[(k + 1) >> 3] |= (u64)(u8)PK_LDG(beta + (size_t)k * B + i) << (8 * ((k + 1) & 7));
  b2b_256_1(m, 65, e);
#pragma unroll
  for (int j = 0; j < 16; j++) m[j] = j < 4 ? e[j] : 0;
  b2b_256_1(m, 32, e);
  for (int j = 0; j < 4; j++) r.eta[s][j][l] = e[j];
  r.within[s][l] = PK_LDG(within + i);
}

// The chain, one lane, on a group of four lanes: evolving <- evolving ⭒
// eta (eta itself while evolving is neutral), then candidate <- evolving
// where the lane's slot is within the stability window. The message's
// words m[0..3] = evolving are the group's digest words (lane k < 4 holds
// word k), m[4..7] = eta come from the ring (lane 4 + j reads word j),
// lanes 8..15 hold m[8..15] = 0 (b2b_compress4 reads m[k] from lane k);
// `lane` is the thread's lane (unused on the host, whose one thread runs
// the four columns and reads m as an array).
PK_DEV void fold_step(FoldState &st, const B2bCols &init, const FoldRing &r,
                      int s, int l, int lane) {
  if (st.ev_set) {
#ifdef PK_HOST
    (void)lane;
    u64 m[16] = {st.ev[0], st.ev[1], st.ev[2], st.ev[3], r.eta[s][0][l],
                 r.eta[s][1][l], r.eta[s][2][l], r.eta[s][3][l],
                 0, 0, 0, 0, 0, 0, 0, 0}, mw = 0;
#else
    const u64 *m = nullptr;
    const int k = lane & 15;
    const u64 mw = k < 4 ? st.ev[0] : k < 8 ? r.eta[s][k - 4][l] : 0;
#endif
    b2b_compress4(init, m, mw, st.ev);
  } else {
    for (int q = 0; q < B2B_COLS; q++) st.ev[q] = r.eta[s][st.col0 + q][l];
  }
  st.ev_set = true;
  if (r.within[s][l]) {
    for (int q = 0; q < B2B_COLS; q++) st.cand[q] = st.ev[q];
    st.cand_set = true;
  }
}

#ifndef PK_HOST
// mbarriers in shared memory (PTX): each ring slot has a "full" barrier
// that its producer warp's 32 threads arrive on, and an "empty" one that
// the chain's thread arrives on when it has folded the slot's lanes
PK_DEV u32 smem_u32(const void *p) { return (u32)__cvta_generic_to_shared(p); }

PK_DEV void mbar_init(u64 *bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

PK_DEV void mbar_arrive(u64 *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
PK_DEV void mbar_wait(u64 *bar, int parity) {
  u32 done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
#endif
