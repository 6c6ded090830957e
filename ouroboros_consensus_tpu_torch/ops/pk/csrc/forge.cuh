// Per-lane bodies of the forge's two kernels (forge.cu), one lane per
// (slot, pool) pair or per OCert signable:
//
//   forge_sweep — the leader-election sweep of one election window: for
//                 lane i, pool i % P and slot slot0 + i / P, the ECVRF
//                 prove of alpha = Blake2b-256(slot_be8 ‖ η0) (the 8
//                 bytes alone under the neutral nonce) under the pool's
//                 VRF key, both proof serialisations, β, and the leader
//                 value's bracket against the pool's threshold rows;
//   ed_sign     — RFC 8032 Ed25519 signing of SHA-512-padded messages.
//
// The pools' columns are one row-major table [P][FS_POOL] (x ‖ prefix ‖
// pk ‖ lo ‖ hi, 32 bytes each, x the clamped expanded seed), indexed by
// lane % P; a lane writes its own row of the output [B][FS_OUT]. The
// sweep runs 32 lanes a block over four warps, two pairs (pk.cuh: Pair):
// warp 0 hashes to the curve once a lane; pair A (warps 0, 1) builds the
// one table of H in shared memory (LaneTab) that both ladders read, while
// warp 2 compresses H (its inversion one a block, a product tree over the
// block's lanes) and derives the nonce k; then pair A runs k·B's first
// windows, Γ = x·H and 8Γ, and pair B (warps 2, 3) V = k·H and the rest of
// k·B beside it; then warp 0
// compresses Γ, U, V and 8Γ on one inversion a block (the product of a
// lane's four Z coordinates is a leaf of a product tree in shared memory
// whose root the whole warp inverts, agg.cuh: w_inv) and hashes the
// challenge, while warp 1 hashes β and the leader value. Each step is its
// own function of (lane, scratch), so the host build runs a group's steps
// one after another in an order the barriers allow (csrc/host_emu.cpp)
// and the CPU tests hold them to the twins (ops/pk/prove.py).
#pragma once
#include "agg.cuh"

#define FS_POOL 160  // x ‖ prefix ‖ pk ‖ lo ‖ hi
#define FS_X 0
#define FS_PREFIX 32
#define FS_PK 64
#define FS_LO 96
#define FS_HI 128

#define FS_OUT 210  // Γ ‖ c16 ‖ U ‖ V ‖ s ‖ β ‖ win ‖ amb
#define FS_G 0
#define FS_C 32
#define FS_U 48
#define FS_V 80
#define FS_S 112
#define FS_BETA 144
#define FS_WIN 208
#define FS_AMB 209

struct ForgeArgs {
  int B, P;
  int64_t slot0;
  const u8 *pools;  // [P][FS_POOL]
  const u8 *nonce;  // [32], or null for the neutral nonce
  u8 *out;          // [B][FS_OUT]
};

// named barriers of the sweep's block (0 is __syncthreads)
enum { FS_BAR_A = 1,  // pair A's steps (warps 0, 1)
       FS_BAR_B,      // pair B's steps (warps 2, 3)
       FS_BAR_TAB,    // pair A's table and warp 2's k -> pair B (all four warps)
       FS_BAR_K,      // warp 2's k (and its tree's space) -> pair A (warps 0, 1, 2)
       FS_BAR_U,      // pair A's part of k·B -> pair B's walk (all four warps)
       FS_BAR_FIN };  // warp 0's encodings -> warp 1's β (warps 0, 1)
#define FS_KA 14  // k·B's windows below FS_KA on pair A, the rest on pair B
#define FS_LEAVES PK_GROUP       // the finish's tree: a leaf a lane
#define FS_TN (2 * FS_LEAVES)    // nodes in heap order: root 1, leaves 32 .. 63

// what the steps hand on: point rows lane-minor (limb l of coordinate c
// at w[(10 c + l) * 32 + lane]), bytes lane-minor; 56 KB, so that four
// blocks share an SM
struct ForgeScratch {
  union {
    u32 tab[PK_LANETAB_WORDS];  // the table of H, read by both ladders
    struct {                    // after both ladders
      u32 pts[3][30 * PK_GROUP];  // Γ, V, 8Γ: X, Y, Z
      u32 node[10 * FS_TN];       // the product tree (a zero leaf holds 1)
      u8 enc[128 * PK_GROUP];     // Γ ‖ U ‖ V ‖ 8Γ encodings
      u8 zero[FS_LEAVES];         // the lanes whose Z product is 0
    } fin;
  };
  u32 x[2][PK_TEAM1_WORDS];  // the pairs' exchange areas; H's point rows in
                             // pair B's before its first step
  union {
    u32 u[30 * PK_GROUP];  // U = k·B: X, Y, Z (pair A's part, then all of it)
    struct {               // before: H's Z tree (warp 2)
      u32 node[10 * FS_TN];
      u8 zero[FS_LEAVES];
    } ht;
  };
  u8 henc[32 * PK_GROUP];  // H's encoding
  u8 k[32 * PK_GROUP];     // the nonce k
};

PK_DEV void fs_put(u32 *w, int lane, const ge &p) {
  for (int l = 0; l < 10; l++) {
    w[l * PK_GROUP + lane] = p.x.v[l];
    w[(10 + l) * PK_GROUP + lane] = p.y.v[l];
    w[(20 + l) * PK_GROUP + lane] = p.z.v[l];
    w[(30 + l) * PK_GROUP + lane] = p.t.v[l];
  }
}

PK_DEV ge fs_get(const u32 *w, int lane) {
  ge p;
  for (int l = 0; l < 10; l++) {
    p.x.v[l] = w[l * PK_GROUP + lane];
    p.y.v[l] = w[(10 + l) * PK_GROUP + lane];
    p.z.v[l] = w[(20 + l) * PK_GROUP + lane];
    p.t.v[l] = w[(30 + l) * PK_GROUP + lane];
  }
  return p;
}

// X, Y, Z of a point (its T is not read again)
PK_DEV void fs_put_xyz(u32 *w, int lane, const ge &p) {
  for (int l = 0; l < 10; l++) {
    w[l * PK_GROUP + lane] = p.x.v[l];
    w[(10 + l) * PK_GROUP + lane] = p.y.v[l];
    w[(20 + l) * PK_GROUP + lane] = p.z.v[l];
  }
}

PK_DEV fe fs_get_fe(const u32 *w, int c, int lane) {
  fe r;
  for (int l = 0; l < 10; l++) r.v[l] = w[(10 * c + l) * PK_GROUP + lane];
  return r;
}

// `n` bytes of pool `p`'s column at `off`
PK_DEV void fs_pool_bytes(const ForgeArgs &a, int p, int off, int n, u8 *out) {
  const u8 *row = a.pools + (size_t)p * FS_POOL + off;
  for (int k = 0; k < n; k++) out[k] = PK_LDG(row + k);
}

// alpha = mkInputVRF(slot, η0) = Blake2b-256(slot_be8 ‖ η0), the slot's 8
// bytes alone under the neutral nonce; on words
PK_DEV void fs_alpha(int64_t slot, const u8 *nonce, u8 *alpha) {
  u64 m[16];
  for (int t = 0; t < 16; t++) m[t] = 0;
  const u64 s = (u64)slot;
  for (int k = 0; k < 8; k++) m[0] |= ((s >> (56 - 8 * k)) & 255) << (8 * k);
  u64 n = 8;
  if (nonce != nullptr) {
    for (int k = 0; k < 32; k++) m[1 + (k >> 3)] |= (u64)PK_LDG(nonce + k) << (8 * (k & 7));
    n = 40;
  }
  u64 h[4];
  blake2b_256_words(m, n, h);
  for (int k = 0; k < 32; k++) alpha[k] = (u8)(h[k >> 3] >> (8 * (k & 7)));
}

// H = 8·Elligator2(SHA-512(suite ‖ 1 ‖ pk ‖ alpha) mod 2^255) of lane i
PK_DEV ge fs_hash_h(int i, const ForgeArgs &a, u8 *pk) {
  u8 alpha[32], dg[64];
  fs_pool_bytes(a, i % a.P, FS_PK, 32, pk);
  fs_alpha(a.slot0 + i / a.P, a.nonce, alpha);
  sha512_msg<66>([&](int k) -> u8 {
    return k == 0 ? 0x04 : k == 1 ? 0x01 : k < 34 ? pk[k - 2] : alpha[k - 34];
  }, dg);
  return ge_mul_cofactor(elligator2(fe_freeze(fe_from_bytes(dg))));
}

// warp 0: H into pair B's exchange area (pair A and warp 2 read it there)
PK_DEV ge fs_role_h(int i, int lane, const ForgeArgs &a, ForgeScratch &sc) {
  u8 pk[32];
  ge h = fs_hash_h(i, a, pk);
  fs_put(sc.x[1], lane, h);
  return h;
}

// pair A, first: the table of H (pk.cuh: qtable8), each warp storing its
// two coordinates of every entry
PK_DEV void fs_pair_table(int lane, ForgeScratch &sc, Pair &pa) {
  LaneTab tab{sc.tab, lane};
  qtable8(pa, tab, fs_get(sc.x[1], lane));
}

// pair A, then: Γ = x·H, x the clamped expanded seed (256 bits, not
// reduced mod L: 64 digits recode to 65, the first 0 or 1), and 8Γ
PK_DEV void fs_pair_gamma(int i, int lane, const ForgeArgs &a, ForgeScratch &sc, Pair &pa,
                          ge &g, ge &g8) {
  u8 x[32], d[64];
  fs_pool_bytes(a, i % a.P, FS_X, 32, x);
  nibbles_msb(x, 32, d);
  LaneTab tab{sc.tab, lane};
  g = qscalar_mul_w4(pa, d, 64, tab);
  g8 = g;
#pragma unroll 1
  for (int j = 0; j < 3; j++) qdbl(pa, g8, g8);
}

PK_DEV void fs_lane_k(int lane, const ForgeScratch &sc, u8 *k) {
  for (int j = 0; j < 32; j++) k[j] = sc.k[(j << 5) + lane];
}

// pair A, first once k is published: its part of U = k·B, the windows
// below FS_KA; its first warp (the host's one pass) keeps it for pair B
PK_DEV void fs_pair_ua(int lane, const u32 *base8, ForgeScratch &sc, Pair &pa) {
  u8 k[32];
  fs_lane_k(lane, sc, k);
  ge ua = qbase_mul_w8(pa, base8, k, ge_identity(), 0, FS_KA);
  if (pa.w <= 0) fs_put_xyz(sc.u, lane, ua);
}

// pair B, first: V = k·H
PK_DEV ge fs_pair_v(int lane, ForgeScratch &sc, Pair &pb) {
  u8 k[32], d[64];
  fs_lane_k(lane, sc, k);
  nibbles_msb(k, 32, d);
  LaneTab tab{sc.tab, lane};
  return qscalar_mul_w4(pb, d, 64, tab);
}

// pair B, after V: U = pair A's part plus k·B's windows from FS_KA; its
// first warp keeps U for the finish (both warps read pair A's part before
// the walk's first barrier)
PK_DEV void fs_pair_u(int lane, const u32 *base8, ForgeScratch &sc, Pair &pb) {
  u8 k[32];
  fs_lane_k(lane, sc, k);
  // the part's X, Y, Z as the extended point (XZ : YZ : Z² : XY), whose
  // T the walk's first addition reads
  const fe x = fs_get_fe(sc.u, 0, lane), y = fs_get_fe(sc.u, 1, lane);
  const fe z = fs_get_fe(sc.u, 2, lane);
  ge ua;
  ua.x = fe_mul(x, z);
  ua.y = fe_mul(y, z);
  ua.z = fe_sq(z);
  ua.t = fe_mul(x, y);
  ge u = qbase_mul_w8(pb, base8, k, ua, FS_KA, 32);
  if (pb.w <= 0) fs_put_xyz(sc.u, lane, u);
}

// Z of the lane's four points (Γ, U, V, 8Γ), and its prefix products
PK_DEV void fs_zs(int lane, const ForgeScratch &sc, fe z[4], fe pre[4]) {
  z[0] = fs_get_fe(sc.fin.pts[0], 2, lane);
  z[1] = fs_get_fe(sc.u, 2, lane);
  z[2] = fs_get_fe(sc.fin.pts[1], 2, lane);
  z[3] = fs_get_fe(sc.fin.pts[2], 2, lane);
  pre[0] = z[0];
  for (int j = 1; j < 4; j++) pre[j] = fe_mul(pre[j - 1], z[j]);
}

// A product tree of the block's 32 lanes in shared memory, in place:
// limb l of node m at node[l * FS_TN + m], root 1, leaf 32 + lane. A leaf
// whose value is 0 holds 1 and is flagged, so its inverse is 0 as
// fe_inv(0) is; the other lanes' inverses are exact.
PK_DEV void fs_tree_leaf(u32 *node, u8 *zero, int lane, const fe &z) {
  const bool z0 = fe_is_zero(z);
  zero[lane] = z0 ? 1 : 0;
  agg_fe_put(node, FS_TN, FS_LEAVES + lane, z0 ? fe_one() : z);
}

// node m from its children (up); then m's children's inverses from m's
// inverse, which node m holds by then (down)
PK_DEV void fs_tree_up(u32 *node, int m) {
  agg_fe_put(node, FS_TN, m, fe_mul(agg_fe_get(node, FS_TN, 2 * m),
                                    agg_fe_get(node, FS_TN, 2 * m + 1)));
}

PK_DEV void fs_tree_down(u32 *node, int m) {
  const fe iv = agg_fe_get(node, FS_TN, m);
  const fe l = agg_fe_get(node, FS_TN, 2 * m), r = agg_fe_get(node, FS_TN, 2 * m + 1);
  agg_fe_put(node, FS_TN, 2 * m, fe_mul(iv, r));
  agg_fe_put(node, FS_TN, 2 * m + 1, fe_mul(iv, l));
}

// the whole tree on one warp: up a thread a node, the root's inverse on
// the whole warp (a field element over ten lanes, agg.cuh: w_inv), down a
// thread a node; the host's one pass runs each level's nodes in turn
PK_DEV void fs_tree(u32 *node, int lane) {
#ifdef PK_HOST
  (void)lane;
  for (int n = FS_LEAVES / 2; n >= 1; n >>= 1)
    for (int t = 0; t < n; t++) fs_tree_up(node, n + t);
#else
  __syncwarp();
  for (int n = FS_LEAVES / 2; n >= 1; n >>= 1) {
    if (lane < n) fs_tree_up(node, n + lane);
    __syncwarp();
  }
#endif
  wv x;
  W_LANES(l) { W_AT(x, l) = node[w_limb(l) * FS_TN + 1]; }
  wv r = w_inv(x);
#ifndef PK_HOST
  __syncwarp();
#endif
  W_LANES(l) {
    if (l < 10) node[l * FS_TN + 1] = W_AT(r, l);
  }
#ifdef PK_HOST
  for (int n = 1; n < FS_LEAVES; n <<= 1)
    for (int t = 0; t < n; t++) fs_tree_down(node, n + t);
#else
  __syncwarp();
  for (int n = 1; n < FS_LEAVES; n <<= 1) {
    if (lane < n) fs_tree_down(node, n + lane);
    __syncwarp();
  }
#endif
}

PK_DEV fe fs_tree_inv(const u32 *node, const u8 *zero, int lane) {
  return zero[lane] ? fe_zero() : agg_fe_get(node, FS_TN, FS_LEAVES + lane);
}

// warp 2, beside the table: H's Z a leaf of the block's tree (in the
// space U takes later)
PK_DEV void fs_k_leaf(int lane, ForgeScratch &sc) {
  fs_tree_leaf(sc.ht.node, sc.ht.zero, lane, fs_get_fe(sc.x[1], 2, lane));
}

// warp 2, after the tree: H's encoding with its inverse, and k =
// SHA-512(prefix ‖ H) mod L
PK_DEV void fs_k_derive(int i, int lane, const ForgeArgs &a, ForgeScratch &sc) {
  u8 prefix[32], dg[64], xb[32], henc[32], k[32];
  const fe iz = fs_tree_inv(sc.ht.node, sc.ht.zero, lane);
  fe_to_bytes(xb, fe_mul(fs_get_fe(sc.x[1], 0, lane), iz));
  fe_to_bytes(henc, fe_mul(fs_get_fe(sc.x[1], 1, lane), iz));
  henc[31] |= (u8)((xb[0] & 1) << 7);
  fs_pool_bytes(a, i % a.P, FS_PREFIX, 32, prefix);
  sha512_msg<64>([&](int j) -> u8 { return j < 32 ? prefix[j] : henc[j - 32]; }, dg);
  sc_reduce512(dg, k);
  for (int j = 0; j < 32; j++) {
    sc.henc[(j << 5) + lane] = henc[j];
    sc.k[(j << 5) + lane] = k[j];
  }
}

// warp 0, after both ladders: the lane's leaf, the product of its four Z
PK_DEV void fs_leaf(int lane, ForgeScratch &sc) {
  fe z[4], pre[4];
  fs_zs(lane, sc, z, pre);
  fs_tree_leaf(sc.fin.node, sc.fin.zero, lane, pre[3]);
}

// warp 0: the lane's four inverses from its leaf's (Montgomery's trick
// back down the prefix products), then Γ, U, V and 8Γ compressed
PK_DEV void fs_compress(int lane, ForgeScratch &sc) {
  fe z[4], pre[4], inv[4];
  fs_zs(lane, sc, z, pre);
  fe acc = fs_tree_inv(sc.fin.node, sc.fin.zero, lane);
  for (int j = 3; j > 0; j--) {
    inv[j] = fe_mul(acc, pre[j - 1]);
    acc = fe_mul(acc, z[j]);
  }
  inv[0] = acc;
  const u32 *rows[4] = {sc.fin.pts[0], sc.u, sc.fin.pts[1], sc.fin.pts[2]};
  for (int j = 0; j < 4; j++) {
    u8 xb[32], yb[32];
    fe_to_bytes(xb, fe_mul(fs_get_fe(rows[j], 0, lane), inv[j]));
    fe_to_bytes(yb, fe_mul(fs_get_fe(rows[j], 1, lane), inv[j]));
    yb[31] |= (u8)((xb[0] & 1) << 7);
    for (int t = 0; t < 32; t++) sc.fin.enc[((32 * j + t) << 5) + lane] = yb[t];
  }
}

PK_DEV u8 fs_enc(const ForgeScratch &sc, int lane, int j) { return sc.fin.enc[(j << 5) + lane]; }

// warp 0, then: c = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖ V)[:16], s = k + c·x mod
// L -> the row's Γ, c16, U, V and s
PK_DEV void fs_challenge(int i, int lane, const ForgeArgs &a, const ForgeScratch &sc) {
  u8 dg[64], x[32], k[32], cx[32], s[32];
  sha512_msg<130>([&](int j) -> u8 {
    return j == 0 ? 0x04 : j == 1 ? 0x02 : j < 34 ? sc.henc[((j - 2) << 5) + lane]
                                                  : fs_enc(sc, lane, j - 34);
  }, dg);
  fs_pool_bytes(a, i % a.P, FS_X, 32, x);
  fs_lane_k(lane, sc, k);
  sc_mul<4>(dg, x, cx);
  sc_add(k, cx, s);
  u8 *o = a.out + (size_t)i * FS_OUT;
  for (int j = 0; j < 32; j++) {
    o[FS_G + j] = fs_enc(sc, lane, j);
    o[FS_U + j] = fs_enc(sc, lane, 32 + j);
    o[FS_V + j] = fs_enc(sc, lane, 64 + j);
    o[FS_S + j] = s[j];
  }
  for (int j = 0; j < 16; j++) o[FS_C + j] = dg[j];
}

// warp 1, beside it: β = SHA-512(suite ‖ 3 ‖ 8Γ), the leader value
// Blake2b-256('L' ‖ β) against the pool's rows: win = lv < lo, amb = !win
// && lv < hi -> the row's β, win and amb
PK_DEV void fs_beta(int i, int lane, const ForgeArgs &a, const ForgeScratch &sc) {
  const int p = i % a.P;
  u8 g8[32], beta[64], lo[32], hi[32], lv[32];
  for (int j = 0; j < 32; j++) g8[j] = fs_enc(sc, lane, 96 + j);
  vrf_beta(g8, beta);
  u64 m[16], lw[4];
  for (int t = 0; t < 16; t++) m[t] = 0;
  for (int j = 0; j < 64; j++) m[(j + 1) >> 3] |= (u64)beta[j] << (8 * ((j + 1) & 7));
  m[0] |= 'L';
  blake2b_256_words(m, 65, lw);
  for (int j = 0; j < 32; j++) lv[j] = (u8)(lw[j >> 3] >> (8 * (j & 7)));
  fs_pool_bytes(a, p, FS_LO, 32, lo);
  fs_pool_bytes(a, p, FS_HI, 32, hi);
  const bool win = lt_be32(lv, lo);
  const bool amb = !win && lt_be32(lv, hi);
  u8 *o = a.out + (size_t)i * FS_OUT;
  for (int j = 0; j < 64; j++) o[FS_BETA + j] = beta[j];
  o[FS_WIN] = win ? 1 : 0;
  o[FS_AMB] = amb ? 1 : 0;
}

// SHA-512 over `nb` padded 128-byte blocks at `blocks`; with `hole`, the
// first 64 message bytes are the hole's (the challenge's R ‖ A)
PK_DEV void fs_sha512_rows(const u8 *blocks, int nb, const u8 *hole, u8 *out) {
  u64 st[8], w[16];
  sha512_init(st);
#pragma unroll 1
  for (int b = 0; b < nb; b++) {
    for (int t = 0; t < 16; t++) {
      u64 x = 0;
      for (int j = 0; j < 8; j++) {
        const int k = 128 * b + 8 * t + j;
        x = (x << 8) | (hole != nullptr && k < 64 ? hole[k] : PK_LDG(blocks + k));
      }
      w[t] = x;
    }
    sha512_compress(st, w);
  }
  sha512_digest(st, out);
}

// Ed25519 sign of lane i: r = SHA-512(prefix ‖ M) mod L, R = r·B, h =
// SHA-512(R ‖ A ‖ M) mod L, s = r + h·a mod L -> out[i] = R ‖ s. The
// message blocks [B][NB][128] (rblocks: prefix ‖ M padded; hblocks: a
// 64-byte hole ‖ M padded), the block counts per lane
PK_DEV void ed_sign_lane(int i, int NB, const u32 *base8, const u8 *a, const u8 *aenc,
                         const u8 *rblocks, const int32_t *rnb, const u8 *hblocks,
                         const int32_t *hnb, u8 *out) {
  u8 dg[64], r[32], hole[64], h[32], sa[32], ha[32], s[32];
  fs_sha512_rows(rblocks + (size_t)i * NB * 128, rnb[i], nullptr, dg);
  sc_reduce512(dg, r);
  ge rp = ge_base_mul_w8(base8, r);
  ge_compress_many(&rp, 1, hole);
  for (int k = 0; k < 32; k++) {
    hole[32 + k] = PK_LDG(aenc + (size_t)i * 32 + k);
    sa[k] = PK_LDG(a + (size_t)i * 32 + k);
  }
  fs_sha512_rows(hblocks + (size_t)i * NB * 128, hnb[i], hole, dg);
  sc_reduce512(dg, h);
  sc_mul<8>(h, sa, ha);
  sc_add(r, ha, s);
  u8 *o = out + (size_t)i * 64;
  for (int k = 0; k < 32; k++) {
    o[k] = hole[k];
    o[32 + k] = s[k];
  }
}
