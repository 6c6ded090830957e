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

// ---------------------------------------------------------------------------
// ed_sign: RFC 8032 Ed25519 signing, 32 signables a block on eight warps
// ---------------------------------------------------------------------------
//
// Signable i: r = SHA-512(prefix ‖ M) mod L, R = r·B, h = SHA-512(R ‖ A ‖
// M) mod L, s = r + h·a mod L -> out[i] = R ‖ s. Its messages come padded,
// [B][NB][128] bytes a side (rblocks: prefix ‖ M; hblocks: a 64-byte hole
// ‖ M, the hole R ‖ A filled here), with a block count each (rnb, hnb).
// Slot s of a block is signable 32·blockIdx + s; slots past B run along
// as signable B - 1 (or skip R = r·B, below) and write nothing.
//
//   warp 0, a thread a slot: the block counts checked (a count outside
//     1..NB flags the block in bad[] and is clamped for the reads, so
//     nothing is read past NB; the wrapper raises), r's hash and r mod L
//     into shared memory (es_r);
//   warps 1-7 beside it: h's first ES_HB blocks and a ‖ A of every slot
//     into shared memory (es_stage), so that h's hash waits on R alone;
//   every warp: R = r·B as a team of ES_TEAM threads a slot, four teams a
//     warp: thread j walks windows ES_WIN·j .. ES_WIN·j + ES_WIN - 1 of
//     the fixed-base table (affine entries: 8 products an addition, the
//     next entry loaded while it adds), then the team sums its eight
//     parts pairwise in three levels through shared memory (es_walk,
//     es_level_*). The extended addition is complete, so an identity
//     entry (a zero byte of r) takes no branch; the gather of r's entries
//     is the only access that depends on r. A warp whose four slots all
//     lie past B skips this step (es_warp_live: a test of B alone) and
//     leaves its slots' R the identity, so a launch of two signables adds
//     on warp 0 alone;
//   warp 0: R's Z of every slot a leaf of one product tree whose root the
//     warp inverts as a field element over ten lanes (fs_tree, w_inv),
//     then R's encoding, h's hash, h mod L and s on a thread a slot
//     (es_finish).
//
// Each step is a function of (thread, scratch), so the host build runs a
// block's steps one after another in an order the barriers allow
// (csrc/host_emu.cpp) and the CPU tests hold it to the twin
// (ops/pk/prove.py: ed_sign_plain).
#define ES_TEAM 8                        // threads a slot in R = r·B
#define ES_THREADS (ES_TEAM * PK_GROUP)  // 256: eight warps, four teams a warp
#define ES_WIN (32 / ES_TEAM)            // fixed-base windows a thread walks
#define ES_HB 3                          // h's blocks staged in shared memory a slot
#define ES_HROW (128 * ES_HB + 16)       // a staged row, padded against bank conflicts
#define ES_AROW 80                       // a ‖ A a slot, padded
#define ES_NSTAMP 7

struct SignArgs {
  int B, NB;
  const u32 *base8;         // [32][256][40] limbs, affine entries (x, y, 1, xy)
  const u8 *a, *aenc;       // [B][32]: the clamped secret scalar, the public key
  const u8 *rblocks;        // [B][NB][128]
  const int32_t *rnb;       // [B]
  const u8 *hblocks;        // [B][NB][128]
  const int32_t *hnb;       // [B]
  u8 *out;                  // [B][64]: R ‖ s
  int32_t *bad;             // [ceil(B / 32)]: 1 where a block count of the block is out of range
};

// what the steps hand on; 43 KB
struct SignScratch {
  u8 hb[PK_GROUP * ES_HROW];   // h's first min(NB, ES_HB) blocks a slot
  u8 ak[PK_GROUP * ES_AROW];   // a ‖ A a slot
  u32 x[ES_TEAM / 2 * 40 * PK_GROUP];  // the teams' exchange: four points a team
  u32 pts[30 * PK_GROUP];      // R's X, Y, Z a slot
  u32 node[10 * FS_TN];        // the tree of R's Z (a zero leaf holds 1)
  u8 r[32 * PK_GROUP];         // r a slot, lane-minor
  u8 zero[FS_LEAVES];
};

#ifdef ES_STAMPS
// the instrument build (ed_sign_stamps.cu): clock64 into stamps[i][k] at
// the end of phase k of signable i, after a value the phase computed
#define ES_STAMP(live, i, k, dep)                                         \
  do {                                                                    \
    asm volatile("" ::"r"((u32)(dep)) : "memory");                        \
    if (live) stamps[(size_t)(i) * ES_NSTAMP + (k)] = clock64();          \
  } while (0)
#else
#define ES_STAMP(live, i, k, dep) ((void)0)
#endif

// a block count clamped to 1..NB (NB >= 1: the wrapper refuses NB = 0)
PK_DEV int es_clamp(int n, int NB) { return n < 1 ? 1 : n > NB ? NB : n; }

// 16 bytes from src to dst, both 16-byte aligned (src in global memory)
PK_DEV void es_copy16(u8 *dst, const u8 *src) {
#ifdef PK_HOST
  for (int k = 0; k < 16; k++) dst[k] = src[k];
#else
  *reinterpret_cast<uint4 *>(dst) = __ldg(reinterpret_cast<const uint4 *>(src));
#endif
}

// words t0 .. t0 + 2n - 1 of a SHA-512 block, big-endian, from the
// 16n bytes at p (16-byte aligned; global memory with `ldg`, else shared)
template <bool LDG>
PK_DEV void es_words(const u8 *p, u64 *w, int t0, int n) {
#ifdef PK_HOST
  for (int t = t0; t < t0 + 2 * n; t++) {
    u64 x = 0;
    for (int k = 0; k < 8; k++) x = (x << 8) | p[8 * (t - t0) + k];
    w[t] = x;
  }
#else
  const uint4 *q = reinterpret_cast<const uint4 *>(p);
#pragma unroll
  for (int c = 0; c < n; c++) {
    const uint4 v = LDG ? __ldg(q + c) : q[c];
    w[t0 + 2 * c] = (u64)__byte_perm(v.x, 0, 0x0123) << 32 | __byte_perm(v.y, 0, 0x0123);
    w[t0 + 2 * c + 1] = (u64)__byte_perm(v.z, 0, 0x0123) << 32 | __byte_perm(v.w, 0, 0x0123);
  }
#endif
}

// warps 1-7, thread t of 224 (the host's one pass: each t in turn): h's
// first min(NB, ES_HB) blocks and a ‖ A of the block's 32 slots into
// shared memory, 16 bytes a copy
PK_DEV void es_stage(int t, int g, const SignArgs &a, SignScratch &sc) {
  const int nbs = a.NB < ES_HB ? a.NB : ES_HB, per = 8 * nbs + 4;
  for (int c = t; c < PK_GROUP * per; c += ES_THREADS - PK_GROUP) {
    const int slot = c / per, k = c % per;
    const int ii = g + slot < a.B ? g + slot : a.B - 1;
    if (k < 8 * nbs) {
      es_copy16(sc.hb + slot * ES_HROW + 16 * k, a.hblocks + (size_t)ii * a.NB * 128 + 16 * k);
    } else {
      const int q = k - 8 * nbs;  // 0, 1: a; 2, 3: A
      es_copy16(sc.ak + slot * ES_AROW + 16 * q,
                (q < 2 ? a.a : a.aenc) + (size_t)ii * 32 + 16 * (q & 1));
    }
  }
}

// warp 0, a thread a slot: the counts checked, r = SHA-512(prefix ‖ M) mod
// L into sc.r; -> whether a count of a live slot lies outside 1..NB
PK_DEV bool es_r(int lane, int g, const SignArgs &a, SignScratch &sc, u64 *stamps) {
  const int i = g + lane;
  const bool live = i < a.B;
  const int ii = live ? i : a.B - 1;
  (void)stamps;
  ES_STAMP(live, i, 0, 0);
  const int rn = a.rnb[ii], hn = a.hnb[ii];
  const bool bad = live && (rn < 1 || rn > a.NB || hn < 1 || hn > a.NB);
  const int nr = es_clamp(rn, a.NB);
  const u8 *rows = a.rblocks + (size_t)ii * a.NB * 128;
  u64 st[8], w[16];
  u8 dg[64], r[32];
  sha512_init(st);
#pragma unroll 1
  for (int b = 0; b < nr; b++) {
    es_words<true>(rows + 128 * b, w, 0, 8);
    sha512_compress(st, w);
  }
  sha512_digest(st, dg);
  ES_STAMP(live, i, 1, dg[0]);
  sc_reduce512(dg, r);
  for (int k = 0; k < 32; k++) sc.r[(k << 5) + lane] = r[k];
  ES_STAMP(live, i, 2, r[0]);
  return bad;
}

// whether thread t's warp holds a slot below B (g the block's first)
PK_DEV bool es_warp_live(int t, int g, int B) { return g + (t & ~31) / ES_TEAM < B; }

// window w's entry for digit d: X, Y, T and 2d·T (Z is 1)
struct esent { fe x, y, t, t2d; };

PK_DEV esent es_entry(const u32 *table, int w, int d) {
  const u32 *e = table + ((size_t)w * 256 + d) * 40;
  esent p;
#ifdef PK_HOST
  for (int l = 0; l < 10; l++) {
    p.x.v[l] = e[l];
    p.y.v[l] = e[10 + l];
    p.t.v[l] = e[30 + l];
  }
#else
  // 16-byte loads: X and Y are words 0-19, T words 30-39 (in 28-39)
  const uint4 *q = reinterpret_cast<const uint4 *>(e);
  u32 v[40];
#pragma unroll
  for (int c = 0; c < 10; c++) {
    if (c == 5 || c == 6) continue;  // Z alone
    const uint4 u = __ldg(q + c);
    v[4 * c] = u.x; v[4 * c + 1] = u.y; v[4 * c + 2] = u.z; v[4 * c + 3] = u.w;
  }
#pragma unroll
  for (int l = 0; l < 10; l++) {
    p.x.v[l] = v[l];
    p.y.v[l] = v[10 + l];
    p.t.v[l] = v[30 + l];
  }
#endif
  p.t2d = fe_mul(p.t, fe_const(PK_D2));
  return p;
}

// q + p for p affine (Z = 1): ge_add with Z1·Z2 = Z1 and p's 2d·T formed
// at its load, off q's chain
PK_DEV ge es_madd(const ge &q, const esent &p) {
  const fe a = fe_mul(fe_sub(q.y, q.x), fe_sub(p.y, p.x));
  const fe b = fe_mul(fe_add(q.y, q.x), fe_add(p.y, p.x));
  const fe c = fe_mul(q.t, p.t2d);
  const fe d = fe_add(q.z, q.z);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g); r.t = fe_mul(e, h);
  return r;
}

// thread t of the block (slot t / ES_TEAM, part j = t % ES_TEAM): the sum
// of windows ES_WIN·j .. ES_WIN·j + ES_WIN - 1 of r·B, every window added
// (a zero digit's entry is the identity), each entry loaded a step ahead
PK_NOINLINE ge es_walk(int t, const u32 *table, const SignScratch &sc) {
  const int s = t / ES_TEAM, w0 = ES_WIN * (t % ES_TEAM);
  esent cur = es_entry(table, w0, sc.r[(w0 << 5) + s]);
  ge q;
  q.x = cur.x;
  q.y = cur.y;
  q.z = fe_one();
  q.t = cur.t;
  cur = es_entry(table, w0 + 1, sc.r[((w0 + 1) << 5) + s]);
#pragma unroll 1
  for (int k = 2; k <= ES_WIN; k++) {
    const esent p = cur;
    if (k < ES_WIN) cur = es_entry(table, w0 + k, sc.r[((w0 + k) << 5) + s]);
    q = es_madd(q, p);
  }
  return q;
}

// a team's point in the exchange, lane-minor: coordinate c limb l of
// point k of slot s at x[((40 k + 10 c + l) << 5) + s]
PK_DEV void es_put(u32 *x, int k, int s, const ge &p) {
  u32 *w = x + 40 * PK_GROUP * k + s;
  for (int l = 0; l < 10; l++) {
    w[(l) << 5] = p.x.v[l];
    w[(10 + l) << 5] = p.y.v[l];
    w[(20 + l) << 5] = p.z.v[l];
    w[(30 + l) << 5] = p.t.v[l];
  }
}

PK_DEV ge es_get(const u32 *x, int k, int s) {
  const u32 *w = x + 40 * PK_GROUP * k + s;
  ge p;
  for (int l = 0; l < 10; l++) {
    p.x.v[l] = w[(l) << 5];
    p.y.v[l] = w[(10 + l) << 5];
    p.z.v[l] = w[(20 + l) << 5];
    p.t.v[l] = w[(30 + l) << 5];
  }
  return p;
}

// level d (1, 2, ...) of a team's pairwise sum: part j with j mod 2d = d
// puts its point, part j with j mod 2d = 0 adds it (the host: every put
// of the level before every add)
PK_DEV void es_level_put(int t, int d, const ge &p, SignScratch &sc) {
  const int j = t % ES_TEAM;
  if (j % (2 * d) == d) es_put(sc.x, j / (2 * d), t / ES_TEAM, p);
}

PK_DEV void es_level_add(int t, int d, ge &p, const SignScratch &sc) {
  const int j = t % ES_TEAM;
  if (j % (2 * d) == 0) p = ge_add(p, es_get(sc.x, j / (2 * d), t / ES_TEAM));
}

// part 0 of slot s, after the team's sum: R's X, Y, Z for the finish and
// its Z a leaf of the block's tree
PK_DEV void es_publish(int s, const ge &p, SignScratch &sc) {
  for (int l = 0; l < 10; l++) {
    sc.pts[(l << 5) + s] = p.x.v[l];
    sc.pts[((10 + l) << 5) + s] = p.y.v[l];
    sc.pts[((20 + l) << 5) + s] = p.z.v[l];
  }
  fs_tree_leaf(sc.node, sc.zero, s, p.z);
}

// warp 0, a thread a slot, after the tree: R's encoding from its Z's
// inverse, h = SHA-512(R ‖ A ‖ M) mod L (the staged blocks from shared
// memory, any later ones from global), s = r + h·a mod L -> out[i]
PK_NOINLINE void es_finish(int lane, int g, const SignArgs &a, const SignScratch &sc,
                           u64 *stamps) {
  const int i = g + lane;
  const bool live = i < a.B;
  const int ii = live ? i : a.B - 1;
  (void)stamps;
  const fe iz = fs_tree_inv(sc.node, sc.zero, lane);
  u8 rb[32], xb[32];
  fe_to_bytes(xb, fe_mul(fs_get_fe(sc.pts, 0, lane), iz));
  fe_to_bytes(rb, fe_mul(fs_get_fe(sc.pts, 1, lane), iz));
  rb[31] |= (u8)((xb[0] & 1) << 7);
  ES_STAMP(live, i, 4, rb[31]);
  const int nh = es_clamp(a.hnb[ii], a.NB);
  const u8 *row = sc.hb + lane * ES_HROW, *ak = sc.ak + lane * ES_AROW;
  u64 st[8], w[16];
  u8 dg[64], h[32], sa[32], r[32], ha[32], s[32];
  sha512_init(st);
#pragma unroll 1
  for (int b = 0; b < nh; b++) {
    if (b == 0) {  // R ‖ A ‖ the block's last 64 bytes
      for (int t = 0; t < 4; t++) {
        u64 x = 0;
        for (int k = 0; k < 8; k++) x = (x << 8) | rb[8 * t + k];
        w[t] = x;
      }
      es_words<false>(ak + 32, w, 4, 2);
      es_words<false>(row + 64, w, 8, 4);
    } else if (b < ES_HB) {
      es_words<false>(row + 128 * b, w, 0, 8);
    } else {
      es_words<true>(a.hblocks + ((size_t)ii * a.NB + b) * 128, w, 0, 8);
    }
    sha512_compress(st, w);
  }
  sha512_digest(st, dg);
  ES_STAMP(live, i, 5, dg[0]);
  sc_reduce512(dg, h);
  for (int k = 0; k < 32; k++) {
    sa[k] = ak[k];
    r[k] = sc.r[(k << 5) + lane];
  }
  sc_mul<8>(h, sa, ha);
  sc_add(r, ha, s);
  ES_STAMP(live, i, 6, s[0]);
  if (!live) return;
  u8 *o = a.out + (size_t)i * 64;
  for (int k = 0; k < 32; k++) {
    o[k] = rb[k];
    o[32 + k] = s[k];
  }
}
