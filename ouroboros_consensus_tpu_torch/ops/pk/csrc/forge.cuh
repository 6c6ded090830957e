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
// sweep runs 32 lanes a block over two warps: the Γ warp hashes to the
// curve and runs x·H; the k warp hashes to the curve, compresses H, derives
// the nonce k and runs k·B and k·H; they meet at one barrier, after which
// the k warp compresses Γ, k·B, k·H and 8Γ on one inversion (Montgomery's
// trick) and hashes the challenge, β and the leader value. Each role is
// its own function of (lane, scratch), so the host build runs the roles of
// a group of 32 lanes one after another (csrc/host_emu.cpp) and the CPU
// tests hold them to the twins (ops/pk/prove.py).
#pragma once
#include "stages.cuh"

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

// lane-minor point rows of the block's 32 lanes: limb l of coordinate c
// at w[(10 c + l) * 32 + lane]
struct ForgeScratch {
  u32 gamma[40 * PK_GROUP];  // Γ = x·H (the Γ warp)
  u32 kb[40 * PK_GROUP];     // k·B, k·H, H's encoding and k (the k warp)
  u32 kh[40 * PK_GROUP];
  u8 henc[32 * PK_GROUP];
  u8 k[32 * PK_GROUP];
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

// the Γ warp: Γ = x·H, x the clamped expanded seed (256 bits, not
// reduced mod L: 64 digits recode to 65, the first 0 or 1)
PK_DEV void fs_role_gamma(int i, int lane, const ForgeArgs &a, ForgeScratch &sc) {
  u8 pk[32], x[32], d[64];
  ge h = fs_hash_h(i, a, pk);
  fs_pool_bytes(a, i % a.P, FS_X, 32, x);
  nibbles_msb(x, 32, d);
  LocalTab tab;
  ge_table8(tab, h);
  fs_put(sc.gamma, lane, ge_scalar_mul_w4(d, 64, tab));
}

// the k warp: H's encoding, k = SHA-512(prefix ‖ H) mod L, k·B and k·H
PK_DEV void fs_role_k(int i, int lane, const ForgeArgs &a, const u32 *base8,
                      ForgeScratch &sc) {
  u8 pk[32], prefix[32], dg[64], d[64];
  u8 *henc = sc.henc + 32 * lane, *k = sc.k + 32 * lane;
  ge h = fs_hash_h(i, a, pk);
  ge_compress_many(&h, 1, henc);
  fs_pool_bytes(a, i % a.P, FS_PREFIX, 32, prefix);
  sha512_msg<64>([&](int j) -> u8 { return j < 32 ? prefix[j] : henc[j - 32]; }, dg);
  sc_reduce512(dg, k);
  fs_put(sc.kb, lane, ge_base_mul_w8(base8, k));
  nibbles_msb(k, 32, d);
  LocalTab tab;
  ge_table8(tab, h);
  fs_put(sc.kh, lane, ge_scalar_mul_w4(d, 64, tab));
}

// after the barrier, on the k warp: Γ, U = k·B, V = k·H and 8Γ compressed
// on one inversion; c = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖ V)[:16], s = k +
// c·x mod L, β = SHA-512(suite ‖ 3 ‖ 8Γ), the leader value Blake2b-256('L'
// ‖ β) against the pool's rows: win = lv < lo, amb = !win && lv < hi
PK_DEV void fs_finish(int i, int lane, const ForgeArgs &a, const ForgeScratch &sc) {
  const int p = i % a.P;
  ge pts[4];
  pts[0] = fs_get(sc.gamma, lane);
  pts[1] = fs_get(sc.kb, lane);
  pts[2] = fs_get(sc.kh, lane);
  pts[3] = ge_mul_cofactor(pts[0]);
  u8 enc[128], dg[64], x[32], cx[32], s[32], beta[64], lo[32], hi[32];
  ge_compress_many(pts, 4, enc);
  const u8 *henc = sc.henc + 32 * lane, *k = sc.k + 32 * lane;
  sha512_msg<130>([&](int j) -> u8 {
    return j == 0 ? 0x04 : j == 1 ? 0x02 : j < 34 ? henc[j - 2] : enc[j - 34];
  }, dg);
  fs_pool_bytes(a, p, FS_X, 32, x);
  sc_mul<4>(dg, x, cx);
  sc_add(k, cx, s);
  vrf_beta(enc + 96, beta);
  u64 m[16], lw[4];
  for (int t = 0; t < 16; t++) m[t] = 0;
  for (int j = 0; j < 64; j++) m[(j + 1) >> 3] |= (u64)beta[j] << (8 * ((j + 1) & 7));
  m[0] |= 'L';
  blake2b_256_words(m, 65, lw);
  u8 lv[32];
  for (int j = 0; j < 32; j++) lv[j] = (u8)(lw[j >> 3] >> (8 * (j & 7)));
  fs_pool_bytes(a, p, FS_LO, 32, lo);
  fs_pool_bytes(a, p, FS_HI, 32, hi);
  const bool win = lt_be32(lv, lo);
  const bool amb = !win && lt_be32(lv, hi);
  u8 *o = a.out + (size_t)i * FS_OUT;
  for (int j = 0; j < 32; j++) {
    o[FS_G + j] = enc[j];
    o[FS_U + j] = enc[32 + j];
    o[FS_V + j] = enc[64 + j];
    o[FS_S + j] = s[j];
  }
  for (int j = 0; j < 16; j++) o[FS_C + j] = dg[j];
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
