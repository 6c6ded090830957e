// Per-lane bodies of the six Praos stage kernels. Column arrays are
// limb-first int32 [rows][B]: element (row r, lane i) at r * B + i, so a
// warp's 32 lanes read 32 neighbouring words of each row. Points cross
// stages as 40 rows (X, Y, Z, T, 10 limbs each, radix 2^25.5).
//
// Every stage kernel runs one lane over a group of warps of one block, 32
// lanes a block: first the independent parts of a lane run on different
// warps ("roles"; tables, s·B, hashes, decompressions, compressions),
// meeting in a per-block scratch struct in shared memory (tables
// lane-minor, see LaneTab) at a barrier; then in ed, kes and
// vrf_ladders each long ladder runs on four warps as a quad (pk.cuh), one
// product of every point operation per warp. Each role is its own function
// of (lane index, scratch), so the host build runs the roles of a group of
// 32 lanes one after another (csrc/host_emu.cpp) and the CPU tests hold
// them to the twins.
#pragma once
#include "pk.cuh"

// lanes of a role-split block: one warp per role
#define PK_GROUP 32

PK_DEV void load_bytes(const int32_t *col, int rows, int i, int B, u8 *out) {
  for (int r = 0; r < rows; r++) out[r] = (u8)col[(size_t)r * B + i];
}

PK_DEV void store_bytes(int32_t *col, int rows, int i, int B, const u8 *in) {
  for (int r = 0; r < rows; r++) col[(size_t)r * B + i] = in[r];
}

PK_DEV ge load_point(const int32_t *col, int i, int B) {
  ge p;
  for (int k = 0; k < 10; k++) {
    p.x.v[k] = (u32)col[(size_t)k * B + i];
    p.y.v[k] = (u32)col[(size_t)(10 + k) * B + i];
    p.z.v[k] = (u32)col[(size_t)(20 + k) * B + i];
    p.t.v[k] = (u32)col[(size_t)(30 + k) * B + i];
  }
  return p;
}

PK_DEV void store_point(int32_t *col, int i, int B, const ge &p) {
  for (int k = 0; k < 10; k++) {
    col[(size_t)k * B + i] = (int32_t)p.x.v[k];
    col[(size_t)(10 + k) * B + i] = (int32_t)p.y.v[k];
    col[(size_t)(20 + k) * B + i] = (int32_t)p.z.v[k];
    col[(size_t)(30 + k) * B + i] = (int32_t)p.t.v[k];
  }
}

// bytes 8j .. 8j + 7 of lane i's column as a little-endian word
PK_DEV u64 col_word(const int32_t *col, int j, int i, int B) {
  u64 x = 0;
  for (int k = 7; k >= 0; k--) x = (x << 8) | (u8)col[(size_t)(8 * j + k) * B + i];
  return x;
}

// CompactSum Merkle walk, its hashes on words: bit l of the period puts
// the running vk on the right; siblings are indexed by level, so any
// period value reads in bounds. -> root == vk and 0 <= period < 2^depth
PK_NOINLINE bool kes_merkle(int i, int B, int depth, const int32_t *vk,
                            const int32_t *period, const int32_t *leaf,
                            const int32_t *sib) {
  u64 cur[4], m[16];
  for (int j = 0; j < 4; j++) cur[j] = col_word(leaf, j, i, B);
  for (int j = 8; j < 16; j++) m[j] = 0;
  const int32_t per = period[i];
#pragma unroll 1
  for (int l = 0; l < depth; l++) {
    bool right = ((per >> l) & 1) == 1;
    for (int j = 0; j < 4; j++) {
      u64 sv = col_word(sib + (size_t)l * 32 * B, j, i, B);
      m[j] = right ? sv : cur[j];
      m[4 + j] = right ? cur[j] : sv;
    }
    blake2b_256_words(m, 64, cur);
  }
  bool ok = true;
  for (int j = 0; j < 4; j++) ok = ok && cur[j] == col_word(vk, j, i, B);
  return ok && per >= 0 && per < (1 << depth);
}

// The Ed25519 verify-point P = s·B − h·A, h = SHA-512(R ‖ A ‖ M) mod L,
// over the four warps of a block, shared by ed and kes (whose A is the
// leaf key). Phase 1, beside each other: the SHA-512 and its reduction h
// (role 0), the decompression of A and the table of −A (role 1), s·B
// (role 2); kes adds its Merkle walk (role 3), ed leaves the warp idle.
// Phase 2: the 65-digit h·(−A) chain and P = s·B − h·A, on the four warps
// as a quad (ed_quad_chain).
struct EdScratch {
  u32 tab[PK_LANETAB_WORDS];  // table of −A
  int32_t sb[40 * PK_GROUP];  // s·B, as a 32-lane point column
  u32 h[32 * PK_GROUP];       // h bytes
  int32_t ok[3 * PK_GROUP];   // A decodes, s < L; kes: root and period
  u32 qx[PK_QUAD_WORDS];      // the quad's exchange area
};

template <class S>
PK_DEV void ed_role_hash(int i, int B, int lane, const int32_t *hb, int nb,
                         const int32_t *hnb, S &sc) {
  u8 dig[64], h[32];
  sha512_columns(hb, nb, hnb[i], i, B, dig);
  sc_reduce512(dig, h);
  for (int k = 0; k < 32; k++) sc.h[(k << 5) + lane] = h[k];
}

PK_DEV void ed_role_table(int i, int B, int lane, const int32_t *key,
                          EdScratch &sc) {
  u8 kb[32];
  load_bytes(key, 32, i, B, kb);
  ge a;
  sc.ok[lane] = ge_decompress(a, kb) ? 1 : 0;
  LaneTab tab{sc.tab, lane};
  ge_table8(tab, ge_neg(a));
}

PK_DEV void ed_role_base(int i, int B, int lane, const u32 *base8,
                         const int32_t *s, EdScratch &sc) {
  u8 sb[32];
  load_bytes(s, 32, i, B, sb);
  sc.ok[PK_GROUP + lane] = sc_lt_l(sb) ? 1 : 0;
  store_point(sc.sb, lane, PK_GROUP, ge_base_mul_w8(base8, sb));
}

PK_DEV void kes_role_merkle(int i, int B, int lane, int depth,
                            const int32_t *vk, const int32_t *period,
                            const int32_t *leaf, const int32_t *sib,
                            EdScratch &sc) {
  sc.ok[2 * PK_GROUP + lane] = kes_merkle(i, B, depth, vk, period, leaf, sib) ? 1 : 0;
}

// P = s·B − h·A from the phase-1 scratch, on the quad of the block's four
// warps (every warp holds P after the last step)
PK_DEV ge ed_quad_point(EdScratch &sc, Quad &qd) {
  int lane = qd.lane;
  u8 h[32], hd[64];
  for (int k = 0; k < 32; k++) h[k] = (u8)sc.h[(k << 5) + lane];
  nibbles_msb(h, 32, hd);
  LaneTab tab{sc.tab, lane};
  ge nha = qscalar_mul_w4(qd, hd, 64, tab);
  ge p;
  qadd(qd, p, load_point(sc.sb, lane, PK_GROUP), nha);
  return p;
}

// phase 2 on the quad of the block's four warps; ok ANDs the first
// `flags` rows of sc.ok (ed 2, kes 3); lanes past B (live false) run
// along for the barriers and store nothing
PK_DEV void ed_quad_chain(int i, int B, bool live, int flags, EdScratch &sc,
                          Quad &qd, int32_t *ok, int32_t *pt) {
  int lane = qd.lane;
  ge p = ed_quad_point(sc, qd);
  if (live && qd.w <= 0) {
    store_point(pt, i, B, p);
    int32_t o = 1;
    for (int f = 0; f < flags; f++) o &= sc.ok[f * PK_GROUP + lane];
    ok[i] = o;
  }
}

// ed_verify (csrc/ed_verify.cu) over the four warps of a block. Phase 1,
// beside each other, each warp's share near one exponentiation: the
// SHA-512 and its reduction h, then s·B's windows below EDV_W0 (warp 0);
// A's decompression (warp 1); R's decompression (warp 2); s < L and s·B's
// windows EDV_W0 .. EDV_W1 - 1 (warp 3). Phase 2 on a quad of one exchange
// buffer (pk.cuh: Quad1): the two parts of s·B added, the table of −A
// (seven additions, each warp storing one coordinate of each entry), the
// h·(−A) chain, s·B's last windows walked onto it, the parts' sum added,
// then one step forms x_R·Z_P and y_R·Z_P, and P = R iff X_P = x_R·Z_P and
// Y_P = y_R·Z_P. R's decoding refuses y >= p, an off-curve y and x = 0
// with the sign bit set, exactly the encodings no canonical compression
// equals, and a decoded R is the one point whose compression is R's
// bytes; so the projective compare is RFC 8032's compress(P) == R, with no
// inversion on the path.
#define EDV_W0 10  // s·B's windows below EDV_W0 on warp 0,
#define EDV_W1 25  // then below EDV_W1 on warp 3, the rest on the quad
enum { EDV_OK_A, EDV_OK_S, EDV_OK_R, EDV_OK_N };
struct VerifyScratch {
  u32 tab[PK_LANETAB_WORDS];  // table of −A (built on the quad); in phase 1
                              // warp 0's part of s·B and −A's point rows
  int32_t sb[40 * PK_GROUP];  // warp 3's part of s·B, then both parts' sum
  u32 r[20 * PK_GROUP];       // R's affine x, y (limb-major, lane-minor)
  u8 h[32 * PK_GROUP];        // h bytes
  int32_t ok[EDV_OK_N * PK_GROUP];
  u32 qx[PK_TEAM1_WORDS];     // the quad's exchange area
};

// the table's space in phase 1: warp 0's part of s·B, then −A's rows
PK_DEV int32_t *edv_part0(VerifyScratch &sc) { return (int32_t *)sc.tab; }
PK_DEV int32_t *edv_neg_a(VerifyScratch &sc) { return (int32_t *)sc.tab + 40 * PK_GROUP; }

// s·B's windows w0 .. w1 - 1 into a part's rows
PK_DEV void edv_base_part(int i, int B, int lane, const u32 *base8, const int32_t *s, int w0,
                          int w1, int32_t *part) {
  u8 sb[32];
  load_bytes(s, 32, i, B, sb);
  store_point(part, lane, PK_GROUP, ge_base_mul_w8(base8, sb, w0, w1));
}

// warp 1: A decoded (and whether it decodes), −A for the quad's table
PK_DEV void edv_role_a(int i, int B, int lane, const int32_t *key, VerifyScratch &sc) {
  u8 kb[32];
  load_bytes(key, 32, i, B, kb);
  ge a;
  sc.ok[EDV_OK_A * PK_GROUP + lane] = ge_decompress(a, kb) ? 1 : 0;
  store_point(edv_neg_a(sc), lane, PK_GROUP, ge_neg(a));
}

// warp 2: R decoded (its affine x and y, and whether it decodes)
PK_DEV void edv_role_r(int i, int B, int lane, const int32_t *r, VerifyScratch &sc) {
  u8 rb[32];
  load_bytes(r, 32, i, B, rb);
  ge rp;
  sc.ok[EDV_OK_R * PK_GROUP + lane] = ge_decompress(rp, rb) ? 1 : 0;
  for (int l = 0; l < 10; l++) {
    sc.r[l * PK_GROUP + lane] = rp.x.v[l];
    sc.r[(10 + l) * PK_GROUP + lane] = rp.y.v[l];
  }
}

// warp 3: s < L, and s·B's windows EDV_W0 .. EDV_W1 - 1
PK_DEV void edv_role_s(int i, int B, int lane, const u32 *base8, const int32_t *s,
                       VerifyScratch &sc) {
  u8 sb[32];
  load_bytes(s, 32, i, B, sb);
  sc.ok[EDV_OK_S * PK_GROUP + lane] = sc_lt_l(sb) ? 1 : 0;
  store_point(sc.sb, lane, PK_GROUP, ge_base_mul_w8(base8, sb, EDV_W0, EDV_W1));
}

// phase 2's start on the quad: −A and both parts read (the quad's first
// step waits for every warp's reads, so the table may then write over
// them), the parts' sum into sc.sb (warp 0, the host's one pass), then
// the table of −A (pk.cuh: qtable8)
PK_DEV void edv_quad_table(VerifyScratch &sc, Quad1 &qd) {
  const int lane = qd.lane;
  const ge na = load_point(edv_neg_a(sc), lane, PK_GROUP);
  ge sum;
  qadd(qd, sum, load_point(edv_part0(sc), lane, PK_GROUP), load_point(sc.sb, lane, PK_GROUP));
  if (qd.w <= 0) store_point(sc.sb, lane, PK_GROUP, sum);
  LaneTab tab{sc.tab, lane};
  qtable8(qd, tab, na);
}

// the h·(−A) chain on the quad after the table
PK_DEV ge edv_quad_chain(VerifyScratch &sc, Quad1 &qd) {
  const int lane = qd.lane;
  u8 h[32], hd[64];
  for (int k = 0; k < 32; k++) h[k] = sc.h[(k << 5) + lane];
  nibbles_msb(h, 32, hd);
  LaneTab tab{sc.tab, lane};
  return qscalar_mul_w4(qd, hd, 64, tab);
}

// P = h·(−A) + s·B: s·B's windows from EDV_W1 walked onto the chain's
// point, then the phase-1 parts' sum added (every warp holds P after the
// last step)
PK_DEV ge edv_quad_sb(int i, int B, const u32 *base8, const int32_t *s, const ge &nha,
                      VerifyScratch &sc, Quad1 &qd) {
  u8 sb[32];
  load_bytes(s, 32, i, B, sb);
  ge p = qbase_mul_w8(qd, base8, sb, nha, EDV_W1);
  qadd(qd, p, p, load_point(sc.sb, qd.lane, PK_GROUP));
  return p;
}

// the compare on the quad: one step forms x_R·Z_P (products 0, 2) and
// y_R·Z_P (1, 3); warp 0 (the host's one pass) stores ok = A decodes ∧
// s < L ∧ R decodes ∧ P = R. Lanes past B (live false) run along for the
// barrier and store nothing.
PK_DEV void edv_quad_compare(int i, bool live, const ge &p, VerifyScratch &sc, Quad1 &qd,
                             int32_t *ok) {
  const int lane = qd.lane;
  fe rz[4];
  quad_step(qd, rz, [&](int k) {
    fe c;
    for (int l = 0; l < 10; l++) c.v[l] = sc.r[((k & 1) * 10 + l) * PK_GROUP + lane];
    return fe_mul(c, p.z);
  });
  if (live && qd.w <= 0) {
    bool eq = sc.ok[EDV_OK_A * PK_GROUP + lane] != 0 && sc.ok[EDV_OK_S * PK_GROUP + lane] != 0 &&
              sc.ok[EDV_OK_R * PK_GROUP + lane] != 0;
    ok[i] = eq && fe_eq(p.x, rz[0]) && fe_eq(p.y, rz[1]) ? 1 : 0;
  }
}

// single-chain Elligator2 (one exponentiation), projective output
PK_NOINLINE ge elligator2(fe r) {
  fe one = fe_one(), zero = fe_zero();
  fe r2 = fe_sq(r);
  fe w_den = fe_add(fe_add(r2, r2), one);
  fe w = fe_is_zero(w_den) ? one : w_den;
  fe w2 = fe_sq(w);
  fe a2w = fe_mul(fe_const(PK_A2), w);
  fe n1 = fe_mul(fe_const(PK_NEG_A), fe_add(fe_sub(fe_const(PK_A2), a2w), w2));
  fe num1 = fe_mul(fe_const(PK_C2A2), w);
  fe rho; bool good, good_alt, is_pi;
  fe_sqrt_ratio_ext(num1, n1, rho, good, good_alt, is_pi);
  bool ok1 = good || good_alt || fe_is_zero(n1);
  fe x1 = good ? rho : fe_mul(rho, fe_const(PK_SQRT_M1));
  fe x2 = fe_mul(fe_mul(r, rho),
                 is_pi ? fe_const(PK_SQRT_M2I) : fe_const(PK_SQRT_2I));
  fe x = ok1 ? x1 : x2;
  if (fe_parity(x) == 1) x = fe_neg(x);
  fe u2 = fe_mul(fe_const(PK_A), fe_sub(one, w));
  fe un = ok1 ? fe_const(PK_NEG_A) : u2;
  fe y_num = fe_sub(un, w);
  fe z = fe_add(un, w);
  if (fe_is_zero(z)) { y_num = zero; z = one; }
  ge p;
  p.x = fe_mul(x, z); p.y = y_num; p.z = z; p.t = fe_mul(x, y_num);
  return p;
}

// ECVRF stage A, shared by both proof formats, as three independent
// parts: decode Y, decode Γ and check s, and H = 8 · Elligator2(SHA-512(
// suite ‖ 1 ‖ Y ‖ alpha) mod 2^255) (from Y's bytes, not its point).
PK_DEV bool vrf_decode_y(int i, int B, const int32_t *pk, ge &y) {
  u8 pkb[32];
  load_bytes(pk, 32, i, B, pkb);
  return ge_decompress(y, pkb);
}

PK_DEV bool vrf_decode_gamma(int i, int B, const int32_t *gamma,
                             const int32_t *s, ge &g) {
  u8 gb[32], sb[32];
  load_bytes(gamma, 32, i, B, gb);
  load_bytes(s, 32, i, B, sb);
  bool ok_g = ge_decompress(g, gb);
  return ok_g && sc_lt_l(sb);
}

// H = 8·Elligator2(SHA-512(suite ‖ 1 ‖ Y ‖ alpha) mod 2^255)
PK_DEV ge vrf_hash_h(int i, int B, const int32_t *pk, const int32_t *alpha) {
  u8 dg[64];
  sha512_msg<66>([&](int k) -> u8 {
    return k == 0 ? 0x04 : k == 1 ? 0x01 : k < 34 ? (u8)pk[(size_t)(k - 2) * B + i]
                                                  : (u8)alpha[(size_t)(k - 34) * B + i];
  }, dg);
  return ge_mul_cofactor(elligator2(fe_freeze(fe_from_bytes(dg))));
}

// c's digest SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖ V): H's encoding given, Γ, U
// and V read from their columns
PK_DEV void vrf_challenge(const u8 *h, int i, int B, const int32_t *g, const int32_t *u,
                          const int32_t *v, u8 *dg) {
  sha512_msg<130>([&](int k) -> u8 {
    return k == 0 ? 0x04 : k == 1 ? 0x02 : k < 34 ? h[k - 2]
         : k < 66 ? (u8)g[(size_t)(k - 34) * B + i] : k < 98 ? (u8)u[(size_t)(k - 66) * B + i]
         : (u8)v[(size_t)(k - 98) * B + i];
  }, dg);
}

// β's digest SHA-512(suite ‖ 3 ‖ 8Γ) from 8Γ's encoding
PK_DEV void vrf_beta(const u8 *g8, u8 *dg) {
  sha512_msg<34>([&](int k) -> u8 { return k == 0 ? 0x04 : k == 1 ? 0x03 : g8[k - 2]; }, dg);
}

// The two VRF preps over the three warps of a block, 32 lanes. H (role
// 0: its exponentiation chain is the critical path), Y (role 1), Γ and s
// (role 2), each storing its own rows; after the barrier role 1 ANDs the
// two flags. Batch-compatible (128-byte proof): role 0 also compresses H
// and derives c = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖ V)[:16] over the
// announced U, V (two chains on its path). Draft-03 (80-byte proof): the
// challenge is the proof's own c, so role 0 only hashes to the curve.
// Lanes past B (live false) run along and store nothing.
struct BcPrepScratch {
  int32_t ok[2 * PK_GROUP];  // Y decodes; Γ decodes and s < L
};

PK_DEV void d3_role_h(int i, int B, bool live, const int32_t *pk,
                      const int32_t *alpha, int32_t *prep) {
  ge h = vrf_hash_h(i, B, pk, alpha);
  if (live) store_point(prep, i, B, h);
}

PK_DEV void bc_role_h(int i, int B, bool live, const int32_t *pk,
                      const int32_t *gamma, const int32_t *u,
                      const int32_t *v, const int32_t *alpha, int32_t *c16,
                      int32_t *prep) {
  ge h = vrf_hash_h(i, B, pk, alpha);
  u8 enc[32], dg[64];
  ge_compress_many(&h, 1, enc);
  vrf_challenge(enc, i, B, gamma, u, v, dg);
  if (!live) return;
  store_bytes(c16, 16, i, B, dg);
  store_point(prep, i, B, h);
}

PK_DEV void bc_role_y(int i, int B, bool live, int lane, const int32_t *pk,
                      int32_t *prep, BcPrepScratch &sc) {
  ge y;
  sc.ok[lane] = vrf_decode_y(i, B, pk, y) ? 1 : 0;
  if (live) store_point(prep + (size_t)40 * B, i, B, y);
}

PK_DEV void bc_role_gamma(int i, int B, bool live, int lane,
                          const int32_t *gamma, const int32_t *s,
                          int32_t *prep, BcPrepScratch &sc) {
  ge g;
  sc.ok[PK_GROUP + lane] = vrf_decode_gamma(i, B, gamma, s, g) ? 1 : 0;
  if (live) store_point(prep + (size_t)80 * B, i, B, g);
}

PK_DEV void bc_ok(int i, int lane, const BcPrepScratch &sc, int32_t *ok) {
  ok[i] = sc.ok[lane] & sc.ok[PK_GROUP + lane];
}

// vrf_ladders over eight warps: a V quad (warps 0-3) and a U quad (4-7).
// Phase 1, beside each other: the tables of H, −Γ and −Y (warps 0, 1, 2),
// H and Γ through and 8Γ (warp 3), s·B on the U quad. Phase 2: V' =
// s·H − c·Γ on one doubling chain (the V quad: 256 doublings, the
// critical path) beside U' = s·B − c·Y (the U quad).
struct QLadderScratch {
  u32 tab_h[PK_LANETAB_WORDS];
  u32 tab_g[PK_LANETAB_WORDS];  // of −Γ
  u32 tab_y[PK_LANETAB_WORDS];  // of −Y
  int32_t sb[40 * PK_GROUP];    // s·B, as a 32-lane point column
  u32 qx[2 * PK_QUAD_WORDS];    // the two quads' exchange areas
};

PK_DEV void ladder_table_h(int i, int B, const int32_t *prep, LaneTab &tab) {
  ge_table8(tab, load_point(prep, i, B));
}

PK_DEV void ladder_table_g(int i, int B, const int32_t *prep, LaneTab &tab) {
  ge_table8(tab, ge_neg(load_point(prep + (size_t)80 * B, i, B)));
}

PK_DEV void ladder_table_y(int i, int B, const int32_t *prep, LaneTab &tab) {
  ge_table8(tab, ge_neg(load_point(prep + (size_t)40 * B, i, B)));
}

// -> the H, Γ and 8Γ rows of the output
PK_DEV void ladder_passthrough(int i, int B, const int32_t *prep, int32_t *pts) {
  for (int r = 0; r < 40; r++) pts[(size_t)r * B + i] = prep[(size_t)r * B + i];
  ge g = load_point(prep + (size_t)80 * B, i, B);
  store_point(pts + (size_t)40 * B, i, B, g);
  store_point(pts + (size_t)160 * B, i, B, ge_mul_cofactor(g));
}

// s·B on the U quad, into the scratch
PK_DEV void ladder_qbase(int i, int B, const u32 *base8, const int32_t *s,
                         Quad &qd, int32_t *sb) {
  u8 b[32];
  load_bytes(s, 32, i, B, b);
  ge p = qbase_mul_w8(qd, base8, b);
  if (qd.w <= 0) store_point(sb, qd.lane, PK_GROUP, p);
}

// -> the V' rows, on the V quad
PK_DEV void ladder_qv(int i, int B, bool live, const int32_t *c16,
                      const int32_t *s, const LaneTab &th, const LaneTab &tg,
                      Quad &qd, int32_t *pts) {
  u8 cb[16], sb[32], sd[64], cd[32];
  load_bytes(c16, 16, i, B, cb);
  load_bytes(s, 32, i, B, sb);
  nibbles_msb(sb, 32, sd);
  nibbles_msb(cb, 16, cd);
  ge vp = qdouble_scalar_mul_w4(qd, sd, 64, th, cd, 32, tg);
  if (live && qd.w <= 0) store_point(pts + (size_t)120 * B, i, B, vp);
}

// -> the U' rows, on the U quad
PK_DEV void ladder_qu(int i, int B, bool live, const int32_t *c16,
                      const LaneTab &ty, const int32_t *sb, Quad &qd, int32_t *pts) {
  u8 cb[16], cd[32];
  load_bytes(c16, 16, i, B, cb);
  nibbles_msb(cb, 16, cd);
  ge cy = qscalar_mul_w4(qd, cd, 32, ty);
  ge up;
  qadd(qd, up, load_point(sb, qd.lane, PK_GROUP), cy);
  if (live && qd.w <= 0) store_point(pts + (size_t)80 * B, i, B, up);
}

// finish over the three warps of a block, 32 lanes, each compressing
// its own points on an inversion of its own (Montgomery's trick): H, Γ,
// U' and V', then c' = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U' ‖ V')[:16] against c
// (role 0, the critical path); 8Γ, then β' = SHA-512(suite ‖ 3 ‖ 8Γ)
// against the declared β (role 1); the ed and KES points and their R-byte
// compares, then the leader value Blake2b("L" ‖ β), the nonce Blake2b(
// Blake2b("N" ‖ β)) and the two threshold compares, which read only the
// declared β (role 2). After the barrier role 0 ANDs the VRF flags. Lanes
// past B (live false) run along and store nothing.
struct FinishScratch {
  int32_t ok[2 * PK_GROUP];  // c' == c; β' == β
};

PK_DEV void finish_role_vrf(int i, int B, int lane, const int32_t *vrfpts,
                            const int32_t *c, FinishScratch &sc) {
  ge pts[4];
  for (int k = 0; k < 4; k++) pts[k] = load_point(vrfpts + (size_t)40 * k * B, i, B);
  u8 buf[130], dg[64], cb[16];
  buf[0] = 0x04; buf[1] = 0x02;
  ge_compress_many(pts, 4, buf + 2);
  sha512_msg<130>([&](int k) -> u8 { return buf[k]; }, dg);
  load_bytes(c, 16, i, B, cb);
  bool ok = true;
  for (int k = 0; k < 16; k++) ok = ok && dg[k] == cb[k];
  sc.ok[lane] = ok ? 1 : 0;
}

PK_DEV void finish_role_beta(int i, int B, int lane, const int32_t *vrfpts,
                             const int32_t *beta, FinishScratch &sc) {
  ge g8 = load_point(vrfpts + (size_t)160 * B, i, B);
  u8 enc[32], dg[64], bb[64];
  ge_compress_many(&g8, 1, enc);
  vrf_beta(enc, dg);
  load_bytes(beta, 64, i, B, bb);
  bool ok = true;
  for (int k = 0; k < 64; k++) ok = ok && dg[k] == bb[k];
  sc.ok[PK_GROUP + lane] = ok ? 1 : 0;
}

// the leader value Blake2b-256('L' ‖ β), eta Blake2b-256(Blake2b-256('N'
// ‖ β)) and the two threshold compares (flag rows 3 and 4), the hashes on
// words
PK_DEV void finish_role_leader(int i, int B, bool live, const int32_t *beta,
                               const int32_t *tlo, const int32_t *thi,
                               int32_t *out, int32_t *eta, int32_t *lv) {
  u64 m[16], lw[4], e1[4], e2[4];
  for (int j = 0; j < 16; j++) m[j] = 0;
#pragma unroll
  for (int k = 0; k < 64; k++)  // β is message bytes 1 .. 64
    m[(k + 1) >> 3] |= (u64)(u8)beta[(size_t)k * B + i] << (8 * ((k + 1) & 7));
  m[0] |= 'L';
  blake2b_256_words(m, 65, lw);
  m[0] ^= 'L' ^ 'N';
  blake2b_256_words(m, 65, e1);
  u64 m2[16] = {e1[0], e1[1], e1[2], e1[3], 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  blake2b_256_words(m2, 32, e2);
  u8 lvb[32], e2b[32], tl[32], th[32];
  for (int k = 0; k < 32; k++) {
    lvb[k] = (u8)(lw[k >> 3] >> (8 * (k & 7)));
    e2b[k] = (u8)(e2[k >> 3] >> (8 * (k & 7)));
  }
  load_bytes(tlo, 32, i, B, tl);
  load_bytes(thi, 32, i, B, th);
  bool win = lt_be32(lvb, tl);
  bool loss = !lt_be32(lvb, th);
  if (!live) return;
  out[(size_t)3 * B + i] = win ? 1 : 0;
  out[(size_t)4 * B + i] = (!win && !loss) ? 1 : 0;
  store_bytes(eta, 32, i, B, e2b);
  store_bytes(lv, 32, i, B, lvb);
}

PK_DEV void finish_role_sig(int i, int B, bool live, const int32_t *edok,
                            const int32_t *edpt, const int32_t *edr,
                            const int32_t *kesok, const int32_t *kespt,
                            const int32_t *kesr, const int32_t *beta,
                            const int32_t *tlo, const int32_t *thi,
                            int32_t *out, int32_t *eta, int32_t *lv) {
  ge pts[2];
  pts[0] = load_point(edpt, i, B);
  pts[1] = load_point(kespt, i, B);
  u8 enc[64], ref[64];
  ge_compress_many(pts, 2, enc);
  load_bytes(edr, 32, i, B, ref);
  load_bytes(kesr, 32, i, B, ref + 32);
  bool ok_ed = edok[i] != 0, ok_kes = kesok[i] != 0;
  for (int k = 0; k < 32; k++) {
    ok_ed = ok_ed && enc[k] == ref[k];
    ok_kes = ok_kes && enc[32 + k] == ref[32 + k];
  }
  if (live) {
    out[i] = ok_ed ? 1 : 0;
    out[(size_t)B + i] = ok_kes ? 1 : 0;
  }
  finish_role_leader(i, B, live, beta, tlo, thi, out, eta, lv);
}

PK_DEV void finish_vrf_ok(int i, int B, int lane, const int32_t *vrfok,
                          const FinishScratch &sc, int32_t *out) {
  out[(size_t)2 * B + i] = (vrfok[i] != 0 ? 1 : 0) & sc.ok[lane] & sc.ok[PK_GROUP + lane];
}
