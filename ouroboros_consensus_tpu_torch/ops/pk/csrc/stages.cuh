// Per-lane bodies of the six Praos stage kernels. Column arrays are
// limb-first int32 [rows][B]: element (row r, lane i) at r * B + i, so a
// warp's 32 lanes read 32 neighbouring words of each row. Points cross
// stages as 40 rows (X, Y, Z, T, 10 limbs each, radix 2^25.5).
#pragma once
#include "pk.cuh"

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

// P = s·B − h·A with h = SHA-512(R ‖ A ‖ M) mod L; -> ok_pre
PK_NOINLINE bool ed_core_lane(const u32 *base8, const u8 *pk, const u8 *s,
                              const int32_t *hb, int nb, int nblocks, int i,
                              int B, ge &out) {
  ge a;
  bool ok_a = ge_decompress(a, pk);
  bool s_ok = sc_lt_l(s);
  u8 dig[64], h[32], hd[64];
  sha512_columns(hb, nb, nblocks, i, B, dig);
  sc_reduce512(dig, h);
  ge sb = ge_base_mul_w8(base8, s);
  nibbles_msb(h, 32, hd);
  ge nha = ge_scalar_mul_w4(hd, 64, ge_neg(a));
  out = ge_add(sb, nha);
  return ok_a && s_ok;
}

PK_DEV void ed_lane(int i, int B, const u32 *base8, const int32_t *pk,
                    const int32_t *s, const int32_t *hb, int nb,
                    const int32_t *hnb, int32_t *ok, int32_t *pt) {
  u8 pkb[32], sb[32];
  load_bytes(pk, 32, i, B, pkb);
  load_bytes(s, 32, i, B, sb);
  ge p;
  bool o = ed_core_lane(base8, pkb, sb, hb, nb, hnb[i], i, B, p);
  ok[i] = o ? 1 : 0;
  store_point(pt, i, B, p);
}

PK_DEV void kes_lane(int i, int B, int depth, const u32 *base8,
                     const int32_t *vk, const int32_t *period,
                     const int32_t *s, const int32_t *leaf,
                     const int32_t *sib, const int32_t *hb, int nb,
                     const int32_t *hnb, int32_t *ok, int32_t *pt) {
  u8 leafb[32], sb[32], cur[32], data[64], vkb[32];
  load_bytes(leaf, 32, i, B, leafb);
  load_bytes(s, 32, i, B, sb);
  ge p;
  bool ok_ed = ed_core_lane(base8, leafb, sb, hb, nb, hnb[i], i, B, p);
  // Merkle walk: bit l of the period puts the running vk on the right;
  // siblings are indexed by level, so any period value reads in bounds
  int32_t per = period[i];
  for (int k = 0; k < 32; k++) cur[k] = leafb[k];
  for (int l = 0; l < depth; l++) {
    bool right = ((per >> l) & 1) == 1;
    for (int k = 0; k < 32; k++) {
      u8 sv = (u8)sib[((size_t)l * 32 + k) * B + i];
      data[k] = right ? sv : cur[k];
      data[32 + k] = right ? cur[k] : sv;
    }
    blake2b_256(data, 64, cur);
  }
  load_bytes(vk, 32, i, B, vkb);
  bool root_ok = true;
  for (int k = 0; k < 32; k++) root_ok = root_ok && cur[k] == vkb[k];
  bool period_ok = per >= 0 && per < (1 << depth);
  ok[i] = (ok_ed && root_ok && period_ok) ? 1 : 0;
  store_point(pt, i, B, p);
}

// single-chain Elligator2 (one exponentiation), projective output
PK_NOINLINE ge elligator2(fe r) {
  fe one = fe_one(), zero = fe_zero();
  fe r2 = fe_sqr(r);
  fe w_den = fe_add(fe_add(r2, r2), one);
  fe w = fe_is_zero(w_den) ? one : w_den;
  fe w2 = fe_sqr(w);
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

// ECVRF stage A, shared by both proof formats: decode Y and Γ, check s,
// H = 8 · Elligator2(SHA-512(suite ‖ 1 ‖ Y ‖ alpha) mod 2^255); -> ok_pre
PK_DEV bool vrf_decode_hash(int i, int B, const int32_t *pk,
                            const int32_t *gamma, const int32_t *s,
                            const int32_t *alpha, u8 *gb, ge &h, ge &y,
                            ge &g) {
  u8 pkb[32], sb[32], buf[66], dg[64];
  load_bytes(pk, 32, i, B, pkb);
  load_bytes(gamma, 32, i, B, gb);
  load_bytes(s, 32, i, B, sb);
  bool ok_y = ge_decompress(y, pkb);
  bool ok_g = ge_decompress(g, gb);
  bool s_ok = sc_lt_l(sb);
  buf[0] = 0x04; buf[1] = 0x01;
  for (int k = 0; k < 32; k++) buf[2 + k] = pkb[k];
  load_bytes(alpha, 32, i, B, buf + 34);
  sha512_msg(buf, 66, dg);
  h = ge_mul_cofactor(elligator2(fe_freeze(fe_from_bytes(dg))));
  return ok_y && ok_g && s_ok;
}

// draft-03 (80-byte proof): the challenge is the proof's own c
PK_DEV void vrf_prep_lane(int i, int B, const int32_t *pk,
                          const int32_t *gamma, const int32_t *s,
                          const int32_t *alpha, int32_t *ok, int32_t *prep) {
  u8 gb[32];
  ge h, y, g;
  bool o = vrf_decode_hash(i, B, pk, gamma, s, alpha, gb, h, y, g);
  ok[i] = o ? 1 : 0;
  store_point(prep, i, B, h);
  store_point(prep + (size_t)40 * B, i, B, y);
  store_point(prep + (size_t)80 * B, i, B, g);
}

// batch-compatible (128-byte proof): c = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖
// V)[:16] over the announced U, V
PK_DEV void vrf_bc_prep_lane(int i, int B, const int32_t *pk,
                             const int32_t *gamma, const int32_t *u,
                             const int32_t *v, const int32_t *s,
                             const int32_t *alpha, int32_t *ok,
                             int32_t *c16, int32_t *prep) {
  u8 gb[32], buf[130], dg[64];
  ge h, y, g;
  bool o = vrf_decode_hash(i, B, pk, gamma, s, alpha, gb, h, y, g);
  buf[0] = 0x04; buf[1] = 0x02;
  ge_compress_many(&h, 1, buf + 2);
  for (int k = 0; k < 32; k++) buf[34 + k] = gb[k];
  load_bytes(u, 32, i, B, buf + 66);
  load_bytes(v, 32, i, B, buf + 98);
  sha512_msg(buf, 130, dg);
  ok[i] = o ? 1 : 0;
  store_bytes(c16, 16, i, B, dg);
  store_point(prep, i, B, h);
  store_point(prep + (size_t)40 * B, i, B, y);
  store_point(prep + (size_t)80 * B, i, B, g);
}

PK_DEV void vrf_ladder_lane(int i, int B, const u32 *base8,
                            const int32_t *c16, const int32_t *s,
                            const int32_t *prep, int32_t *pts) {
  u8 cb[16], sb[32], sd[64], cd[32];
  load_bytes(c16, 16, i, B, cb);
  load_bytes(s, 32, i, B, sb);
  ge h = load_point(prep, i, B);
  ge y = load_point(prep + (size_t)40 * B, i, B);
  ge g = load_point(prep + (size_t)80 * B, i, B);
  nibbles_msb(sb, 32, sd);
  nibbles_msb(cb, 16, cd);
  ge sbp = ge_base_mul_w8(base8, sb);
  ge up = ge_add(sbp, ge_scalar_mul_w4(cd, 32, ge_neg(y)));
  ge vp = ge_double_scalar_mul_w4(sd, 64, h, cd, 32, ge_neg(g));
  ge g8 = ge_mul_cofactor(g);
  store_point(pts, i, B, h);
  store_point(pts + (size_t)40 * B, i, B, g);
  store_point(pts + (size_t)80 * B, i, B, up);
  store_point(pts + (size_t)120 * B, i, B, vp);
  store_point(pts + (size_t)160 * B, i, B, g8);
}

PK_DEV void finish_lane(int i, int B, const int32_t *edok,
                        const int32_t *edpt, const int32_t *edr,
                        const int32_t *kesok, const int32_t *kespt,
                        const int32_t *kesr, const int32_t *vrfok,
                        const int32_t *vrfpts, const int32_t *c,
                        const int32_t *beta, const int32_t *tlo,
                        const int32_t *thi, int32_t *out, int32_t *eta,
                        int32_t *lv) {
  ge pts[7];
  pts[0] = load_point(edpt, i, B);
  pts[1] = load_point(kespt, i, B);
  for (int k = 0; k < 5; k++) pts[2 + k] = load_point(vrfpts + (size_t)40 * k * B, i, B);
  u8 enc[224], ref[64], buf[130], dg[64];
  ge_compress_many(pts, 7, enc);
  load_bytes(edr, 32, i, B, ref);
  load_bytes(kesr, 32, i, B, ref + 32);
  bool ok_ed = edok[i] != 0, ok_kes = kesok[i] != 0;
  for (int k = 0; k < 32; k++) {
    ok_ed = ok_ed && enc[k] == ref[k];
    ok_kes = ok_kes && enc[32 + k] == ref[32 + k];
  }
  // c' = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U' ‖ V')[:16]
  buf[0] = 0x04; buf[1] = 0x02;
  for (int k = 0; k < 128; k++) buf[2 + k] = enc[64 + k];
  sha512_msg(buf, 130, dg);
  load_bytes(c, 16, i, B, ref);
  bool ok_vrf = vrfok[i] != 0;
  for (int k = 0; k < 16; k++) ok_vrf = ok_vrf && dg[k] == ref[k];
  // beta = SHA-512(suite ‖ 3 ‖ 8Γ) against the declared output
  buf[0] = 0x04; buf[1] = 0x03;
  for (int k = 0; k < 32; k++) buf[2 + k] = enc[192 + k];
  sha512_msg(buf, 34, dg);
  load_bytes(beta, 64, i, B, buf + 1);
  for (int k = 0; k < 64; k++) ok_vrf = ok_vrf && dg[k] == buf[1 + k];
  // leader value Blake2b("L" ‖ beta), nonce Blake2b(Blake2b("N" ‖ beta))
  u8 lvb[32], e1[32], e2[32], tl[32], th[32];
  buf[0] = 'L';
  blake2b_256(buf, 65, lvb);
  buf[0] = 'N';
  blake2b_256(buf, 65, e1);
  blake2b_256(e1, 32, e2);
  load_bytes(tlo, 32, i, B, tl);
  load_bytes(thi, 32, i, B, th);
  bool win = lt_be32(lvb, tl);
  bool loss = !lt_be32(lvb, th);
  out[i] = ok_ed ? 1 : 0;
  out[(size_t)B + i] = ok_kes ? 1 : 0;
  out[(size_t)2 * B + i] = ok_vrf ? 1 : 0;
  out[(size_t)3 * B + i] = win ? 1 : 0;
  out[(size_t)4 * B + i] = (!win && !loss) ? 1 : 0;
  store_bytes(eta, 32, i, B, e2);
  store_bytes(lv, 32, i, B, lvb);
}
