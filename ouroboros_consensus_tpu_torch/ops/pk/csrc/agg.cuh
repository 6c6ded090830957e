// Lane bodies of the window aggregate's three kernels (agg_prep.cu,
// agg_tables.cu, msm.cu): the per-lane prep, the mod-L reduction of the
// dedupe tables' slot sums, and the phases of the shared signed-digit
// bucket machine. Each body is a function of its thread's index, so the
// host build (csrc/host_emu.cpp) runs a phase's bodies one after another
// and the CPU tests hold them to the twins (ops/pk/aggregate.py, msm.py).
#pragma once
#include "stages.cuh"

// ---------------------------------------------------------------------------
// agg_prep: one lane over four warps, 32 lanes a block
// ---------------------------------------------------------------------------

// the 22 limb-first input arrays, unpack_limb_first's order
enum {
  AI_ED_PK, AI_ED_R, AI_ED_S, AI_ED_HB, AI_ED_HNB, AI_KES_VK, AI_KES_PER,
  AI_KES_R, AI_KES_S, AI_KES_LEAF, AI_KES_SIB, AI_KES_HB, AI_KES_HNB,
  AI_VRF_PK, AI_VRF_G, AI_VRF_U, AI_VRF_V, AI_VRF_S, AI_VRF_AL, AI_BETA,
  AI_TLO, AI_THI, AI_N
};
struct AggIn { const int32_t *c[AI_N]; };
struct AggShape { int B, depth, nb_ed, nb_kes; };
// outputs: points [9][B][40] int32 (point-major), scalars [12][B][32]
// bytes, flags [5][B], eta and leader value [32][B]
struct AggOut { int32_t *pts; u8 *sc; int32_t *flags, *eta, *lv; };
enum { PT_RK, PT_U, PT_V, PT_G, PT_H, PT_RE, PT_AE, PT_AL, PT_Y };
enum { SC_Z2, SC_Z3, SC_Z4, SC_Z4C, SC_Z4S, SC_Z1, SC_Z1H, SC_Z2H, SC_Z3C,
       SC_B1, SC_B2, SC_B3 };
#define AGG_FS_BYTES 520  // tag ‖ the lane transcript (aggregate.fs_coefficients)

// what the roles hand on, lane-minor bytes
struct AggScratch {
  u8 ed_dig[64 * PK_GROUP];
  u8 kes_dig[64 * PK_GROUP];
  u8 c16[16 * PK_GROUP];
  u8 z[64 * PK_GROUP];        // the Fiat–Shamir digest, low bits forced
  int32_t ok[5 * PK_GROUP];   // pre_ed, pre_kes; VRF: Y, Γ ‖ s ‖ β ‖ U, V
};

PK_DEV void agg_put_point(const AggOut &o, int col, int i, int B, const ge &p) {
  int32_t *d = o.pts + ((size_t)col * B + i) * 40;
  for (int k = 0; k < 10; k++) {
    d[k] = (int32_t)p.x.v[k];
    d[10 + k] = (int32_t)p.y.v[k];
    d[20 + k] = (int32_t)p.z.v[k];
    d[30 + k] = (int32_t)p.t.v[k];
  }
}

PK_DEV void agg_put_scalar(const AggOut &o, int row, int i, int B, const u8 *s, int n) {
  u8 *d = o.sc + ((size_t)row * B + i) * 32;
  for (int k = 0; k < 32; k++) d[k] = k < n ? s[k] : 0;
}

PK_DEV bool agg_decode(const int32_t *col, int i, int B, ge &p) {
  u8 b[32];
  load_bytes(col, 32, i, B, b);
  return ge_decompress(p, b);
}

// role 0: A_e, R_e and s_e (pre_ed), the OCert challenge digest, and V
PK_DEV void agg_role_ed(int i, bool live, int lane, const AggShape &s,
                        const AggIn &in, const AggOut &o, AggScratch &sc) {
  const int B = s.B;
  ge a, r, v;
  u8 sb[32], dig[64];
  bool ok = agg_decode(in.c[AI_ED_PK], i, B, a);
  ok = agg_decode(in.c[AI_ED_R], i, B, r) && ok;
  load_bytes(in.c[AI_ED_S], 32, i, B, sb);
  sc.ok[lane] = ok && sc_lt_l(sb) ? 1 : 0;
  sha512_columns(in.c[AI_ED_HB], s.nb_ed, in.c[AI_ED_HNB][i], i, B, dig);
  for (int k = 0; k < 64; k++) sc.ed_dig[(k << 5) + lane] = dig[k];
  sc.ok[4 * PK_GROUP + lane] = agg_decode(in.c[AI_VRF_V], i, B, v) ? 1 : 0;
  if (!live) return;
  agg_put_point(o, PT_AE, i, B, ge_neg(a));
  agg_put_point(o, PT_RE, i, B, ge_neg(r));
  agg_put_point(o, PT_V, i, B, ge_neg(v));
}

// role 1: A_l, R_k, s_k, the Merkle walk and period (pre_kes), the KES
// challenge digest; then the leader value, eta and the two threshold
// compares (flag rows 3 and 4), which read only the declared β
PK_DEV void agg_role_kes(int i, bool live, int lane, const AggShape &s,
                         const AggIn &in, const AggOut &o, AggScratch &sc) {
  const int B = s.B;
  ge al, rk;
  u8 leaf[32], sb[32], dig[64];
  load_bytes(in.c[AI_KES_LEAF], 32, i, B, leaf);
  bool ok = ge_decompress(al, leaf);
  ok = agg_decode(in.c[AI_KES_R], i, B, rk) && ok;
  load_bytes(in.c[AI_KES_S], 32, i, B, sb);
  ok = sc_lt_l(sb) && ok;
  ok = kes_merkle(i, B, s.depth, in.c[AI_KES_VK], in.c[AI_KES_PER], leaf,
                  in.c[AI_KES_SIB]) && ok;
  sc.ok[PK_GROUP + lane] = ok ? 1 : 0;
  sha512_columns(in.c[AI_KES_HB], s.nb_kes, in.c[AI_KES_HNB][i], i, B, dig);
  for (int k = 0; k < 64; k++) sc.kes_dig[(k << 5) + lane] = dig[k];
  if (live) {
    agg_put_point(o, PT_AL, i, B, ge_neg(al));
    agg_put_point(o, PT_RK, i, B, ge_neg(rk));
  }
  finish_role_leader(i, B, live, in.c[AI_BETA], in.c[AI_TLO], in.c[AI_THI],
                     o.flags, o.eta, o.lv);
}

// role 2: H, its compression and c = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖ V)[:16],
// and Y
PK_DEV void agg_role_h(int i, bool live, int lane, const AggShape &s,
                       const AggIn &in, const AggOut &o, AggScratch &sc) {
  const int B = s.B;
  ge h = vrf_hash_h(i, B, in.c[AI_VRF_PK], in.c[AI_VRF_AL]);
  u8 buf[130], dg[64];
  buf[0] = 0x04; buf[1] = 0x02;
  ge_compress_many(&h, 1, buf + 2);
  load_bytes(in.c[AI_VRF_G], 32, i, B, buf + 34);
  load_bytes(in.c[AI_VRF_U], 32, i, B, buf + 66);
  load_bytes(in.c[AI_VRF_V], 32, i, B, buf + 98);
  sha512_msg(buf, 130, dg);
  for (int k = 0; k < 16; k++) sc.c16[(k << 5) + lane] = dg[k];
  ge y;
  sc.ok[2 * PK_GROUP + lane] = agg_decode(in.c[AI_VRF_PK], i, B, y) ? 1 : 0;
  if (!live) return;
  agg_put_point(o, PT_H, i, B, h);
  agg_put_point(o, PT_Y, i, B, ge_neg(y));
}

// role 3: Γ and s_v, 8·Γ's compression and β' = SHA-512(suite ‖ 3 ‖ 8Γ)
// against the declared β, and U
PK_DEV void agg_role_gamma(int i, bool live, int lane, const AggShape &s,
                           const AggIn &in, const AggOut &o, AggScratch &sc) {
  const int B = s.B;
  ge g, u;
  bool ok = vrf_decode_gamma(i, B, in.c[AI_VRF_G], in.c[AI_VRF_S], g);
  ge g8 = ge_mul_cofactor(g);
  u8 buf[34], dg[64], bb[64];
  buf[0] = 0x04; buf[1] = 0x03;
  ge_compress_many(&g8, 1, buf + 2);
  sha512_msg(buf, 34, dg);
  load_bytes(in.c[AI_BETA], 64, i, B, bb);
  for (int k = 0; k < 64; k++) ok = ok && dg[k] == bb[k];
  ok = agg_decode(in.c[AI_VRF_U], i, B, u) && ok;
  sc.ok[3 * PK_GROUP + lane] = ok ? 1 : 0;
  if (!live) return;
  agg_put_point(o, PT_G, i, B, ge_neg(g));
  agg_put_point(o, PT_U, i, B, ge_neg(u));
}

// phase 2 (warp 0): the Fiat–Shamir digest of the lane's transcript
PK_DEV void agg_fs(int i, int lane, const AggShape &s, const AggIn &in, AggScratch &sc) {
  const int B = s.B;
  const char tag[8] = {'o', 'c', 't', 'R', 'L', 'C', '-', '1'};
  u8 m[AGG_FS_BYTES], z[64];
  int o = 0;
  for (int k = 0; k < 8; k++) m[o++] = (u8)tag[k];
  load_bytes(in.c[AI_ED_R], 32, i, B, m + o); o += 32;
  load_bytes(in.c[AI_ED_S], 32, i, B, m + o); o += 32;
  for (int k = 0; k < 64; k++) m[o++] = sc.ed_dig[(k << 5) + lane];
  load_bytes(in.c[AI_KES_R], 32, i, B, m + o); o += 32;
  load_bytes(in.c[AI_KES_S], 32, i, B, m + o); o += 32;
  for (int k = 0; k < 64; k++) m[o++] = sc.kes_dig[(k << 5) + lane];
  const int cols[6] = {AI_VRF_G, AI_VRF_U, AI_VRF_V, AI_VRF_S, AI_VRF_PK, AI_VRF_AL};
  for (int c = 0; c < 6; c++) { load_bytes(in.c[cols[c]], 32, i, B, m + o); o += 32; }
  load_bytes(in.c[AI_BETA], 64, i, B, m + o);
  sha512_long(m, AGG_FS_BYTES, z);
  for (int k = 0; k < 64; k++) sc.z[(k << 5) + lane] = (k & 15) == 0 ? (z[k] | 1) : z[k];
}

// phase 3: warp `role` stores coefficient z_(role+1) and its products
// mod L (role 2 also the three cheap-check flag rows)
PK_DEV void agg_products(int role, int i, bool live, int lane, const AggShape &s,
                         const AggIn &in, const AggOut &o, const AggScratch &sc) {
  const int B = s.B;
  const int zoff[4] = {0, 16, 32, 48};
  u8 z[16], x[32], y[32], p[32];
  for (int k = 0; k < 16; k++) z[k] = sc.z[((zoff[role] + k) << 5) + lane];
  if (role == 0) {  // z1: R_e's table, z1·h_e (A_e's), z1·s_e (B's)
    u8 dig[64];
    for (int k = 0; k < 64; k++) dig[k] = sc.ed_dig[(k << 5) + lane];
    sc_reduce512(dig, x);
    load_bytes(in.c[AI_ED_S], 32, i, B, y);
    if (!live) return;
    agg_put_scalar(o, SC_Z1, i, B, z, 16);
    sc_mul(z, 16, x, 32, p); agg_put_scalar(o, SC_Z1H, i, B, p, 32);
    sc_mul(z, 16, y, 32, p); agg_put_scalar(o, SC_B1, i, B, p, 32);
  } else if (role == 1) {  // z2: −R_k's, z2·h_k (A_l's), z2·s_k (B's)
    u8 dig[64];
    for (int k = 0; k < 64; k++) dig[k] = sc.kes_dig[(k << 5) + lane];
    sc_reduce512(dig, x);
    load_bytes(in.c[AI_KES_S], 32, i, B, y);
    if (!live) return;
    agg_put_scalar(o, SC_Z2, i, B, z, 16);
    sc_mul(z, 16, x, 32, p); agg_put_scalar(o, SC_Z2H, i, B, p, 32);
    sc_mul(z, 16, y, 32, p); agg_put_scalar(o, SC_B2, i, B, p, 32);
  } else if (role == 2) {  // z3: −U's, z3·c (Y's), z3·s_v (B's); the flags
    for (int k = 0; k < 16; k++) x[k] = sc.c16[(k << 5) + lane];
    load_bytes(in.c[AI_VRF_S], 32, i, B, y);
    if (!live) return;
    agg_put_scalar(o, SC_Z3, i, B, z, 16);
    sc_mul(z, 16, x, 16, p); agg_put_scalar(o, SC_Z3C, i, B, p, 32);
    sc_mul(z, 16, y, 32, p); agg_put_scalar(o, SC_B3, i, B, p, 32);
    o.flags[i] = sc.ok[lane];
    o.flags[(size_t)B + i] = sc.ok[PK_GROUP + lane];
    o.flags[(size_t)2 * B + i] =
        sc.ok[2 * PK_GROUP + lane] & sc.ok[3 * PK_GROUP + lane] & sc.ok[4 * PK_GROUP + lane];
  } else {  // z4: −V's, z4·c (−Γ's), z4·s_v (H's)
    for (int k = 0; k < 16; k++) x[k] = sc.c16[(k << 5) + lane];
    load_bytes(in.c[AI_VRF_S], 32, i, B, y);
    if (!live) return;
    agg_put_scalar(o, SC_Z4, i, B, z, 16);
    sc_mul(z, 16, x, 16, p); agg_put_scalar(o, SC_Z4C, i, B, p, 32);
    sc_mul(z, 16, y, 32, p); agg_put_scalar(o, SC_Z4S, i, B, p, 32);
  }
}

// ---------------------------------------------------------------------------
// agg_tables: a row of un-carried byte sums -> its value mod L
// ---------------------------------------------------------------------------

PK_DEV void agg_table_row(int r, const int64_t *raw, u8 *out) {
  u64 cols[32];
  for (int k = 0; k < 32; k++) cols[k] = (u64)raw[(size_t)r * 32 + k];
  u8 wide[64];
  sc_carry64(cols, 32, wide);
  sc_reduce512(wide, out + (size_t)r * 32);
}

// ---------------------------------------------------------------------------
// msm: the shared signed-digit bucket machine (ops/pk/msm.py)
// ---------------------------------------------------------------------------

#define MSM_C 12
#define MSM_HALF 2048              // |d| <= 2^11
#define MSM_D (MSM_HALF + 1)       // buckets of a window, |d| = 0 .. 2^11
#define MSM_SEG 64                 // buckets a segment of the weighted sums
#define MSM_SEG_LOG 6
#define MSM_NSEG (MSM_HALF / MSM_SEG)
#define MSM_WMAX 32                // windows the final block holds
#define MSM_SMALL 32               // a bucket of more entries takes a block
#define MSM_BIG 128                // that block's threads

// n points, the first n_small with ws windows, the rest with ww (ws <= ww)
struct MsmShape { int n, n_small, ws, ww; };

#ifdef PK_HOST
static inline int pk_atomic_add(int *p, int v) { int o = *p; *p += v; return o; }
#else
PK_DEV int pk_atomic_add(int *p, int v) { return atomicAdd(p, v); }
#endif

PK_DEV ge msm_load(const int32_t *pts, size_t k) {
  const int32_t *e = pts + k * 40;
  ge p;
  for (int l = 0; l < 10; l++) {
    p.x.v[l] = (u32)e[l];
    p.y.v[l] = (u32)e[10 + l];
    p.z.v[l] = (u32)e[20 + l];
    p.t.v[l] = (u32)e[30 + l];
  }
  return p;
}

PK_DEV void msm_store(int32_t *pts, size_t k, const ge &p) {
  int32_t *e = pts + k * 40;
  for (int l = 0; l < 10; l++) {
    e[l] = (int32_t)p.x.v[l];
    e[10 + l] = (int32_t)p.y.v[l];
    e[20 + l] = (int32_t)p.z.v[l];
    e[30 + l] = (int32_t)p.t.v[l];
  }
}

// phase 1, a thread a point: its balanced signed digits, least
// significant window first (digits [ww][n], 0 above its windows), and a
// count per (window, |digit|) for every nonzero digit
PK_DEV void msm_recode(int p, const MsmShape &s, const u8 *scalars,
                       int32_t *digits, int *counts) {
  u8 b[36];
  for (int k = 0; k < 32; k++) b[k] = scalars[(size_t)p * 32 + k];
  for (int k = 32; k < 36; k++) b[k] = 0;
  int nw = p < s.n_small ? s.ws : s.ww, carry = 0;
  for (int w = 0; w < s.ww; w++) {
    int d = 0;
    if (w < nw) {
      int bit = MSM_C * w, k = bit >> 3, sh = bit & 7;
      int u = (b[k] | (b[k + 1] << 8) | (b[k + 2] << 16)) >> sh;
      d = (u & ((1 << MSM_C) - 1)) + carry;
      carry = d > MSM_HALF ? 1 : 0;
      d -= carry << MSM_C;
    }
    digits[(size_t)w * s.n + p] = d;
    if (d != 0) pk_atomic_add(&counts[w * MSM_D + (d < 0 ? -d : d)], 1);
  }
}

// phase 3, a thread a point: its index into each of its nonzero buckets
// (the sign in bit 31) at the bucket's next free place
PK_DEV void msm_scatter(int p, const MsmShape &s, const int32_t *digits,
                        int *cursor, u32 *ent) {
  for (int w = 0; w < s.ww; w++) {
    int d = digits[(size_t)w * s.n + p];
    if (d == 0) continue;
    int pos = pk_atomic_add(&cursor[w * MSM_D + (d < 0 ? -d : d)], 1);
    ent[pos] = (u32)p | (d < 0 ? 0x80000000u : 0u);
  }
}

// phase 4a, a thread a bucket t = w · 2^11 + |d| − 1 of at most
// MSM_SMALL entries: the sum of its entries (offsets: the exclusive scan
// of the counts, [ww · D + 1]); a bigger bucket is phase 4b's
PK_DEV void msm_bucket(int t, const int32_t *pts, const int *offsets,
                       const u32 *ent, int32_t *buckets) {
  int w = t / MSM_HALF, d = t % MSM_HALF + 1;
  int lo = offsets[w * MSM_D + d], hi = offsets[w * MSM_D + d + 1];
  if (hi - lo > MSM_SMALL) return;
  ge acc = ge_identity();
  for (int e = lo; e < hi; e++) {
    u32 x = ent[e];
    ge p = msm_load(pts, x & 0x7FFFFFFFu);
    if (x >> 31) p = ge_neg(p);
    acc = e == lo ? p : ge_add(acc, p);
  }
  msm_store(buckets, t, acc);
}

// phase 4b, a block of MSM_BIG threads a bucket of more than MSM_SMALL
// entries (the scan lists them: the digits of the top windows are small,
// so their few buckets hold most of the points): thread j sums entries
// lo + j, lo + j + MSM_BIG, ... into tree[j] (`msm_big_partial`), then
// rounds of a tree over the threads' sums, each after a barrier
// (`msm_big_round`, half = MSM_BIG / 2 down to 1), and thread 0 stores
// the bucket (`msm_big_store`); tree holds MSM_BIG points, 40 words each
PK_DEV void msm_big_partial(int key, int j, const int32_t *pts, const int *offsets,
                            const u32 *ent, int32_t *tree) {
  int lo = offsets[key], hi = offsets[key + 1];
  ge acc = ge_identity();
  for (int e = lo + j; e < hi; e += MSM_BIG) {
    u32 x = ent[e];
    ge p = msm_load(pts, x & 0x7FFFFFFFu);
    if (x >> 31) p = ge_neg(p);
    acc = e == lo + j ? p : ge_add(acc, p);
  }
  msm_store(tree, j, acc);
}

PK_DEV void msm_big_round(int j, int half, int32_t *tree) {
  if (j < half) msm_store(tree, j, ge_add(msm_load(tree, j), msm_load(tree, j + half)));
}

PK_DEV void msm_big_store(int key, const int32_t *tree, int32_t *buckets) {
  int w = key / MSM_D, d = key % MSM_D;
  msm_store(buckets, (size_t)w * MSM_HALF + d - 1, msm_load(tree, 0));
}

// phase 5, lane t = w · NSEG + s of a quad (segments of SEG buckets):
// from the top, run = Σ B_d and acc = Σ (d − lo + 1)·B_d (segs
// [2][ww · NSEG][40]); lanes past the last segment (live false) run along
PK_DEV void msm_segment(int t, bool live, int nseg, const int32_t *buckets,
                        int32_t *segs, Quad &qd) {
  ge run = ge_identity(), acc = ge_identity();
  for (int j = MSM_SEG - 1; j >= 0; j--) {
    qadd(qd, run, run, msm_load(buckets, (size_t)t * MSM_SEG + j));
    qadd(qd, acc, acc, run);
  }
  if (!live || qd.w > 0) return;
  msm_store(segs, t, run);
  msm_store(segs, (size_t)nseg + t, acc);
}

// phase 6a, lane w of a quad: Σ_d d·B_d = Σ_s acc_s + SEG · Σ_s s·run_s
PK_DEV ge msm_window(int w, int nseg, const int32_t *segs, Quad &qd) {
  ge tot = ge_identity(), run2 = ge_identity(), acc2 = ge_identity();
  for (int s = MSM_NSEG - 1; s >= 0; s--) {
    size_t t = (size_t)w * MSM_NSEG + s;
    qadd(qd, tot, tot, msm_load(segs, nseg + t));
    if (s > 0) {
      qadd(qd, run2, run2, msm_load(segs, t));
      qadd(qd, acc2, acc2, run2);
    }
  }
  for (int k = 0; k < MSM_SEG_LOG; k++) qdbl(qd, acc2, acc2);
  ge r;
  qadd(qd, r, tot, acc2);
  return r;
}

// phase 6b, on a quad (every lane the same chain): the Horner chain over
// the window sums (most significant first, 2^12 a step), plus the B term,
// and the exact identity test
PK_DEV bool msm_horner(const int32_t *sums, int nw, const ge &bterm, ge &total, Quad &qd) {
  ge acc = msm_load(sums, nw - 1);
  for (int w = nw - 2; w >= 0; w--) {
    for (int k = 0; k < MSM_C; k++) qdbl(qd, acc, acc);
    qadd(qd, acc, acc, msm_load(sums, w));
  }
  qadd(qd, total, acc, bterm);
  return fe_is_zero(total.x) && fe_eq(total.y, total.z);
}
