// Host build of the stage, wire and tool lane bodies (g++ -DPK_HOST): a stage
// kernel's entry point runs, for each group of 32 lanes, every role of
// phase 1 over the group's lanes, one role after another, then phase 2,
// over one scratch struct, as the kernel's barriers order them; a tool
// kernel's loops its per-lane body over the lanes. Used only to
// cross-check the device code against the plain PyTorch twins on a
// machine without nvcc; the replay never calls it.
#include "agg.cuh"
#include "tools.cuh"
#include "wire.cuh"

typedef const int32_t *CI;
typedef int32_t *OI;

// ed's and kes's chain on a quad, the four products of each step in order
static void ed_phase2(int g, int n, int B, int flags, EdScratch &sc, OI ok,
                      OI pt) {
  for (int l = 0; l < n; l++) {
    Quad qd{sc.qx, -1, l, 0, 0};
    ed_quad_chain(g + l, B, true, flags, sc, qd, ok, pt);
  }
}

extern "C" int pk_ed(int B, const void *base8, const void *pk, const void *s,
                     const void *hb, int nb, const void *hnb, void *ok,
                     void *pt, void *) {
  EdScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    for (int l = 0; l < n; l++) ed_role_hash(g + l, B, l, (CI)hb, nb, (CI)hnb, sc);
    for (int l = 0; l < n; l++) ed_role_table(g + l, B, l, (CI)pk, sc);
    for (int l = 0; l < n; l++)
      ed_role_base(g + l, B, l, (const u32 *)base8, (CI)s, sc);
    ed_phase2(g, n, B, 2, sc, (OI)ok, (OI)pt);
  }
  return 0;
}

extern "C" int pk_kes(int B, int depth, const void *base8, const void *vk,
                      const void *period, const void *s, const void *leaf,
                      const void *sib, const void *hb, int nb,
                      const void *hnb, void *ok, void *pt, void *) {
  EdScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    for (int l = 0; l < n; l++) ed_role_hash(g + l, B, l, (CI)hb, nb, (CI)hnb, sc);
    for (int l = 0; l < n; l++) ed_role_table(g + l, B, l, (CI)leaf, sc);
    for (int l = 0; l < n; l++)
      ed_role_base(g + l, B, l, (const u32 *)base8, (CI)s, sc);
    for (int l = 0; l < n; l++)
      kes_role_merkle(g + l, B, l, depth, (CI)vk, (CI)period, (CI)leaf,
                      (CI)sib, sc);
    ed_phase2(g, n, B, 3, sc, (OI)ok, (OI)pt);
  }
  return 0;
}

extern "C" int pk_vrf_prep(int B, const void *pk, const void *gamma,
                           const void *s, const void *alpha, void *ok,
                           void *prep, void *) {
  BcPrepScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    for (int l = 0; l < n; l++) d3_role_h(g + l, B, true, (CI)pk, (CI)alpha, (OI)prep);
    for (int l = 0; l < n; l++) bc_role_y(g + l, B, true, l, (CI)pk, (OI)prep, sc);
    for (int l = 0; l < n; l++)
      bc_role_gamma(g + l, B, true, l, (CI)gamma, (CI)s, (OI)prep, sc);
    for (int l = 0; l < n; l++) bc_ok(g + l, l, sc, (OI)ok);
  }
  return 0;
}

extern "C" int pk_vrf_bc_prep(int B, const void *pk, const void *gamma,
                              const void *u, const void *v, const void *s,
                              const void *alpha, void *ok, void *c16,
                              void *prep, void *) {
  BcPrepScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    for (int l = 0; l < n; l++)
      bc_role_h(g + l, B, true, (CI)pk, (CI)gamma, (CI)u, (CI)v, (CI)alpha,
                (OI)c16, (OI)prep);
    for (int l = 0; l < n; l++) bc_role_y(g + l, B, true, l, (CI)pk, (OI)prep, sc);
    for (int l = 0; l < n; l++)
      bc_role_gamma(g + l, B, true, l, (CI)gamma, (CI)s, (OI)prep, sc);
    for (int l = 0; l < n; l++) bc_ok(g + l, l, sc, (OI)ok);
  }
  return 0;
}

extern "C" int pk_vrf_ladders(int B, const void *base8, const void *c16,
                              const void *s, const void *prep, void *pts,
                              void *) {
  const u32 *t = (const u32 *)base8;
  CI c = (CI)c16, sp = (CI)s, p = (CI)prep;
  OI o = (OI)pts;
  QLadderScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    for (int l = 0; l < n; l++) {
      LaneTab th{sc.tab_h, l};
      ladder_table_h(g + l, B, p, th);
    }
    for (int l = 0; l < n; l++) {
      LaneTab tg{sc.tab_g, l};
      ladder_table_g(g + l, B, p, tg);
    }
    for (int l = 0; l < n; l++) {
      LaneTab ty{sc.tab_y, l};
      ladder_table_y(g + l, B, p, ty);
    }
    for (int l = 0; l < n; l++) ladder_passthrough(g + l, B, p, o);
    for (int l = 0; l < n; l++) {
      Quad qu{sc.qx, -1, l, 0, 0};
      ladder_qbase(g + l, B, t, sp, qu, sc.sb);
    }
    for (int l = 0; l < n; l++) {
      Quad qv{sc.qx, -1, l, 0, 0};
      ladder_qv(g + l, B, true, c, sp, LaneTab{sc.tab_h, l},
                LaneTab{sc.tab_g, l}, qv, o);
    }
    for (int l = 0; l < n; l++) {
      Quad qu{sc.qx, -1, l, 0, 0};
      ladder_qu(g + l, B, true, c, LaneTab{sc.tab_y, l}, sc.sb, qu, o);
    }
  }
  return 0;
}

extern "C" int pk_finish(int B, const void *edok, const void *edpt,
                         const void *edr, const void *kesok,
                         const void *kespt, const void *kesr,
                         const void *vrfok, const void *vrfpts,
                         const void *c, const void *beta, const void *tlo,
                         const void *thi, void *out, void *eta, void *lv,
                         void *) {
  FinishScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    for (int l = 0; l < n; l++) finish_role_vrf(g + l, B, l, (CI)vrfpts, (CI)c, sc);
    for (int l = 0; l < n; l++) finish_role_beta(g + l, B, l, (CI)vrfpts, (CI)beta, sc);
    for (int l = 0; l < n; l++)
      finish_role_sig(g + l, B, true, (CI)edok, (CI)edpt, (CI)edr, (CI)kesok,
                      (CI)kespt, (CI)kesr, (CI)beta, (CI)tlo, (CI)thi, (OI)out,
                      (OI)eta, (OI)lv);
    for (int l = 0; l < n; l++) finish_vrf_ok(g + l, B, l, (CI)vrfok, sc, (OI)out);
  }
  return 0;
}

// the window aggregate: agg_prep group by group (each role over the
// group's lanes, then the transcript hashes, then each role's products);
// agg_tables row by row; the msm phase by phase, each phase's threads in
// turn (the atomics' places are then in point order), the scan
// sequential, a big bucket's tree round by round, the quads' four
// products in order
extern "C" int pk_agg_prep(int B, int depth, int nb_ed, int nb_kes,
                           void *const *cols, void *pts, void *scal,
                           void *flags, void *eta, void *lv, void *) {
  AggShape s{B, depth, nb_ed, nb_kes};
  AggIn in;
  for (int k = 0; k < AI_N; k++) in.c[k] = (CI)cols[k];
  AggOut o{(OI)pts, (u8 *)scal, (OI)flags, (OI)eta, (OI)lv};
  static AggScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    for (int l = 0; l < n; l++) agg_role_ed(g + l, true, l, s, in, o, sc);
    for (int l = 0; l < n; l++) agg_role_kes(g + l, true, l, s, in, o, sc);
    for (int l = 0; l < n; l++) agg_role_h(g + l, true, l, s, in, o, sc);
    for (int l = 0; l < n; l++) agg_role_gamma(g + l, true, l, s, in, o, sc);
    for (int l = 0; l < n; l++) agg_fs(g + l, l, s, in, sc);
    for (int r = 0; r < 4; r++)
      for (int l = 0; l < n; l++) agg_products(r, g + l, true, l, s, in, o, sc);
  }
  return 0;
}

// host only: sc_mul and sc_add over [B, 32] little-endian byte rows
extern "C" int pk_sc_mul(int B, const void *a, const void *b, void *out) {
  for (int i = 0; i < B; i++)
    sc_mul((const u8 *)a + 32 * i, 32, (const u8 *)b + 32 * i, 32, (u8 *)out + 32 * i);
  return 0;
}

extern "C" int pk_sc_add(int B, const void *a, const void *b, void *out) {
  for (int i = 0; i < B; i++)
    sc_add((const u8 *)a + 32 * i, (const u8 *)b + 32 * i, (u8 *)out + 32 * i);
  return 0;
}

extern "C" int pk_agg_tables(int R, const void *raw, void *out, void *) {
  for (int r = 0; r < R; r++) agg_table_row(r, (const int64_t *)raw, (u8 *)out);
  return 0;
}

extern "C" int pk_msm(int n, int n_small, int ws, int ww, const void *base8,
                      const void *points, const void *scalars, const void *base,
                      void *digits, void *counts, void *offsets, void *cursor,
                      void *big, void *ent, void *buckets, void *segs, void *total,
                      void *ident, void *) {
  if (ww > MSM_WMAX || ws > ww) return -1;
  MsmShape s{n, n_small, ws, ww};
  int m = ww * MSM_D, nb = ww * MSM_HALF, nseg = ww * MSM_NSEG;
  int *cnt = (int *)counts, *off = (int *)offsets, *cur = (int *)cursor, *bg = (int *)big;
  for (int p = 0; p < n; p++) msm_recode(p, s, (const u8 *)scalars, (OI)digits, cnt);
  int acc = 0;
  for (int i = 0; i < m; i++) {
    off[i] = cur[i] = acc;
    acc += cnt[i];
    if (cnt[i] > MSM_SMALL) bg[1 + bg[0]++] = i;
  }
  off[m] = acc;
  for (int p = 0; p < n; p++) msm_scatter(p, s, (CI)digits, cur, (u32 *)ent);
  for (int t = 0; t < nb; t++) msm_bucket(t, (CI)points, off, (const u32 *)ent, (OI)buckets);
  static int32_t tree[MSM_BIG * 40];
  for (int k = 0; k < bg[0]; k++) {
    int key = bg[1 + k];
    for (int j = 0; j < MSM_BIG; j++)
      msm_big_partial(key, j, (CI)points, off, (const u32 *)ent, tree);
    for (int half = MSM_BIG / 2; half > 0; half >>= 1)
      for (int j = 0; j < MSM_BIG; j++) msm_big_round(j, half, tree);
    msm_big_store(key, tree, (OI)buckets);
  }
  static u32 qx[PK_QUAD_WORDS];
  for (int t = 0; t < nseg; t++) {
    Quad qd{qx, -1, 0, 0, 0};
    msm_segment(t, true, nseg, (CI)buckets, (OI)segs, qd);
  }
  static int32_t sums[MSM_WMAX * 40];
  Quad qd{qx, -1, 0, 0, 0};
  for (int w = 0; w < ww; w++) msm_store(sums, w, msm_window(w, nseg, (CI)segs, qd));
  u8 b[32];
  for (int k = 0; k < 32; k++) b[k] = ((const u8 *)base)[k];
  ge tot;
  bool id = msm_horner(sums, ww, qbase_mul_w8(qd, (const u32 *)base8, b), tot, qd);
  msm_store((OI)total, 0, tot);
  ((OI)ident)[0] = id ? 1 : 0;
  return 0;
}

// the wire kernels: unpack block by block (the tile's staging, then its
// rows, each over every thread of the block in turn); the fold chunk by
// chunk (the producers fill the chunk's ring slot, then the chain folds it)
extern "C" int pk_unpack(int B, const int *lay, const void *body,
                         const void *kes_rs, const void *tail_idx,
                         const void *tail_tab, const void *slot,
                         const void *counter, const void *c0,
                         const void *thr_idx, const void *thr_tab,
                         const void *nonce, void *out, void *) {
  WireLayout L{lay[0], lay[1], lay[2], lay[3], lay[4], lay[5],
               lay[6], lay[7], lay[8], lay[9], lay[10]};
  WireIn in{(const u8 *)body, (const u8 *)kes_rs, (CI)tail_idx,
            (const u8 *)tail_tab, (CI)slot, (CI)counter, (CI)c0, (CI)thr_idx,
            (const u8 *)thr_tab, (const u8 *)nonce};
  const UnpackGrid g = unpack_grid(L, in, B);
  u8 *sm = new u8[g.smem];
  const WireTile t = wire_tile(sm, L, g.tl, g.lt);
  for (int l0 = 0; l0 < B; l0 += g.tl)
    for (int y = 0; y < g.groups; y++) {
      int rb, re, n = B - l0 < g.tl ? B - l0 : g.tl;
      unpack_group_rows(g, y, rb, re);
      unpack_stage(L, in, t, l0, n, g.vec, 0, 1);
      if (unpack_has_alpha(L, rb, re)) unpack_alphas(L, in, t, l0, n, 0, 1);
      unpack_rows(L, t, rb, re, l0, n, B, (OI)out, g.v4, 0, 1);
    }
  delete[] sm;
  return 0;
}

extern "C" int pk_nonce_fold(int B, int n_real, const void *beta,
                             const void *within, const void *cin, void *cout,
                             void *) {
  static FoldRing ring;
  const B2bCols init = b2b_init4(0);
  FoldState st = fold_load((const u8 *)cin, 0);
  for (int c = 0; c * FOLD_CHUNK < n_real; c++) {
    int s = c % FOLD_SLOTS;
    for (int l = 0; l < FOLD_CHUNK && c * FOLD_CHUNK + l < n_real; l++)
      fold_produce((CI)beta, (const u8 *)within, B, c * FOLD_CHUNK + l, ring, s, l);
    for (int l = 0; l < FOLD_CHUNK && c * FOLD_CHUNK + l < n_real; l++)
      fold_step(st, init, ring, s, l, 0);
  }
  fold_store(st, (u8 *)cout);
  return 0;
}

// the compression instrument's chains (nonce_fold.cu, b2b_bench_kernel):
// mode 0 b2b_256_1, mode 1 pk.cuh's blake2b_256, mode 2 b2b_compress4
// (its four columns in one thread); no cycles on the host
extern "C" int pk_b2b_bench(int reps, int mode, const void *in, void *out,
                            void *cycles, void *) {
  const u64 *w = (const u64 *)in;
  u64 ev[4] = {w[0], w[1], w[2], w[3]}, e[4] = {w[4], w[5], w[6], w[7]};
  const B2bCols init = b2b_init4(0);
  for (int r = 0; r < reps; r++) {
    if (mode == 0) {
      b2b_combine(ev, e);
    } else if (mode == 1) {
      u8 msg[64], dg[32];
      for (int j = 0; j < 4; j++) {
        word_bytes(msg, j, ev[j]);
        word_bytes(msg + 32, j, e[j]);
      }
      blake2b_256(msg, 64, dg);
      for (int j = 0; j < 4; j++) ev[j] = bytes_word(dg, j);
    } else if (mode == 2) {
      u64 m[16] = {ev[0], ev[1], ev[2], ev[3], e[0], e[1], e[2], e[3]};
      b2b_compress4(init, m, 0, ev);
    } else {
      return -1;
    }
  }
  for (int j = 0; j < 4; j++) ((u64 *)out)[j] = ev[j];
  ((long long *)cycles)[0] = 0;
  return 0;
}

// host only: b2b_256_1 over B messages of up to 128 bytes: msg [B, 128]
// uint8 (zero past each length), len [B] int32 -> digests [B, 32] uint8
extern "C" int pk_b2b_one(int B, const void *msg, const void *len, void *out) {
  for (int i = 0; i < B; i++) {
    const u8 *b = (const u8 *)msg + (size_t)i * 128;
    u64 m[16], h[4];
    for (int j = 0; j < 16; j++) m[j] = bytes_word(b, j);
    b2b_256_1(m, (u64)((CI)len)[i], h);
    for (int j = 0; j < 4; j++) word_bytes((u8 *)out + (size_t)i * 32, j, h[j]);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Field ops over [10, B] limb columns, and the tool kernels' lane bodies
// ---------------------------------------------------------------------------

static fe load_fe(CI col, int i, int B) {
  fe a;
  for (int l = 0; l < 10; l++) a.v[l] = (u32)col[(size_t)l * B + i];
  return a;
}

static void store_fe(OI col, int i, int B, const fe &a) {
  for (int l = 0; l < 10; l++) col[(size_t)l * B + i] = (int32_t)a.v[l];
}

extern "C" int pk_fe_sq(int B, const void *a, void *out, void *) {
  for (int i = 0; i < B; i++) store_fe((OI)out, i, B, fe_sq(load_fe((CI)a, i, B)));
  return 0;
}

extern "C" int pk_fe_bench(int B, int op, int k, const void *x, void *out, void *) {
  for (int i = 0; i < B; i++) {
    if (op == 0) fe_bench_lane<0>(i, B, k, (CI)x, (OI)out);
    else if (op == 1) fe_bench_lane<1>(i, B, k, (CI)x, (OI)out);
    else if (op == 2) fe_bench_lane<2>(i, B, k, (CI)x, (OI)out);
    else return -1;
  }
  return 0;
}

extern "C" int pk_prim_sha(int B, const void *d, void *o, void *) {
  for (int i = 0; i < B; i++) prim_sha_lane(i, B, (CI)d, (OI)o);
  return 0;
}

extern "C" int pk_prim_shav(int B, const void *blk, int nb, const void *n, void *o, void *) {
  for (int i = 0; i < B; i++) prim_shav_lane(i, B, (CI)blk, nb, (CI)n, (OI)o);
  return 0;
}

extern "C" int pk_prim_b2b(int B, const void *d, void *o, void *) {
  for (int i = 0; i < B; i++) prim_b2b_lane(i, B, (CI)d, (OI)o);
  return 0;
}

extern "C" int pk_prim_base(int B, const void *t, const void *d, void *o, void *) {
  for (int i = 0; i < B; i++) prim_base_lane(i, B, (const u32 *)t, (CI)d, (OI)o);
  return 0;
}

extern "C" int pk_prim_lad(int B, const void *p, const void *d, void *o, void *) {
  for (int i = 0; i < B; i++) prim_lad_lane(i, B, (CI)p, (CI)d, (OI)o);
  return 0;
}

extern "C" int pk_prim_dec(int B, const void *e, void *ok, void *o, void *) {
  for (int i = 0; i < B; i++) prim_dec_lane(i, B, (CI)e, (OI)ok, (OI)o);
  return 0;
}

extern "C" int pk_prim_red(int B, const void *r, void *o, void *c, void *) {
  for (int i = 0; i < B; i++) prim_red_lane(i, B, (CI)r, (OI)o, (OI)c);
  return 0;
}
