// Host build of the stage, wire and tool lane bodies (g++ -DPK_HOST): a stage
// kernel's entry point runs, for each group of 32 lanes, every role of
// phase 1 over the group's lanes, one role after another, then phase 2,
// over one scratch struct, as the kernel's barriers order them; a tool
// kernel's loops its per-lane body over the lanes. Used only to
// cross-check the device code against the plain PyTorch twins on a
// machine without nvcc; the replay never calls it.
#include "agg.cuh"
#include "forge.cuh"
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

// ed_verify over a scratch filled with 0xA5 a group: the four phase-1
// roles over the group's lanes one after another, then the table of −A,
// the chain, s·B's other windows, the addition and the compare on a quad
extern "C" int pk_ed_verify(int B, const void *base8, const void *pk, const void *r,
                            const void *s, const void *hb, int nb, const void *hnb,
                            void *ok, void *) {
  static VerifyScratch sc;
  const u32 *t = (const u32 *)base8;
  for (int g = 0; g < B; g += PK_GROUP) {
    int n = B - g < PK_GROUP ? B - g : PK_GROUP;
    u8 *raw = (u8 *)&sc;
    for (size_t k = 0; k < sizeof sc; k++) raw[k] = 0xA5;
    for (int l = 0; l < n; l++) {
      ed_role_hash(g + l, B, l, (CI)hb, nb, (CI)hnb, sc);
      edv_base_part(g + l, B, l, t, (CI)s, 0, EDV_W0, edv_part0(sc));
    }
    for (int l = 0; l < n; l++) edv_role_a(g + l, B, l, (CI)pk, sc);
    for (int l = 0; l < n; l++) edv_role_r(g + l, B, l, (CI)r, sc);
    for (int l = 0; l < n; l++) edv_role_s(g + l, B, l, t, (CI)s, sc);
    for (int l = 0; l < n; l++) {
      Quad1 qd{sc.qx, -1, l, 0, 0};
      edv_quad_table(sc, qd);
      ge p = edv_quad_chain(sc, qd);
      p = edv_quad_sb(g + l, B, t, (CI)s, p, sc, qd);
      edv_quad_compare(g + l, true, p, sc, qd, (OI)ok);
    }
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

// AW_H's tree: up level by level, the root's inverse on the warp, down
static void agg_tree_host(AggScratch &sc) {
  for (int n = PK_GROUP; n >= 1; n >>= 1)
    for (int t = 0; t < n; t++) agg_tree_up(sc, n, t);
  agg_tree_invert(sc);
  for (int n = 1; n <= PK_GROUP; n <<= 1)
    for (int t = 0; t < n; t++) agg_tree_down(sc, n, t);
}

// the window aggregate: agg_prep group by group, over a scratch filled
// with 0xA5 first (a read of what no earlier phase wrote gives garbage);
// each phase over the group's 32 lanes (lanes past B run along, as on the
// card: their Z's are leaves of the tree), in an order the kernel's
// barriers allow: every role's first phase, AW_H's tree, the phases after
// AB_ED and AB_INV, c (AB_C), then the products (AB_COEF) and the flags.
// the msm phase by phase, each phase's threads in
// turn (the atomics' places are then in point order), the scan
// sequential, a big bucket's tree round by round, the tree level by
// level (each level's reads before its writes), the quads' four
// products in order, the Horner warp's lanes one after another
extern "C" int pk_agg_prep(int B, int depth, int nb_ed, int nb_kes,
                           void *const *cols, void *pts, void *scal,
                           void *flags, void *eta, void *lv, void *) {
  AggShape s{B, depth, nb_ed, nb_kes, 0};
  AggIn in;
  for (int k = 0; k < AI_N; k++) in.c[k] = (CI)cols[k];
  AggOut o{(OI)pts, (u8 *)scal, (OI)flags, (OI)eta, (OI)lv, nullptr};
  static AggScratch sc;
  for (int g = 0; g < B; g += PK_GROUP) {
    u8 *raw = (u8 *)&sc;
    for (size_t k = 0; k < sizeof sc; k++) raw[k] = 0xA5;
#define AGG_LANES(body)                                   \
  for (int l = 0; l < PK_GROUP; l++) {                    \
    const bool live = g + l < B;                          \
    const int i = live ? g + l : B - 1;                   \
    body;                                                 \
  }
    AGG_LANES(agg_ae_digest(i, l, s, in, sc));
    AGG_LANES(agg_kes_digest(i, l, s, in, sc));
    AGG_LANES(agg_re_point(i, live, l, s, in, o, sc));
    AGG_LANES(agg_decompress(AI_VRF_V, PT_V, OK_V, i, live, l, s, in, o, sc));
    AGG_LANES(agg_al_point(i, live, l, s, in, o, sc));
    AGG_LANES(agg_rk_point(i, live, l, s, in, o, sc));
    AGG_LANES(agg_y_point(i, live, l, s, in, o, sc));
    AGG_LANES(agg_decompress(AI_VRF_U, PT_U, OK_U, i, live, l, s, in, o, sc));
    AGG_LANES(agg_g_point(i, live, l, s, in, o, sc));
    AGG_LANES(agg_h_point(i, live, l, s, in, o, sc));
    agg_tree_host(sc);
    AGG_LANES(agg_fs(i, l, s, in, sc));
    AGG_LANES(agg_ae_point(i, live, l, s, in, o, sc));
    AGG_LANES(agg_g_beta(i, l, s, in, sc));
    AGG_LANES(agg_h_challenge(i, l, s, in, sc));
    const int coef[8] = {AW_AE, AW_RE, AW_V, AW_RK, AW_U, AW_G, AW_H, AW_HASH};
    for (int r : coef) AGG_LANES(agg_products(r, i, live, l, s, in, o, sc));
    AGG_LANES(agg_flags(i, live, l, s, o, sc));
#undef AGG_LANES
  }
  return 0;
}

// the forge sweep group by group, over a scratch filled with 0xA5 first,
// in an order the kernel's barriers allow: H (warp 0), the table (pair
// A), H's tree and k (warp 2), pair A's part of k·B, Γ and 8Γ, pair B's
// k·H and the rest of k·B, the points stored, the leaves, the tree, the
// encodings, then c and s (warp 0) and β (warp 1)
extern "C" int pk_forge_sweep(int B, int P, long long slot0, const void *base8,
                              const void *pools, const void *nonce, void *out, void *) {
  ForgeArgs a{B, P, (int64_t)slot0, (const u8 *)pools, (const u8 *)nonce, (u8 *)out};
  const u32 *t = (const u32 *)base8;
  static ForgeScratch sc;
  ge g[PK_GROUP], g8[PK_GROUP], v[PK_GROUP];
  for (int q = 0; q < B; q += PK_GROUP) {
    const int n = B - q < PK_GROUP ? B - q : PK_GROUP;
    u8 *raw = (u8 *)&sc;
    for (size_t k = 0; k < sizeof sc; k++) raw[k] = 0xA5;
    // lanes past B run along (clamped), as on the card: the trees have 32 leaves
    int ii[PK_GROUP];
    for (int l = 0; l < PK_GROUP; l++) ii[l] = q + l < B ? q + l : B - 1;
    for (int l = 0; l < PK_GROUP; l++) fs_role_h(ii[l], l, a, sc);
    for (int l = 0; l < PK_GROUP; l++) {
      Pair pa{sc.x[0], -1, l, 0, 0};
      fs_pair_table(l, sc, pa);
    }
    for (int l = 0; l < PK_GROUP; l++) fs_k_leaf(l, sc);
    fs_tree(sc.ht.node, 0);
    for (int l = 0; l < PK_GROUP; l++) fs_k_derive(ii[l], l, a, sc);
    for (int l = 0; l < PK_GROUP; l++) {
      Pair pa{sc.x[0], -1, l, 0, 0};
      fs_pair_ua(l, t, sc, pa);
      fs_pair_gamma(ii[l], l, a, sc, pa, g[l], g8[l]);
    }
    for (int l = 0; l < PK_GROUP; l++) {
      Pair pb{sc.x[1], -1, l, 0, 0};
      v[l] = fs_pair_v(l, sc, pb);
      fs_pair_u(l, t, sc, pb);
    }
    for (int l = 0; l < PK_GROUP; l++) {
      fs_put_xyz(sc.fin.pts[0], l, g[l]);
      fs_put_xyz(sc.fin.pts[1], l, v[l]);
      fs_put_xyz(sc.fin.pts[2], l, g8[l]);
    }
    for (int l = 0; l < PK_GROUP; l++) fs_leaf(l, sc);
    fs_tree(sc.fin.node, 0);
    for (int l = 0; l < PK_GROUP; l++) fs_compress(l, sc);
    for (int l = 0; l < n; l++) fs_challenge(q + l, l, a, sc);
    for (int l = 0; l < n; l++) fs_beta(q + l, l, a, sc);
  }
  return 0;
}

// R = r·B of the 32 slots of the block at g from the r in sc.r: every
// live warp's walks (a warp with no slot below B keeps the identity),
// then each level of the teams' sums (the level's puts before its adds),
// then part 0's publish; p[t] holds thread t's point
static void es_host_sum(const u32 *table, int g, int B, SignScratch &sc, ge *p) {
  for (int t = 0; t < ES_THREADS; t++)
    p[t] = es_warp_live(t, g, B) ? es_walk(t, table, sc) : ge_identity();
  for (int d = 1; d < ES_TEAM; d <<= 1) {
    for (int t = 0; t < ES_THREADS; t++)
      if (es_warp_live(t, g, B)) es_level_put(t, d, p[t], sc);
    for (int t = 0; t < ES_THREADS; t++)
      if (es_warp_live(t, g, B)) es_level_add(t, d, p[t], sc);
  }
  for (int s = 0; s < PK_GROUP; s++) es_publish(s, p[ES_TEAM * s], sc);
}

// the signer block by block over a scratch filled with 0xA5 first, in an
// order the kernel's barriers allow: warp 0's counts and r (its flag for
// the block), warps 1-7's staging, the teams' R, the tree, the finish
extern "C" int pk_ed_sign(int B, int NB, const void *base8, const void *a,
                          const void *aenc, const void *rblocks, const void *rnb,
                          const void *hblocks, const void *hnb, void *out, void *bad, void *) {
  SignArgs sa{B, NB, (const u32 *)base8, (const u8 *)a, (const u8 *)aenc,
              (const u8 *)rblocks, (const int32_t *)rnb, (const u8 *)hblocks,
              (const int32_t *)hnb, (u8 *)out, (int32_t *)bad};
  static SignScratch sc;
  static ge p[ES_THREADS];
  for (int g = 0; g < B; g += PK_GROUP) {
    u8 *raw = (u8 *)&sc;
    for (size_t k = 0; k < sizeof sc; k++) raw[k] = 0xA5;
    bool any = false;
    for (int l = 0; l < PK_GROUP; l++) any = es_r(l, g, sa, sc, nullptr) || any;
    sa.bad[g / PK_GROUP] = any ? 1 : 0;
    for (int t = 0; t < ES_THREADS - PK_GROUP; t++) es_stage(t, g, sa, sc);
    es_host_sum(sa.base8, g, B, sc, p);
    fs_tree(sc.node, 0);
    for (int l = 0; l < PK_GROUP; l++) es_finish(l, g, sa, sc, nullptr);
  }
  return 0;
}

// host only: the signer's R = r·B alone (the teams' walks and sums) for
// [B][32] little-endian scalars r -> [B][40] limbs X, Y, Z, T
extern "C" int pk_ed_sign_walk(int B, const void *base8, const void *r, void *pts) {
  static SignScratch sc;
  static ge p[ES_THREADS];
  for (int g = 0; g < B; g += PK_GROUP) {
    u8 *raw = (u8 *)&sc;
    for (size_t k = 0; k < sizeof sc; k++) raw[k] = 0xA5;
    for (int s = 0; s < PK_GROUP; s++) {
      const int ii = g + s < B ? g + s : B - 1;
      for (int k = 0; k < 32; k++) sc.r[(k << 5) + s] = ((const u8 *)r)[32 * ii + k];
    }
    es_host_sum((const u32 *)base8, g, B, sc, p);
    for (int s = 0; s < PK_GROUP && g + s < B; s++) {
      const ge &q = p[ES_TEAM * s];
      u32 *o = (u32 *)pts + (size_t)40 * (g + s);
      for (int l = 0; l < 10; l++) {
        o[l] = q.x.v[l];
        o[10 + l] = q.y.v[l];
        o[20 + l] = q.z.v[l];
        o[30 + l] = q.t.v[l];
      }
    }
  }
  return 0;
}

// host only: sc_reduce512 over [B][64] little-endian bytes -> [B][32]
extern "C" int pk_sc_reduce(int B, const void *in, void *out) {
  for (int b = 0; b < B; b++) sc_reduce512((const u8 *)in + 64 * b, (u8 *)out + 32 * b);
  return 0;
}

// host only: agg_prep's tree over 64 field elements [64][10] -> their
// inverses [64][10] (0 for a zero)
extern "C" int pk_agg_inv_tree(const void *z, void *inv) {
  static AggScratch sc;
  for (int k = 0; k < AGG_LEAVES; k++) {
    fe x;
    for (int l = 0; l < 10; l++) x.v[l] = ((const u32 *)z)[10 * k + l];
    agg_tree_leaf(sc, k, x);
  }
  agg_tree_host(sc);
  for (int k = 0; k < AGG_LEAVES; k++) {
    fe x = agg_fe_get(sc.inv, AGG_TN, AGG_LEAVES + k);
    for (int l = 0; l < 10; l++) ((u32 *)inv)[10 * k + l] = x.v[l];
  }
  return 0;
}

// host only: sc_mul and sc_add over [B, 32] little-endian byte rows
extern "C" int pk_sc_mul(int B, const void *a, const void *b, void *out) {
  for (int i = 0; i < B; i++)
    sc_mul<8>((const u8 *)a + 32 * i, (const u8 *)b + 32 * i, (u8 *)out + 32 * i);
  return 0;
}

extern "C" int pk_sc_add(int B, const void *a, const void *b, void *out) {
  for (int i = 0; i < B; i++)
    sc_add((const u8 *)a + 32 * i, (const u8 *)b + 32 * i, (u8 *)out + 32 * i);
  return 0;
}

// host only: agg_table_row over [R][32] int64 column sums -> [R][32]
extern "C" int pk_agg_tables(int R, const void *raw, void *out, void *) {
  for (int r = 0; r < R; r++) {
    u64 cols[32];
    for (int k = 0; k < 32; k++) cols[k] = (u64)((const int64_t *)raw)[(size_t)r * 32 + k];
    agg_table_row(cols, (u8 *)out + (size_t)r * 32);
  }
  return 0;
}

// the dedupe block by block, in `order`: 0 the grid's, -1 reversed, else a
// shuffle seeded by it. A block runs to its end (its tile, then the merges
// its tickets hand it, its column's root, the B row) before the next
// starts, one of the orders the card may take; the scratch and each
// block's shared memory are filled with 0xA5 first (a read of what no
// earlier phase wrote gives garbage), the tickets as the caller gives them
extern "C" int pk_dedupe_order(int order, int B, int cap, const void *k0,
                               const void *k1, const void *k2, const void *k3,
                               const void *coeffs, const void *pts, const void *brows,
                               void *scratch, size_t scratch_bytes, void *tickets, void *red,
                               void *tpts, void *ok, void *) {
  if (!dd_shape_ok(B, cap) || scratch_bytes < dd_scratch_bytes(dd_tiles(B))) return -1;
  const void *keys[DD_KEYS] = {k0, k1, k2, k3};
  DedupeArgs a = dd_args(B, cap, keys, coeffs, pts, brows, scratch, tickets, red, tpts, ok);
  for (size_t k = 0; k < scratch_bytes; k++) ((u8 *)scratch)[k] = 0xA5;
  const int n = DD_KEYS * a.T;
  int *blocks = new int[n];
  for (int k = 0; k < n; k++) blocks[k] = order < 0 ? n - 1 - k : k;
  u64 x = (u64)order * 0x9E3779B97F4A7C15ull + 1;  // a seeded Fisher-Yates shuffle (xorshift)
  for (int k = n - 1; order > 0 && k > 0; k--) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    int j = (int)(x % (u64)(k + 1)), t = blocks[k];
    blocks[k] = blocks[j];
    blocks[j] = t;
  }
  static DedupeSmem s;
  for (int k = 0; k < n; k++) {
    for (size_t q = 0; q < sizeof s; q++) ((u8 *)&s)[q] = 0xA5;
    dd_block(blocks[k], a, s);
  }
  delete[] blocks;
  return 0;
}

extern "C" int pk_dedupe(int B, int cap, const void *k0, const void *k1,
                         const void *k2, const void *k3, const void *coeffs, const void *pts,
                         const void *brows, void *scratch, size_t scratch_bytes, void *tickets,
                         void *red, void *tpts, void *ok, void *stream) {
  return pk_dedupe_order(1, B, cap, k0, k1, k2, k3, coeffs, pts, brows, scratch,
                         scratch_bytes, tickets, red, tpts, ok, stream);
}

// host only: the scratch bytes and tickets of a launch over B lanes
extern "C" int pk_dedupe_shape(int B, void *out) {
  int T = dd_tiles(B);
  ((int64_t *)out)[0] = DD_KEYS * T;
  ((int64_t *)out)[1] = (int64_t)dd_scratch_bytes(T);
  ((int64_t *)out)[2] = dd_ticket_count(T);
  return 0;
}

extern "C" int pk_msm(int n, int n_small, int ws, int ww, const void *base8,
                      const void *points, const void *scalars, const void *base,
                      void *digits, void *counts, void *offsets, void *cursor, void *big,
                      void *ent, void *ekey, void *part, void *tailp, void *buckets,
                      void *treea, void *treeb, void *wsum, void *bterm, void *total,
                      void *ident, void *) {
  if (ww > MSM_WMAX || ws > ww) return -1;
  MsmShape s{n, n_small, ws, ww};
  int m = ww * MSM_D, emax = n_small * ws + (n - n_small) * ww;
  int nch = (emax + MSM_CH - 1) / MSM_CH;
  int *cnt = (int *)counts, *off = (int *)offsets, *cur = (int *)cursor, *bg = (int *)big;
  OI bk = (OI)buckets, pt = (OI)part, tl = (OI)tailp;
  for (int p = 0; p < n; p++) msm_recode(p, s, (const u8 *)scalars, (OI)digits, cnt);
  int acc = 0;
  for (int i = 0; i < m; i++) {
    off[i] = cur[i] = acc;
    acc += cnt[i];
  }
  off[m] = acc;
  for (int p = 0; p < n; p++) msm_scatter(p, s, (CI)digits, cur, (u32 *)ent, (int *)ekey);
  for (int t = 0; t < nch; t++)
    msm_chunk(t, m, off, (const u32 *)ent, (const int *)ekey, (CI)points, bk, pt, tl);
  for (int key = 0; key < m; key++) msm_span(key, off, pt, tl, bk, bg);
  static int32_t tree[MSM_BIG * 40];
  for (int k = 0; k < bg[0]; k++) {
    int key = bg[1 + k];
    for (int j = 0; j < MSM_BIG; j++) msm_big_partial(key, j, off, pt, tl, tree);
    for (int half = MSM_BIG / 2; half > 0; half >>= 1)
      for (int j = 0; j < MSM_BIG; j++) msm_big_round(j, half, tree);
    msm_big_store(key, tree, bk);
  }
  static u32 qx[PK_QUAD_WORDS];
  Quad qd{qx, -1, 0, 0, 0};
  u8 b[32];
  for (int k = 0; k < 32; k++) b[k] = ((const u8 *)base)[k];
  msm_store((OI)bterm, 0, qbase_mul_w8(qd, (const u32 *)base8, b));
  // the wide levels, a thread a node and role; then the join as its
  // blocks run on the card, one window's levels to its sum before the
  // next window starts (blocks keep no order among themselves), each
  // level's reads before its writes
  OI ta = (OI)treea, tb = (OI)treeb, in = nullptr;
  for (int lvl = 1; lvl < MSM_WIDE; lvl++) {
    int t = ww * (MSM_HALF >> (lvl + 1));
    OI out = lvl % 2 ? ta : tb;
    for (int q = 0; q < t; q++)
      for (int role = 0; role < 2; role++) {
        if (lvl == 1) msm_leaf4(q, role, t, off, bk, out);
        else msm_wide_node(q, role, t, in, out);
      }
    in = out;
  }
  OI jb = in == ta ? tb : ta;
  static ge v[2][MSM_JOIN / 2];
  for (int w = 0; w < ww; w++) {
    CI iw = in + (size_t)w * MSM_JOIN * 40, inn = in + ((size_t)ww + w) * MSM_JOIN * 40;
    for (int k = MSM_JOIN / 2; k >= 1; k >>= 1) {
      OI ow = msm_join_level(jb, w, k), on = ow + (size_t)k * 40;
      for (int role = 0; role < 2; role++)
        for (int q = 0; q < k; q++) v[role][q] = msm_join_node(role, q, iw, inn, qd);
      for (int role = 0; role < 2; role++)
        for (int q = 0; q < k; q++) msm_store(role ? on : ow, q, v[role][q]);
      iw = ow;
      inn = on;
    }
    msm_store((OI)wsum, w, msm_load(iw, 0));
  }
  msm_horner_warp((OI)wsum, ww, (OI)bterm, (OI)total);
  ((OI)ident)[0] = msm_identity((OI)total);
  return 0;
}

// host only: msm's Horner chain over nw window sums and a B term [40],
// on the warp (msm_horner_warp) and on one thread (ge_dbl, T on a step's
// last doubling, ge_add) -> warp [40], thread [40]
extern "C" int pk_msm_horner(int nw, const void *sums, const void *bterm, void *warp,
                             void *thread) {
  if (nw < 1 || nw > MSM_WMAX) return -1;
  msm_horner_warp((CI)sums, nw, (CI)bterm, (OI)warp);
  ge acc = msm_load((CI)sums, nw - 1);
  for (int w = nw - 2; w >= 0; w--) {
    for (int k = 0; k < MSM_C; k++) ge_dbl(acc, acc, k == MSM_C - 1);
    acc = ge_add(acc, msm_load((CI)sums, w));
  }
  msm_store((OI)thread, 0, ge_add(acc, msm_load((CI)bterm, 0)));
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
