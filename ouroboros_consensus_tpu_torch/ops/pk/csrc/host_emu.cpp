// Host build of the stage and tool lane bodies (g++ -DPK_HOST): each
// entry point loops the CUDA kernel's per-lane body over the lanes. Used
// only to cross-check the device code against the plain PyTorch twins on
// a machine without nvcc; the replay never calls it.
#include "tools.cuh"

typedef const int32_t *CI;
typedef int32_t *OI;

extern "C" int pk_ed(int B, const void *base8, const void *pk, const void *s,
                     const void *hb, int nb, const void *hnb, void *ok,
                     void *pt, void *) {
  for (int i = 0; i < B; i++)
    ed_lane(i, B, (const u32 *)base8, (const int32_t *)pk, (const int32_t *)s,
            (const int32_t *)hb, nb, (const int32_t *)hnb, (int32_t *)ok,
            (int32_t *)pt);
  return 0;
}

extern "C" int pk_kes(int B, int depth, const void *base8, const void *vk,
                      const void *period, const void *s, const void *leaf,
                      const void *sib, const void *hb, int nb,
                      const void *hnb, void *ok, void *pt, void *) {
  for (int i = 0; i < B; i++)
    kes_lane(i, B, depth, (const u32 *)base8, (const int32_t *)vk,
             (const int32_t *)period, (const int32_t *)s,
             (const int32_t *)leaf, (const int32_t *)sib,
             (const int32_t *)hb, nb, (const int32_t *)hnb, (int32_t *)ok,
             (int32_t *)pt);
  return 0;
}

extern "C" int pk_vrf_prep(int B, const void *pk, const void *gamma,
                           const void *s, const void *alpha, void *ok,
                           void *prep, void *) {
  for (int i = 0; i < B; i++)
    vrf_prep_lane(i, B, (CI)pk, (CI)gamma, (CI)s, (CI)alpha, (OI)ok, (OI)prep);
  return 0;
}

extern "C" int pk_vrf_bc_prep(int B, const void *pk, const void *gamma,
                              const void *u, const void *v, const void *s,
                              const void *alpha, void *ok, void *c16,
                              void *prep, void *) {
  for (int i = 0; i < B; i++)
    vrf_bc_prep_lane(i, B, (CI)pk, (CI)gamma, (CI)u, (CI)v, (CI)s, (CI)alpha,
                     (OI)ok, (OI)c16, (OI)prep);
  return 0;
}

extern "C" int pk_vrf_ladders(int B, const void *base8, const void *c16,
                              const void *s, const void *prep, void *pts,
                              void *) {
  for (int i = 0; i < B; i++)
    vrf_ladder_lane(i, B, (const u32 *)base8, (const int32_t *)c16,
                    (const int32_t *)s, (const int32_t *)prep,
                    (int32_t *)pts);
  return 0;
}

extern "C" int pk_finish(int B, const void *edok, const void *edpt,
                         const void *edr, const void *kesok,
                         const void *kespt, const void *kesr,
                         const void *vrfok, const void *vrfpts,
                         const void *c, const void *beta, const void *tlo,
                         const void *thi, void *out, void *eta, void *lv,
                         void *) {
  for (int i = 0; i < B; i++)
    finish_lane(i, B, (const int32_t *)edok, (const int32_t *)edpt,
                (const int32_t *)edr, (const int32_t *)kesok,
                (const int32_t *)kespt, (const int32_t *)kesr,
                (const int32_t *)vrfok, (const int32_t *)vrfpts,
                (const int32_t *)c, (const int32_t *)beta,
                (const int32_t *)tlo, (const int32_t *)thi, (int32_t *)out,
                (int32_t *)eta, (int32_t *)lv);
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
