// Host build of the stage lane bodies (g++ -DPK_HOST): each entry point
// loops the CUDA kernel's per-lane body over the lanes. Used only to
// cross-check the device code against the plain PyTorch twins on a
// machine without nvcc; the replay never calls it.
#include "stages.cuh"

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
                           const void *u, const void *v, const void *s,
                           const void *alpha, void *ok, void *c16,
                           void *prep, void *) {
  for (int i = 0; i < B; i++)
    vrf_prep_lane(i, B, (const int32_t *)pk, (const int32_t *)gamma,
                  (const int32_t *)u, (const int32_t *)v, (const int32_t *)s,
                  (const int32_t *)alpha, (int32_t *)ok, (int32_t *)c16,
                  (int32_t *)prep);
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
