// Tool kernels `primitives`: the per-primitive bisection harness, one
// small kernel per device primitive (tools.cuh), one lane per thread.
// Replaces the TPU harness scripts/debug_pk_tpu.py:run_kernel.
#include "tools.cuh"

#define PK_GRID(B) (((B) + 127) / 128), 128, 0, (cudaStream_t)stream
#define PK_LANE int i = blockIdx.x * blockDim.x + threadIdx.x; if (i < B)

__global__ void __launch_bounds__(128) k_sha(int B, const int32_t *d, int32_t *o) {
  PK_LANE prim_sha_lane(i, B, d, o);
}
__global__ void __launch_bounds__(128) k_shav(int B, const int32_t *blk, int nb,
                                              const int32_t *n, int32_t *o) {
  PK_LANE prim_shav_lane(i, B, blk, nb, n, o);
}
__global__ void __launch_bounds__(128) k_b2b(int B, const int32_t *d, int32_t *o) {
  PK_LANE prim_b2b_lane(i, B, d, o);
}
__global__ void __launch_bounds__(128) k_base(int B, const u32 *t, const int32_t *d,
                                              int32_t *o) {
  PK_LANE prim_base_lane(i, B, t, d, o);
}
__global__ void __launch_bounds__(128) k_lad(int B, const int32_t *p, const int32_t *d,
                                             int32_t *o) {
  PK_LANE prim_lad_lane(i, B, p, d, o);
}
__global__ void __launch_bounds__(128) k_dec(int B, const int32_t *e, int32_t *ok,
                                             int32_t *o) {
  PK_LANE prim_dec_lane(i, B, e, ok, o);
}
__global__ void __launch_bounds__(128) k_red(int B, const int32_t *r, int32_t *o,
                                             int32_t *c) {
  PK_LANE prim_red_lane(i, B, r, o, c);
}

typedef const int32_t *CI;
typedef int32_t *OI;

extern "C" int pk_prim_sha(int B, const void *d, void *o, void *stream) {
  k_sha<<<PK_GRID(B)>>>(B, (CI)d, (OI)o);
  return (int)cudaGetLastError();
}
extern "C" int pk_prim_shav(int B, const void *blk, int nb, const void *n, void *o,
                            void *stream) {
  k_shav<<<PK_GRID(B)>>>(B, (CI)blk, nb, (CI)n, (OI)o);
  return (int)cudaGetLastError();
}
extern "C" int pk_prim_b2b(int B, const void *d, void *o, void *stream) {
  k_b2b<<<PK_GRID(B)>>>(B, (CI)d, (OI)o);
  return (int)cudaGetLastError();
}
extern "C" int pk_prim_base(int B, const void *t, const void *d, void *o, void *stream) {
  k_base<<<PK_GRID(B)>>>(B, (const u32 *)t, (CI)d, (OI)o);
  return (int)cudaGetLastError();
}
extern "C" int pk_prim_lad(int B, const void *p, const void *d, void *o, void *stream) {
  k_lad<<<PK_GRID(B)>>>(B, (CI)p, (CI)d, (OI)o);
  return (int)cudaGetLastError();
}
extern "C" int pk_prim_dec(int B, const void *e, void *ok, void *o, void *stream) {
  k_dec<<<PK_GRID(B)>>>(B, (CI)e, (OI)ok, (OI)o);
  return (int)cudaGetLastError();
}
extern "C" int pk_prim_red(int B, const void *r, void *o, void *c, void *stream) {
  k_red<<<PK_GRID(B)>>>(B, (CI)r, (OI)o, (OI)c);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the heaviest body (the w4 ladder) at the
// 128-thread launch above.
extern "C" int pk_primitives_occupancy(int *out) {
  return pk_occupancy((const void *)k_lad, 128, 0, out);
}

// The same kernel's registers, local bytes, static shared bytes and
// max threads a block (obs/resources.py).
extern "C" int pk_primitives_attributes(int *out) {
  return pk_func_attributes((const void *)k_lad, out);
}
