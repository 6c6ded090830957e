// Per-lane bodies of the two tool kernels, one lane per thread, over
// limb-first int32 columns [rows][B] like the stages:
//
//   primitives.cu — the primitive bisection harness
//                   (tools/debug_pk.py): one body per device primitive
//                   the stages are built from;
//   fe_bench.cu   — the field-op microbenchmark (tools/fe_bench.py).
#pragma once
#include "stages.cuh"

// SHA-512 of 66 bytes: data [66, B] -> digest [64, B]
PK_DEV void prim_sha_lane(int i, int B, const int32_t *data, int32_t *out) {
  u8 dg[64];
  sha512_msg<66>([&](int k) -> u8 { return (u8)data[(size_t)k * B + i]; }, dg);
  store_bytes(out, 64, i, B, dg);
}

// SHA-512 over pre-padded blocks [nb, 128, B] with a per-lane block count
PK_DEV void prim_shav_lane(int i, int B, const int32_t *blocks, int nb,
                           const int32_t *nblocks, int32_t *out) {
  u8 dg[64];
  sha512_columns(blocks, nb, nblocks[i], i, B, dg);
  store_bytes(out, 64, i, B, dg);
}

// Blake2b-256 of 64 bytes: data [64, B] -> digest [32, B]
PK_DEV void prim_b2b_lane(int i, int B, const int32_t *data, int32_t *out) {
  u8 buf[64], dg[32];
  load_bytes(data, 64, i, B, buf);
  blake2b_256(buf, 64, dg);
  store_bytes(out, 32, i, B, dg);
}

// s·B from 32 little-endian byte digits [32, B] -> point [40, B]
PK_DEV void prim_base_lane(int i, int B, const u32 *base8,
                           const int32_t *digits, int32_t *out) {
  u8 s[32];
  load_bytes(digits, 32, i, B, s);
  store_point(out, i, B, ge_base_mul_w8(base8, s));
}

// k·P from 64 base-16 digits, most significant first [64, B], and a point
// [40, B] -> point [40, B]
PK_DEV void prim_lad_lane(int i, int B, const int32_t *pt,
                          const int32_t *digits, int32_t *out) {
  u8 d[64];
  load_bytes(digits, 64, i, B, d);
  LocalTab tab;
  ge_table8(tab, load_point(pt, i, B));
  store_point(out, i, B, ge_scalar_mul_w4(d, 64, tab));
}

// decompress, then compress: enc [32, B] -> ok [1, B], enc' [32, B]
PK_DEV void prim_dec_lane(int i, int B, const int32_t *enc, int32_t *ok,
                          int32_t *out) {
  u8 e[32], o[32];
  load_bytes(enc, 32, i, B, e);
  ge p;
  ok[i] = ge_decompress(p, e) ? 1 : 0;
  ge_compress_many(&p, 1, o);
  store_bytes(out, 32, i, B, o);
}

// 64 bytes mod L -> [32, B], and whether the low 32 bytes are a
// canonical scalar (< L) -> [1, B]
PK_DEV void prim_red_lane(int i, int B, const int32_t *raw, int32_t *out,
                          int32_t *canon) {
  u8 x[64], r[32];
  load_bytes(raw, 64, i, B, x);
  sc_reduce512(x, r);
  store_bytes(out, 32, i, B, r);
  canon[i] = sc_lt_l(x) ? 1 : 0;
}

// Field-op microbenchmark: FE_BENCH_CHAINS independent chains of k
// operations on w (starting at v_c = x + c), OP 0: w = fe_mul(w, v_c),
// OP 1: w = fe_mul(w, w), OP 2: w = fe_sq(w); the chains are summed into
// one output [10, B] so that none of them is dead code.
#define FE_BENCH_CHAINS 4

template <int OP>
PK_DEV void fe_bench_lane(int i, int B, int k, const int32_t *x,
                          int32_t *out) {
  fe v[FE_BENCH_CHAINS], w[FE_BENCH_CHAINS];
#pragma unroll
  for (int c = 0; c < FE_BENCH_CHAINS; c++) {
#pragma unroll
    for (int l = 0; l < 10; l++) v[c].v[l] = (u32)x[(size_t)l * B + i];
    v[c].v[0] += c;
    w[c] = v[c];
  }
#pragma unroll 1
  for (int t = 0; t < k; t++) {
#pragma unroll
    for (int c = 0; c < FE_BENCH_CHAINS; c++)
      w[c] = OP == 0 ? fe_mul(w[c], v[c]) : OP == 1 ? fe_mul(w[c], w[c]) : fe_sq(w[c]);
  }
  fe acc = w[0];
#pragma unroll
  for (int c = 1; c < FE_BENCH_CHAINS; c++) acc = fe_add(acc, w[c]);
#pragma unroll
  for (int l = 0; l < 10; l++) out[(size_t)l * B + i] = (int32_t)acc.v[l];
}
