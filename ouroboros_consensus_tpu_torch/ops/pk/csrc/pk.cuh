// Device library of the Praos verifier kernels: GF(2^255-19) in radix
// 2^25.5, edwards25519 points and ladders, SHA-512, Blake2b and mod-L,
// one lane per thread. The plain PyTorch twins (ops/pk/field.py,
// curve.py, hashes.py, verify.py) do the same integer operations in the
// same order, so kernel and twin agree bit for bit.
//
// The same source compiles as host C++ (PK_HOST) so that the lane code
// can be cross-checked against the twins on a machine without nvcc.
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef PK_HOST
#define PK_DEV static inline
#define PK_NOINLINE static
#define PK_LDG(p) (*(p))
#else
#define PK_DEV __device__ __forceinline__
#define PK_NOINLINE __device__ __noinline__
#define PK_LDG(p) __ldg(p)
#endif

#include "consts.cuh"

typedef uint8_t u8;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;

// ---------------------------------------------------------------------------
// Field: 10 limbs, widths 26,25,26,...; loose form limb < 2^W + 2^14
// ---------------------------------------------------------------------------

struct fe { u32 v[10]; };
struct ge { fe x, y, z, t; };

#define FE_W(i) (((i) & 1) ? 25 : 26)
#define FE_M(i) ((((u64)1) << FE_W(i)) - 1)

// bit offset of limb i: 25 i + ceil(i / 2)
#define FE_OFF(i) (25 * (i) + ((i) + 1) / 2)

// parallel carry passes: limb i keeps its low bits plus the carry out of
// limb i-1; limb 0 takes 19 x the carry out of limb 9. A product needs
// two passes back to the loose form, a sum or difference one.
template <int PASSES>
PK_DEV void fe_carry(u64 h[10], fe &o) {
#pragma unroll
  for (int pass = 0; pass < PASSES; pass++) {
    u64 c[10];
#pragma unroll
    for (int i = 0; i < 10; i++) c[i] = h[i] >> FE_W(i);
#pragma unroll
    for (int i = 0; i < 10; i++)
      h[i] = (h[i] & FE_M(i)) + (i == 0 ? 19 * c[9] : c[i - 1]);
  }
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = (u32)h[i];
}

PK_DEV fe fe_const(const u32 *c) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = c[i];
  return r;
}

PK_DEV fe fe_zero() { fe r; for (int i = 0; i < 10; i++) r.v[i] = 0; return r; }
PK_DEV fe fe_one() { fe r = fe_zero(); r.v[0] = 1; return r; }

PK_DEV fe fe_add(const fe &a, const fe &b) {
  u64 h[10]; fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (u64)a.v[i] + b.v[i];
  fe_carry<1>(h, r);
  return r;
}

PK_DEV fe fe_sub(const fe &a, const fe &b) {
  u64 h[10]; fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (u64)a.v[i] + PK_TWO_P[i] - b.v[i];
  fe_carry<1>(h, r);
  return r;
}

PK_DEV fe fe_neg(const fe &a) {
  u64 h[10]; fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = (u64)PK_TWO_P[i] - a.v[i];
  fe_carry<1>(h, r);
  return r;
}

PK_DEV fe fe_mul(const fe &f, const fe &g) {
  // term (i, j) lands in limb (i+j) mod 10, doubled when both limbs are
  // odd and times 19 when it wraps past 2^255: 100 32x32->64 products
  u32 g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  u64 h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      u32 a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      u32 b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (u64)a * b;
    }
  }
  fe r;
  fe_carry<2>(h, r);
  return r;
}

// ref10's squaring: term (i, j) and term (j, i) of fe_mul(f, f) carry the
// same factors, so each cross term i < j is formed once and doubled —
// 10 squares and 45 cross terms, 55 32x32->64 products. Every column sum
// h[k] is the same integer as fe_mul(f, f)'s and the carry passes are the
// same, so the output equals fe_mul(f, f) limb for limb. The stages still
// square with fe_sqr = fe_mul(a, a); tools/fe_bench.py times the two.
PK_DEV fe fe_sq(const fe &f) {
  u32 f2[10], f19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f19[i] = 19 * f.v[i];
  }
  u64 h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      bool odd = (i & 1) && (j & 1);
      u32 a = (i == j) ? (odd ? f2[i] : f.v[i]) : (odd ? 2 * f2[i] : f2[i]);
      u32 b = (i + j >= 10) ? f19[j] : f.v[j];
      h[(i + j) % 10] += (u64)a * b;
    }
  }
  fe r;
  fe_carry<2>(h, r);
  return r;
}

PK_DEV fe fe_sqr(const fe &a) { return fe_mul(a, a); }

PK_NOINLINE fe fe_pow2k(fe a, int k) {
#pragma unroll 1
  for (int i = 0; i < k; i++) a = fe_sqr(a);
  return a;
}

PK_DEV void fe_chain_2_250m1(const fe &x, fe &g, fe &x11) {
  fe t0 = fe_sqr(x);
  fe t1 = fe_mul(x, fe_pow2k(t0, 2));
  x11 = fe_mul(t0, t1);
  fe t31 = fe_mul(t1, fe_sqr(x11));
  fe a = fe_mul(fe_pow2k(t31, 5), t31);
  fe b = fe_mul(fe_pow2k(a, 10), a);
  fe c = fe_mul(fe_pow2k(b, 20), b);
  fe d = fe_mul(fe_pow2k(c, 10), a);
  fe e = fe_mul(fe_pow2k(d, 50), d);
  fe f = fe_mul(fe_pow2k(e, 100), e);
  g = fe_mul(fe_pow2k(f, 50), d);
}

PK_NOINLINE fe fe_inv(fe x) {
  fe g, x11;
  fe_chain_2_250m1(x, g, x11);
  return fe_mul(fe_pow2k(g, 5), x11);
}

PK_NOINLINE fe fe_pow22523(fe x) {
  fe g, x11;
  fe_chain_2_250m1(x, g, x11);
  return fe_mul(fe_pow2k(g, 2), x);
}

// sequential carry over in-width limbs; returns the carry out of limb 9
PK_DEV u64 fe_seq(u64 h[10]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    if (i > 0) h[i] += c;
    c = h[i] >> FE_W(i);
    h[i] &= FE_M(i);
  }
  return c;
}

PK_NOINLINE fe fe_freeze(fe a) {
  u64 h[10], t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i];
#pragma unroll
  for (int r = 0; r < 2; r++) {
    u64 c = fe_seq(h);
    h[0] += 19 * c;
  }
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = h[i];
  t[0] += 19;
  u64 c = fe_seq(t);
  fe o;
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = (u32)(c == 1 ? t[i] : h[i]);
  return o;
}

PK_DEV bool fe_eq(const fe &a, const fe &b) {
  fe x = fe_freeze(a), y = fe_freeze(b);
  bool r = true;
#pragma unroll
  for (int i = 0; i < 10; i++) r = r && (x.v[i] == y.v[i]);
  return r;
}

PK_DEV bool fe_is_zero(const fe &a) {
  fe x = fe_freeze(a);
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= x.v[i];
  return acc == 0;
}

PK_DEV u32 fe_parity(const fe &a) { return fe_freeze(a).v[0] & 1; }

PK_DEV fe fe_sel(bool c, const fe &a, const fe &b) { return c ? a : b; }

// in-width limbs (value < 2^255): value >= p
PK_DEV bool fe_geq_p(const fe &a) {
  u64 t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = a.v[i];
  t[0] += 19;
  return fe_seq(t) == 1;
}

// 32 little-endian bytes (bit 255 ignored) -> in-width limbs
PK_DEV fe fe_from_bytes(const u8 *b) {
  u64 w[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    u64 x = 0;
#pragma unroll
    for (int j = 7; j >= 0; j--) x = (x << 8) | b[8 * k + j];
    w[k] = x;
  }
  w[3] &= 0x7FFFFFFFFFFFFFFFull;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int off = FE_OFF(i), q = off >> 6, s = off & 63;
    u64 v = w[q] >> s;
    if (s + FE_W(i) > 64 && q < 3) v |= w[q + 1] << (64 - s);
    r.v[i] = (u32)(v & FE_M(i));
  }
  return r;
}

PK_DEV void fe_to_bytes(u8 *out, const fe &a) {
  fe h = fe_freeze(a);
  u64 w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    int off = FE_OFF(i), q = off >> 6, s = off & 63;
    w[q] |= (u64)h.v[i] << s;
    if (s + FE_W(i) > 64) w[q + 1] |= (u64)h.v[i] >> (64 - s);
  }
#pragma unroll
  for (int k = 0; k < 32; k++) out[k] = (u8)(w[k >> 3] >> (8 * (k & 7)));
}

PK_DEV void fe_sqrt_ratio_ext(const fe &n, const fe &d, fe &rho, bool &good,
                              bool &good_alt, bool &is_pi) {
  fe d2 = fe_sqr(d);
  fe d3 = fe_mul(d, d2);
  fe d7 = fe_mul(d3, fe_sqr(d2));
  rho = fe_mul(fe_mul(n, d3), fe_pow22523(fe_mul(n, d7)));
  fe check = fe_mul(d, fe_sqr(rho));
  good = fe_eq(check, n);
  good_alt = fe_eq(check, fe_neg(n));
  is_pi = fe_eq(check, fe_mul(fe_const(PK_SQRT_M1), n));
}

PK_DEV bool fe_sqrt_ratio(const fe &n, const fe &d, fe &r) {
  fe rho; bool good, good_alt, is_pi;
  fe_sqrt_ratio_ext(n, d, rho, good, good_alt, is_pi);
  r = fe_sel(good, rho, fe_mul(rho, fe_const(PK_SQRT_M1)));
  r = fe_sel(fe_parity(r) == 1, fe_neg(r), r);
  return good || good_alt;
}

// ---------------------------------------------------------------------------
// Points (extended coordinates, unified addition law)
// ---------------------------------------------------------------------------

PK_DEV ge ge_identity() {
  ge p; p.x = fe_zero(); p.y = fe_one(); p.z = fe_one(); p.t = fe_zero();
  return p;
}

PK_NOINLINE ge ge_add(ge p, ge q) {
  fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  fe c = fe_mul(fe_mul(p.t, q.t), fe_const(PK_D2));
  fe zz = fe_mul(p.z, q.z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g); r.t = fe_mul(e, h);
  return r;
}

PK_NOINLINE ge ge_dbl(ge p) {
  fe a = fe_sqr(p.x);
  fe b = fe_sqr(p.y);
  fe zz = fe_sqr(p.z);
  fe c = fe_add(zz, zz);
  fe h = fe_add(a, b);
  fe e = fe_sub(h, fe_sqr(fe_add(p.x, p.y)));
  fe g = fe_sub(a, b);
  fe f = fe_add(c, g);
  ge r;
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g); r.t = fe_mul(e, h);
  return r;
}

PK_DEV ge ge_neg(const ge &p) {
  ge r = p; r.x = fe_neg(p.x); r.t = fe_neg(p.t);
  return r;
}

PK_DEV ge ge_mul_cofactor(ge p) { return ge_dbl(ge_dbl(ge_dbl(p))); }

// [32] little-endian bytes -> ok; RFC 8032 decoding rules
PK_NOINLINE bool ge_decompress(ge &out, const u8 *b) {
  u32 sign = b[31] >> 7;
  fe y = fe_from_bytes(b);
  bool y_ok = !fe_geq_p(y);
  fe one = fe_one();
  fe y2 = fe_sqr(y);
  fe num = fe_sub(y2, one);
  fe den = fe_add(fe_mul(y2, fe_const(PK_D)), one);
  fe x;
  bool ok_sqrt = fe_sqrt_ratio(num, den, x);
  bool x_zero = fe_is_zero(x);
  if (sign == 1 && !x_zero) x = fe_neg(x);
  out.x = x; out.y = y; out.z = one; out.t = fe_mul(x, y);
  return y_ok && ok_sqrt && !(x_zero && sign == 1);
}

// compress k points with ONE inversion (Montgomery's trick)
PK_NOINLINE void ge_compress_many(const ge *pts, int k, u8 *out) {
  fe prefix[8];
  prefix[0] = pts[0].z;
  for (int i = 1; i < k; i++) prefix[i] = fe_mul(prefix[i - 1], pts[i].z);
  fe acc = fe_inv(prefix[k - 1]);
  fe invs[8];
  for (int i = k - 1; i > 0; i--) {
    invs[i] = fe_mul(acc, prefix[i - 1]);
    acc = fe_mul(acc, pts[i].z);
  }
  invs[0] = acc;
  for (int i = 0; i < k; i++) {
    u8 xb[32];
    fe_to_bytes(xb, fe_mul(pts[i].x, invs[i]));
    fe_to_bytes(out + 32 * i, fe_mul(pts[i].y, invs[i]));
    out[32 * i + 31] |= (u8)((xb[0] & 1) << 7);
  }
}

PK_NOINLINE void ge_table16(ge *tbl, ge p) {
  tbl[0] = ge_identity();
  tbl[1] = p;
#pragma unroll 1
  for (int i = 2; i < 16; i++) tbl[i] = ge_add(tbl[i - 1], p);
}

// sum d_i 16^(k-1-i) · P, digits most significant first
PK_NOINLINE ge ge_scalar_mul_w4(const u8 *digits, int k, ge p) {
  ge tbl[16];
  ge_table16(tbl, p);
  ge q = ge_identity();
#pragma unroll 1
  for (int i = 0; i < k; i++) {
#pragma unroll 1
    for (int j = 0; j < 4; j++) q = ge_dbl(q);
    q = ge_add(q, tbl[digits[i]]);
  }
  return q;
}

// a·PA + b·PB on one doubling chain (ka >= kb)
PK_NOINLINE ge ge_double_scalar_mul_w4(const u8 *da, int ka, ge pa,
                                       const u8 *db, int kb, ge pb) {
  ge ta[16], tb[16];
  ge_table16(ta, pa);
  ge_table16(tb, pb);
  ge q = ge_identity();
#pragma unroll 1
  for (int i = 0; i < ka; i++) {
#pragma unroll 1
    for (int j = 0; j < 4; j++) q = ge_dbl(q);
    q = ge_add(q, ta[da[i]]);
    int jb = i - (ka - kb);
    if (jb >= 0) q = ge_add(q, tb[db[jb]]);
  }
  return q;
}

// s·B from 32 little-endian scalar bytes; table [32][256][40] limbs
PK_NOINLINE ge ge_base_mul_w8(const u32 *table, const u8 *s) {
  ge q = ge_identity();
#pragma unroll 1
  for (int w = 0; w < 32; w++) {
    const u32 *e = table + ((size_t)w * 256 + s[w]) * 40;
    ge p;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      p.x.v[i] = PK_LDG(e + i);
      p.y.v[i] = PK_LDG(e + 10 + i);
      p.z.v[i] = PK_LDG(e + 20 + i);
      p.t.v[i] = PK_LDG(e + 30 + i);
    }
    q = ge_add(q, p);
  }
  return q;
}

// ---------------------------------------------------------------------------
// SHA-512 and Blake2b
// ---------------------------------------------------------------------------

PK_DEV u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

PK_NOINLINE void sha512_compress(u64 st[8], const u8 *blk) {
  u64 w[80];
#pragma unroll 1
  for (int t = 0; t < 16; t++) {
    u64 x = 0;
    for (int j = 0; j < 8; j++) x = (x << 8) | blk[8 * t + j];
    w[t] = x;
  }
#pragma unroll 1
  for (int t = 16; t < 80; t++) {
    u64 s0 = rotr64(w[t - 15], 1) ^ rotr64(w[t - 15], 8) ^ (w[t - 15] >> 7);
    u64 s1 = rotr64(w[t - 2], 19) ^ rotr64(w[t - 2], 61) ^ (w[t - 2] >> 6);
    w[t] = s1 + w[t - 7] + s0 + w[t - 16];
  }
  u64 a = st[0], b = st[1], c = st[2], d = st[3];
  u64 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 1
  for (int t = 0; t < 80; t++) {
    u64 s1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    u64 ch = (e & f) ^ (~e & g);
    u64 t1 = h + s1 + ch + PK_SHA512_K[t] + w[t];
    u64 s0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    u64 maj = (a & b) ^ (a & c) ^ (b & c);
    u64 t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

PK_DEV void sha512_init(u64 st[8]) {
  for (int i = 0; i < 8; i++) st[i] = PK_SHA512_H0[i];
}

PK_DEV void sha512_digest(const u64 st[8], u8 *out) {
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (u8)(st[i] >> (56 - 8 * j));
}

// SHA-512 of a short local message (n <= 239 bytes: at most 2 blocks)
PK_NOINLINE void sha512_msg(const u8 *msg, int n, u8 *out) {
  u8 buf[256];
  int nb = (n + 17 + 127) / 128;
  for (int i = 0; i < nb * 128; i++) buf[i] = i < n ? msg[i] : 0;
  buf[n] = 0x80;
  u64 bits = (u64)n * 8;
  for (int j = 0; j < 8; j++) buf[nb * 128 - 1 - j] = (u8)(bits >> (8 * j));
  u64 st[8];
  sha512_init(st);
  for (int i = 0; i < nb; i++) sha512_compress(st, buf + 128 * i);
  sha512_digest(st, out);
}

// SHA-512 over pre-padded column blocks [nb][128][B] of lane `lane`,
// predicated per lane on its own block count (block 0 always applies)
PK_NOINLINE void sha512_columns(const int32_t *blocks, int nb, int nblocks,
                                int lane, int B, u8 *out) {
  u64 st[8];
  sha512_init(st);
  u8 blk[128];
#pragma unroll 1
  for (int i = 0; i < nb; i++) {
    if (i > 0 && i >= nblocks) break;
    for (int k = 0; k < 128; k++)
      blk[k] = (u8)blocks[((size_t)i * 128 + k) * B + lane];
    sha512_compress(st, blk);
  }
  sha512_digest(st, out);
}

PK_DEV void b2b_g(u64 *v, int a, int b, int c, int d, u64 x, u64 y) {
  v[a] = v[a] + v[b] + x; v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];     v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y; v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];     v[b] = rotr64(v[b] ^ v[c], 63);
}

// unkeyed single-block Blake2b-256 of n <= 128 local bytes
PK_NOINLINE void blake2b_256(const u8 *msg, int n, u8 *out) {
  u64 m[16];
  for (int t = 0; t < 16; t++) {
    u64 x = 0;
    for (int j = 7; j >= 0; j--) {
      int k = 8 * t + j;
      x = (x << 8) | (k < n ? msg[k] : 0);
    }
    m[t] = x;
  }
  u64 h[8], v[16];
  for (int i = 0; i < 8; i++) h[i] = PK_SHA512_H0[i];
  h[0] ^= 0x01010000ull ^ 32;
  for (int i = 0; i < 8; i++) { v[i] = h[i]; v[i + 8] = PK_SHA512_H0[i]; }
  v[12] ^= (u64)n;
  v[14] = ~v[14];
#pragma unroll 1
  for (int r = 0; r < 12; r++) {
    const int q = r % 10;
#define PK_S(k) m[PK_B2B_SIGMA[q][k]]
    b2b_g(v, 0, 4, 8, 12, PK_S(0), PK_S(1));
    b2b_g(v, 1, 5, 9, 13, PK_S(2), PK_S(3));
    b2b_g(v, 2, 6, 10, 14, PK_S(4), PK_S(5));
    b2b_g(v, 3, 7, 11, 15, PK_S(6), PK_S(7));
    b2b_g(v, 0, 5, 10, 15, PK_S(8), PK_S(9));
    b2b_g(v, 1, 6, 11, 12, PK_S(10), PK_S(11));
    b2b_g(v, 2, 7, 8, 13, PK_S(12), PK_S(13));
    b2b_g(v, 3, 4, 9, 14, PK_S(14), PK_S(15));
#undef PK_S
  }
  for (int i = 0; i < 4; i++) {
    u64 x = h[i] ^ v[i] ^ v[i + 8];
    for (int j = 0; j < 8; j++) out[8 * i + j] = (u8)(x >> (8 * j));
  }
}

// ---------------------------------------------------------------------------
// Scalars mod L (bytes)
// ---------------------------------------------------------------------------

// 64 little-endian bytes -> 32 bytes of the value mod L (TweetNaCl modL)
PK_NOINLINE void sc_reduce512(const u8 *in, u8 *out) {
  i64 x[64];
  for (int i = 0; i < 64; i++) x[i] = in[i];
#pragma unroll 1
  for (int i = 63; i >= 32; --i) {
    i64 carry = 0;
    int j;
    for (j = i - 32; j < i - 12; ++j) {
      x[j] += carry - 16 * x[i] * (i64)PK_L_BYTES[j - (i - 32)];
      carry = (x[j] + 128) >> 8;
      x[j] -= carry * 256;
    }
    x[j] += carry;
    x[i] = 0;
  }
  i64 carry = 0;
  i64 top = x[31] >> 4;
  for (int j = 0; j < 32; j++) {
    x[j] += carry - top * (i64)PK_L_BYTES[j];
    carry = x[j] >> 8;
    x[j] &= 255;
  }
  for (int j = 0; j < 32; j++) x[j] -= carry * (i64)PK_L_BYTES[j];
  for (int i = 0; i < 32; i++) {
    if (i + 1 < 32) x[i + 1] += x[i] >> 8;
    out[i] = (u8)(x[i] & 255);
  }
}

// s < L for 32 little-endian bytes
PK_DEV bool sc_lt_l(const u8 *s) {
  bool lt = false, gt = false;
  for (int i = 31; i >= 0; i--) {
    lt = lt || (!gt && s[i] < PK_L_BYTES[i]);
    gt = gt || (!lt && s[i] > PK_L_BYTES[i]);
  }
  return lt;
}

// n little-endian bytes -> 2n base-16 digits, most significant first
PK_DEV void nibbles_msb(const u8 *b, int n, u8 *d) {
  for (int k = n - 1, o = 0; k >= 0; k--, o += 2) {
    d[o] = b[k] >> 4;
    d[o + 1] = b[k] & 0xF;
  }
}

// big-endian lexicographic a < b over 32 bytes
PK_DEV bool lt_be32(const u8 *a, const u8 *b) {
  bool lt = false, gt = false;
  for (int i = 0; i < 32; i++) {
    lt = lt || (!gt && a[i] < b[i]);
    gt = gt || (!lt && a[i] > b[i]);
  }
  return lt;
}
