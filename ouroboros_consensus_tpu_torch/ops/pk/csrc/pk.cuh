// Device library of the Praos verifier kernels: GF(2^255-19) in radix
// 2^25.5, edwards25519 points and ladders, SHA-512, Blake2b and mod-L.
// The plain PyTorch twins (ops/pk/field.py, curve.py, hashes.py,
// verify.py) do the same integer operations in the same order, so kernel
// and twin agree bit for bit.
//
// What bounds the stages on Hopper is the dependent chain of one lane's
// field products (a 256-doubling ladder), so the point code spends as few
// products as that chain allows: squarings are ref10's fe_sq (55 wide
// products, not 100), a doubling followed by another doubling skips T,
// w4 ladders use signed digits in [-8, 8) over 8-entry tables of points
// in cached form (Y+X, Y-X, 2dT, 2Z: 8 products an addition, 7 without
// T), and the point operations are inlined into the (non-inlined) table
// and ladder functions, so that a digit loop keeps its points in
// registers and each ladder is compiled once per source. Tables are a template parameter: per thread
// in local memory (LocalTab) or lane-minor in shared memory (LaneTab, a
// warp's 32 lookups of 32 different digits hit 32 banks).
//
// Not used, and why: tensor cores (IMMA multiplies int8 pieces into
// int32; a 25.5-bit limb product would take ~16 of them plus carries,
// where one IMAD.WIDE does it) and TMA (each lane's inputs are a few
// hundred bytes of coalesced limb-first columns; the 1.3 MB fixed-base
// table is read by random gathers, which stay in L2 behind __ldg).
//
// The same source compiles as host C++ (PK_HOST) so that the lane code
// can be cross-checked against the twins on a machine without nvcc.
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef PK_HOST
#define PK_DEV static inline
#define PK_MEMBER inline
#define PK_NOINLINE static
#define PK_LDG(p) (*(p))
#else
#define PK_DEV __device__ __forceinline__
#define PK_MEMBER __device__ __forceinline__
#define PK_NOINLINE __device__ __noinline__
#define PK_LDG(p) __ldg(p)
#endif

#include "consts.cuh"

#ifndef PK_HOST
// A kernel's own figures from the runtime (cudaFuncGetAttributes): out[0]
// registers a thread, out[1] local bytes a thread, out[2] static shared
// bytes, out[3] the most threads a block. Each source's
// pk_<name>_attributes entry calls it on the kernel its occupancy entry
// reads. Returns the cudaError.
static inline int pk_func_attributes(const void *kernel, int *out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

// A kernel's resident blocks an SM at a launch geometry, from the CUDA
// occupancy API: out[0] the blocks, out[1] the threads a block and out[2]
// the dynamic shared bytes a block it was asked at (chip_smoke.py holds
// out[0] to its own count from ptxas's figures and out[1], out[2]). Each
// source's pk_<name>_occupancy entry calls it at its wrapper's launch.
// Returns the cudaError.
static inline int pk_occupancy(const void *kernel, int threads, size_t smem, int *out) {
  out[1] = threads;
  out[2] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, smem);
}
#endif

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

// one carry pass on 32-bit words: a sum or a difference of loose limbs
// (each < 2^27) stays under 2^29, so this is fe_carry<1>'s pass on 64-bit
// words bit for bit, with one add, shift and mask a limb where 64-bit
// words take two of each
PK_DEV void fe_carry32(const u32 h[10], fe &o) {
  u32 c[10];
#pragma unroll
  for (int i = 0; i < 10; i++) c[i] = h[i] >> FE_W(i);
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = (h[i] & (u32)FE_M(i)) + (i == 0 ? 19 * c[9] : c[i - 1]);
}

PK_DEV fe fe_add(const fe &a, const fe &b) {
  u32 h[10]; fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i] + b.v[i];
  fe_carry32(h, r);
  return r;
}

PK_DEV fe fe_sub(const fe &a, const fe &b) {
  u32 h[10]; fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i] + PK_TWO_P[i] - b.v[i];
  fe_carry32(h, r);
  return r;
}

PK_DEV fe fe_neg(const fe &a) {
  u32 h[10]; fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = PK_TWO_P[i] - a.v[i];
  fe_carry32(h, r);
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
// same, so the output equals fe_mul(f, f) limb for limb: every squaring
// of the stages is this one (tools/fe_bench.py times the two).
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

PK_NOINLINE fe fe_pow2k(fe a, int k) {
#pragma unroll 1
  for (int i = 0; i < k; i++) a = fe_sq(a);
  return a;
}

PK_DEV void fe_chain_2_250m1(const fe &x, fe &g, fe &x11) {
  fe t0 = fe_sq(x);
  fe t1 = fe_mul(x, fe_pow2k(t0, 2));
  x11 = fe_mul(t0, t1);
  fe t31 = fe_mul(t1, fe_sq(x11));
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
  fe d2 = fe_sq(d);
  fe d3 = fe_mul(d, d2);
  fe d7 = fe_mul(d3, fe_sq(d2));
  rho = fe_mul(fe_mul(n, d3), fe_pow22523(fe_mul(n, d7)));
  fe check = fe_mul(d, fe_sq(rho));
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

// P + Q, both extended: 9 products
PK_DEV ge ge_add(const ge &p, const ge &q) {
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

// r = 2P: 4 squarings and 3 products, and T's product only when the next
// operation reads T (an addition, or the result); a doubling reads X, Y,
// Z alone. r may be p.
PK_DEV void ge_dbl(ge &r, const ge &p, bool with_t) {
  fe a = fe_sq(p.x);
  fe b = fe_sq(p.y);
  fe zz = fe_sq(p.z);
  fe c = fe_add(zz, zz);
  fe h = fe_add(a, b);
  fe e = fe_sub(h, fe_sq(fe_add(p.x, p.y)));
  fe g = fe_sub(a, b);
  fe f = fe_add(c, g);
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g);
  if (with_t) r.t = fe_mul(e, h);
}

// four doublings, T on the last (a w4 digit step)
PK_DEV void ge_dbl4(ge &q) {
#pragma unroll 1
  for (int j = 0; j < 4; j++) ge_dbl(q, q, j == 3);
}

PK_DEV ge ge_neg(const ge &p) {
  ge r = p; r.x = fe_neg(p.x); r.t = fe_neg(p.t);
  return r;
}

// 8·P as a loop over one doubling: one copy of its code, its
// temporaries live one doubling at a time
PK_NOINLINE ge ge_mul_cofactor(ge p) {
#pragma unroll 1
  for (int k = 0; k < 3; k++) ge_dbl(p, p, k == 2);
  return p;
}

// A point in cached form for additions: (Y+X, Y-X, 2d·T, 2Z).
struct gec { fe ypx, ymx, t2d, z2; };

PK_DEV gec ge_cache(const ge &p) {
  gec c;
  c.ypx = fe_add(p.y, p.x);
  c.ymx = fe_sub(p.y, p.x);
  c.t2d = fe_mul(p.t, fe_const(PK_D2));
  c.z2 = fe_add(p.z, p.z);
  return c;
}

// r = P + Q for Q cached: 8 products, 7 without T. r may be p.
PK_DEV void ge_add_cached(ge &r, const ge &p, const gec &q, bool with_t) {
  fe a = fe_mul(fe_sub(p.y, p.x), q.ymx);
  fe b = fe_mul(fe_add(p.y, p.x), q.ypx);
  fe c = fe_mul(p.t, q.t2d);
  fe d = fe_mul(p.z, q.z2);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g);
  if (with_t) r.t = fe_mul(e, h);
}

// [32] little-endian bytes -> ok; RFC 8032 decoding rules
PK_NOINLINE bool ge_decompress(ge &out, const u8 *b) {
  u32 sign = b[31] >> 7;
  fe y = fe_from_bytes(b);
  bool y_ok = !fe_geq_p(y);
  fe one = fe_one();
  fe y2 = fe_sq(y);
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

// ---------------------------------------------------------------------------
// w4 ladders: signed digits over 8-entry cached tables
// ---------------------------------------------------------------------------

// k base-16 digits (0..15, most significant first) -> k + 1 signed digits
// in [-8, 8), most significant first, the first 0 or 1: the nibbles of
// a + 0x88...8 less 8, and its carry out
PK_DEV void recode_signed(const u8 *d, int k, int8_t *e) {
  int carry = 0;
  for (int i = k - 1; i >= 0; i--) {
    int m = d[i] + 8 + carry;
    carry = m >> 4;
    e[i + 1] = (int8_t)((m & 15) - 8);
  }
  e[0] = (int8_t)carry;
}

// The table of P: entry j = (j + 1)·P in cached form, j < 8. Per thread
// in local memory:
struct LocalTab {
  gec e[8];
  PK_MEMBER gec get(int j) const { return e[j]; }
  PK_MEMBER void put(int j, const gec &v) { e[j] = v; }
};

// or for the 32 lanes of a warp in shared memory, lane-minor: limb l of
// coordinate c of entry j of `lane` at w[((40 j + 10 c + l) << 5) + lane].
#define PK_LANETAB_WORDS (8 * 40 * 32)
struct LaneTab {
  u32 *w;
  int lane;
  PK_MEMBER u32 &at(int j, int c, int l) const { return w[((40 * j + 10 * c + l) << 5) + lane]; }
  PK_MEMBER gec get(int j) const {
    gec q;
#pragma unroll
    for (int l = 0; l < 10; l++) {
      q.ypx.v[l] = at(j, 0, l); q.ymx.v[l] = at(j, 1, l);
      q.t2d.v[l] = at(j, 2, l); q.z2.v[l] = at(j, 3, l);
    }
    return q;
  }
  PK_MEMBER void put(int j, const gec &q) const {
#pragma unroll
    for (int l = 0; l < 10; l++) {
      at(j, 0, l) = q.ypx.v[l]; at(j, 1, l) = q.ymx.v[l];
      at(j, 2, l) = q.t2d.v[l]; at(j, 3, l) = q.z2.v[l];
    }
  }
};

// 1P..8P by 7 cached additions
template <class Tab>
PK_NOINLINE void ge_table8(Tab &tab, const ge &p) {
  gec p1 = ge_cache(p);
  tab.put(0, p1);
  ge acc = p;
#pragma unroll 1
  for (int j = 1; j < 8; j++) {
    ge_add_cached(acc, acc, p1, true);
    tab.put(j, ge_cache(acc));
  }
}

// the cached point of signed digit e, |e| <= 8: the identity for 0, and
// for e < 0 the negation, which swaps Y+X and Y-X and negates 2dT
template <class Tab>
PK_DEV gec tab_select(const Tab &tab, int e) {
  int m = e < 0 ? -e : e;
  gec q = tab.get(m == 0 ? 0 : m - 1);
  if (m == 0) {
    q.ypx = fe_one(); q.ymx = fe_one(); q.t2d = fe_zero();
    q.z2 = fe_zero(); q.z2.v[0] = 2;
  }
  fe nt = fe_neg(q.t2d);
  gec r;
  r.ypx = e < 0 ? q.ymx : q.ypx;
  r.ymx = e < 0 ? q.ypx : q.ymx;
  r.t2d = e < 0 ? nt : q.t2d;
  r.z2 = q.z2;
  return r;
}

// a·P for k base-16 digits of a (most significant first, k <= 64) over
// the table of P: k + 1 signed digits, 4k doublings, k + 1 additions
template <class Tab>
PK_NOINLINE ge ge_scalar_mul_w4(const u8 *digits, int k, const Tab &tab) {
  int8_t e[65];
  recode_signed(digits, k, e);
  ge q = ge_identity();
  ge_add_cached(q, q, tab_select(tab, e[0]), false);
#pragma unroll 1
  for (int i = 1; i <= k; i++) {
    ge_dbl4(q);
    ge_add_cached(q, q, tab_select(tab, e[i]), i == k);
  }
  return q;
}

// ---------------------------------------------------------------------------
// Point operations over four warps (a quad)
// ---------------------------------------------------------------------------
//
// A lane's dependent chain of point operations is what bounds a one-block
// launch, and the four products of each step of a doubling or an addition
// are independent. So a quad is four warps of one block over the same 32
// lanes: in each step warp w computes product w of every lane, and the
// four products meet in a double-buffered exchange area in shared memory
// at one named barrier. The cheap sums between the steps run on all four
// warps. Every product is the same integer operation, on the same
// operands, as in the one-thread code above, so the results are equal
// limb for limb (T formed where the one-thread code forms it: a doubling
// followed by a doubling skips it, and a skipped T is never read). A warp
// keeps its own product in registers and reads the other three. The host
// build runs the four products of a step one after another.

#define PK_QUAD_WORDS (2 * 4 * 10 * 32)

struct Quad {
  u32 *x;    // exchange area of PK_QUAD_WORDS words
  int w;     // this warp's product, 0..3; -1 on the host (all four)
  int lane;
  int bar;   // named barrier of the quad's 128 threads
  int buf;   // the exchange buffer of the next step
};

// out[k] = f(k) for k < 4: this warp's product, then the other three
template <class F>
PK_DEV void quad_step(Quad &qd, fe out[4], F f) {
#ifdef PK_HOST
  for (int k = 0; k < 4; k++) out[k] = f(k);
#else
  fe mine = f(qd.w);
  u32 *x = qd.x + qd.buf * (4 * 10 * 32);
#pragma unroll
  for (int l = 0; l < 10; l++) x[((qd.w * 10 + l) << 5) + qd.lane] = mine.v[l];
  asm volatile("bar.sync %0, 128;" ::"r"(qd.bar) : "memory");
#pragma unroll
  for (int k = 0; k < 4; k++) {
    if (k == qd.w) {  // this warp's own product stays in registers
      out[k] = mine;
      continue;
    }
#pragma unroll
    for (int l = 0; l < 10; l++) out[k].v[l] = x[((k * 10 + l) << 5) + qd.lane];
  }
#endif
  qd.buf ^= 1;
}

// A team of one exchange buffer: a pair (two warps of a block over the
// same 32 lanes, each warp two of a step's four products, k = 2w, 2w + 1:
// two independent products in flight a thread) or a quad of one buffer
// (as Quad), exchanged at a named barrier of the team's threads, with a
// second barrier after the reads (so the next step's writes wait for
// them): half the exchange memory of a double-buffered quad. Two pairs of
// one block run two ladders side by side (the forge's sweep), with half
// the quad's redundant sums a product; ed_verify's quad is one-buffer so
// that four of its blocks share an SM. The other quad kernels (ed, kes,
// vrf_ladders, msm) keep Quad: registers, not shared memory, set their
// blocks an SM, so one buffer buys them nothing, and on an H100 their
// quads on one buffer took 0.99-1.03x Quad's time (vrf_ladders 1.03x at
// 8,192 lanes), within the spread of unchanged kernels. The host build
// runs the four products in order, as for a quad.
#define PK_TEAM1_WORDS (4 * 10 * 32)

template <int N>  // warps: 2 (a pair) or 4 (a quad)
struct Team1 {
  u32 *x;    // exchange area of PK_TEAM1_WORDS words
  int w;     // this warp, 0 .. N - 1; -1 on the host (all four products)
  int lane;
  int bar;   // named barrier of the team's 32 N threads
  int buf;   // unused (one buffer)
};
typedef Team1<2> Pair;
typedef Team1<4> Quad1;

template <int N, class F>
PK_DEV void quad_step(Team1<N> &t, fe out[4], F f) {
#ifdef PK_HOST
  for (int k = 0; k < 4; k++) out[k] = f(k);
#else
  fe m[4 / N];
#pragma unroll
  for (int j = 0; j < 4 / N; j++) {
    const int k = (4 / N) * t.w + j;
    m[j] = f(k);
#pragma unroll
    for (int l = 0; l < 10; l++) t.x[((k * 10 + l) << 5) + t.lane] = m[j].v[l];
  }
  asm volatile("bar.sync %0, %1;" ::"r"(t.bar), "r"(32 * N) : "memory");
#pragma unroll
  for (int k = 0; k < 4; k++) {
    if (k / (4 / N) == t.w) {  // this warp's own products stay in registers
      out[k] = m[k % (4 / N)];
      continue;
    }
#pragma unroll
    for (int l = 0; l < 10; l++) out[k].v[l] = t.x[((k * 10 + l) << 5) + t.lane];
  }
  asm volatile("bar.sync %0, %1;" ::"r"(t.bar), "r"(32 * N) : "memory");
#endif
}

// a barrier of the team's warps alone (none on the host)
template <int N>
PK_DEV void team_sync(const Team1<N> &t) {
#ifndef PK_HOST
  asm volatile("bar.sync %0, %1;" ::"r"(t.bar), "r"(32 * N) : "memory");
#endif
}

// the second step of a doubling or an addition: X = e·f, Y = g·h,
// Z = f·g, T = e·h
template <class Team>
PK_DEV void quad_efgh(Team &qd, ge &r, const fe &e, const fe &f, const fe &g,
                      const fe &h, bool with_t = true) {
  fe o[4];
  quad_step(qd, o, [&](int k) {
    if (k == 3 && !with_t) return h;  // T not formed: nothing reads it
    return fe_mul(k == 0 || k == 3 ? e : k == 1 ? g : f, k == 0 ? f : k == 2 ? g : h);
  });
  r.x = o[0]; r.y = o[1]; r.z = o[2]; r.t = o[3];
}

// ge_dbl over a quad (or a pair): the four squarings, then the four
// products, T's only when the next operation reads it (as ge_dbl's
// with_t; a doubling reads X, Y, Z alone)
template <class Team>
PK_DEV void qdbl(Team &qd, ge &r, const ge &p, bool with_t = true) {
  fe s[4];
  quad_step(qd, s, [&](int k) {
    return fe_sq(k == 0 ? p.x : k == 1 ? p.y : k == 2 ? p.z : fe_add(p.x, p.y));
  });
  fe c = fe_add(s[2], s[2]);
  fe h = fe_add(s[0], s[1]);
  fe e = fe_sub(h, s[3]);
  fe g = fe_sub(s[0], s[1]);
  fe f = fe_add(c, g);
  quad_efgh(qd, r, e, f, g, h, with_t);
}

// ge_add_cached over a quad (or a pair)
template <class Team>
PK_DEV void qadd_cached(Team &qd, ge &r, const ge &p, const gec &q) {
  fe s[4];
  quad_step(qd, s, [&](int k) {
    fe a = k == 0 ? fe_sub(p.y, p.x) : k == 1 ? fe_add(p.y, p.x) : k == 2 ? p.t : p.z;
    return fe_mul(a, k == 0 ? q.ymx : k == 1 ? q.ypx : k == 2 ? q.t2d : q.z2);
  });
  fe e = fe_sub(s[1], s[0]), f = fe_sub(s[3], s[2]);
  fe g = fe_add(s[3], s[2]), h = fe_add(s[1], s[0]);
  quad_efgh(qd, r, e, f, g, h);
}

// ge_add over a quad or a pair (its third product is (T1·T2)·2d, two in a row)
template <class Team>
PK_DEV void qadd(Team &qd, ge &r, const ge &p, const ge &q) {
  fe s[4];
  quad_step(qd, s, [&](int k) {
    fe a = k == 0 ? fe_sub(p.y, p.x) : k == 1 ? fe_add(p.y, p.x)
         : k == 2 ? fe_mul(p.t, q.t) : p.z;
    fe b = k == 0 ? fe_sub(q.y, q.x) : k == 1 ? fe_add(q.y, q.x)
         : k == 2 ? fe_const(PK_D2) : q.z;
    return fe_mul(a, b);
  });
  fe d = fe_add(s[3], s[3]);
  fe e = fe_sub(s[1], s[0]), f = fe_sub(d, s[2]);
  fe g = fe_add(d, s[2]), h = fe_add(s[1], s[0]);
  quad_efgh(qd, r, e, f, g, h);
}

// ge_scalar_mul_w4 over a quad or a pair (the digit loop of the one-thread
// version)
template <class Team, class Tab>
PK_NOINLINE ge qscalar_mul_w4(Team &qref, const u8 *digits, int k, const Tab &tab) {
  Team qd = qref;
  int8_t e[65];
  recode_signed(digits, k, e);
  ge q = ge_identity();
  qadd_cached(qd, q, q, tab_select(tab, e[0]));
#pragma unroll 1
  for (int i = 1; i <= k; i++) {
#pragma unroll 1
    for (int j = 0; j < 4; j++) qdbl(qd, q, q, j == 3);
    qadd_cached(qd, q, q, tab_select(tab, e[i]));
  }
  qref.buf = qd.buf;
  return q;
}

// a·PA + b·PB on one doubling chain (ka >= kb), over the two tables, on
// a quad
template <class TabA, class TabB>
PK_NOINLINE ge qdouble_scalar_mul_w4(Quad &qref, const u8 *da, int ka,
                                     const TabA &ta, const u8 *db, int kb,
                                     const TabB &tb) {
  Quad qd = qref;
  int8_t ea[65], eb[65];
  recode_signed(da, ka, ea);
  recode_signed(db, kb, eb);
  ge q = ge_identity();
#pragma unroll 1
  for (int i = 0; i <= ka; i++) {
    if (i > 0) {
#pragma unroll 1
      for (int j = 0; j < 4; j++) qdbl(qd, q, q, j == 3);
    }
    int jb = i - (ka - kb);
    qadd_cached(qd, q, q, tab_select(ta, ea[i]));
    if (jb >= 0) qadd_cached(qd, q, q, tab_select(tb, eb[jb]));
  }
  qref.buf = qd.buf;
  return q;
}

// ge_base_mul_w8 over a quad or a pair; with q, w0 and w1, q plus the sum
// over windows w0 .. w1 - 1 alone (a part of s·B walked onto a point)
template <class Team>
PK_NOINLINE ge qbase_mul_w8(Team &qref, const u32 *table, const u8 *s, ge q = ge_identity(),
                            int w0 = 0, int w1 = 32) {
  Team qd = qref;
#pragma unroll 1
  for (int w = w0; w < w1; w++) {
    const u32 *e = table + ((size_t)w * 256 + s[w]) * 40;
    ge p;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      p.x.v[i] = PK_LDG(e + i);
      p.y.v[i] = PK_LDG(e + 10 + i);
      p.z.v[i] = PK_LDG(e + 20 + i);
      p.t.v[i] = PK_LDG(e + 30 + i);
    }
    qadd(qd, q, q, p);
  }
  qref.buf = qd.buf;
  return q;
}

// coordinate k of a cached point: Y+X, Y−X, 2d·T, 2Z
PK_DEV fe gec_coord(const gec &c, int k) {
  return k == 0 ? c.ypx : k == 1 ? c.ymx : k == 2 ? c.t2d : c.z2;
}

// whether coordinate k of a table entry is this warp's to store (a quad's
// warp one, a pair's two; the host's one pass all four)
template <int N>
PK_DEV bool team_owns(const Team1<N> &t, int k) { return t.w < 0 || k / (4 / N) == t.w; }

// the table of P (ge_table8's seven cached additions) on a one-buffer
// team, each warp storing its own coordinates of every entry, then a
// barrier of the team before any of its warps reads the table
template <int N>
PK_NOINLINE void qtable8(Team1<N> &qref, const LaneTab &tab, const ge &p) {
  Team1<N> qd = qref;
  ge acc = p;
  const gec p1 = ge_cache(acc);
  gec c = p1;
#pragma unroll 1
  for (int j = 0; j < 8; j++) {
    if (j > 0) {
      qadd_cached(qd, acc, acc, p1);
      c = ge_cache(acc);
    }
    for (int k = 0; k < 4; k++) {
      if (!team_owns(qd, k)) continue;
      const fe v = gec_coord(c, k);
      for (int l = 0; l < 10; l++) tab.at(j, k, l) = v.v[l];
    }
  }
  team_sync(qd);
  qref.buf = qd.buf;
}

// s·B from 32 little-endian scalar bytes; table [32][256][40] limbs; with
// w0, w1 the sum over windows w0 .. w1 - 1 alone (a part of s·B)
PK_NOINLINE ge ge_base_mul_w8(const u32 *table, const u8 *s, int w0 = 0, int w1 = 32) {
  ge q = ge_identity();
#pragma unroll 1
  for (int w = w0; w < w1; w++) {
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

// SHA-512's 80 rounds over a window of 16 message words, unrolled
// sixteen at a time so that every index into the window is a constant:
// the schedule stays in registers
PK_DEV void sha512_rounds(u64 st[8], u64 w[16]) {
  u64 a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6],
      h = st[7];
#pragma unroll 1
  for (int r = 0; r < 80; r += 16) {
#pragma unroll
    for (int j = 0; j < 16; j++) {
      if (r > 0) {  // w[r + j] from the window's w[r + j − 16 .. r + j − 1]
        u64 x = w[(j + 1) & 15], y = w[(j + 14) & 15];
        w[j] += (rotr64(y, 19) ^ rotr64(y, 61) ^ (y >> 6)) + w[(j + 9) & 15] +
                (rotr64(x, 1) ^ rotr64(x, 8) ^ (x >> 7));
      }
      u64 t1 = h + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) + ((e & f) ^ (~e & g)) +
               PK_SHA512_K[r + j] + w[j];
      u64 t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) + ((a & b) ^ (a & c) ^ (b & c));
      h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
    }
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// one SHA-512 compression of 16 big-endian message words (one copy of
// the rounds)
PK_NOINLINE void sha512_compress(u64 st[8], const u64 *m) {
  u64 w[16];
#pragma unroll
  for (int t = 0; t < 16; t++) w[t] = m[t];
  sha512_rounds(st, w);
}

PK_DEV void sha512_init(u64 st[8]) {
  for (int i = 0; i < 8; i++) st[i] = PK_SHA512_H0[i];
}

PK_DEV void sha512_digest(const u64 st[8], u8 *out) {
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (u8)(st[i] >> (56 - 8 * j));
}

// SHA-512 of an N-byte message whose byte k is src(k), N known when
// compiled: every block's words are formed in registers (the padding and
// the length at their fixed places), no copy of the message
template <int N, class F>
PK_DEV void sha512_msg(F src, u8 *out) {
  constexpr int NB = (N + 17 + 127) / 128;
  u64 st[8], w[16];
  sha512_init(st);
#pragma unroll
  for (int b = 0; b < NB; b++) {
#pragma unroll
    for (int t = 0; t < 16; t++) {
      u64 x = 0;
#pragma unroll
      for (int j = 0; j < 8; j++) {
        const int k = 128 * b + 8 * t + j;
        x = (x << 8) | (k < N ? (u64)src(k) : k == N ? 0x80 : 0);
      }
      w[t] = x;
    }
    if (b == NB - 1) w[15] = (u64)N * 8;  // the length in bits (its high word 0)
    sha512_compress(st, w);
  }
  sha512_digest(st, out);
}

// SHA-512 over pre-padded column blocks [nb][128][B] of lane `lane`,
// predicated per lane on its own block count (block 0 always applies)
PK_NOINLINE void sha512_columns(const int32_t *blocks, int nb, int nblocks,
                                int lane, int B, u8 *out) {
  u64 st[8], w[16];
  sha512_init(st);
#pragma unroll 1
  for (int k = 0; k < nb; k++) {
    if (k > 0 && k >= nblocks) break;
#pragma unroll
    for (int t = 0; t < 16; t++) {
      u64 x = 0;
      for (int j = 0; j < 8; j++)
        x = (x << 8) | (u8)blocks[((size_t)k * 128 + 8 * t + j) * B + lane];
      w[t] = x;
    }
    sha512_compress(st, w);
  }
  sha512_digest(st, out);
}

// Blake2b-256 on one thread, its state and message in registers
PK_DEV void b2b_g1(u64 &a, u64 &b, u64 &c, u64 &d, u64 x, u64 y) {
  a = a + b + x; d = rotr64(d ^ a, 32);
  c = c + d;     b = rotr64(b ^ c, 24);
  a = a + b + y; d = rotr64(d ^ a, 16);
  c = c + d;     b = rotr64(b ^ c, 63);
}

// One round with the message schedule S (PK_B2B_SIGMA_NIB<r>: index k in
// nibble 15 - k): every index is a constant, so with the rounds unrolled
// each message word is a register (or a known zero the compiler drops),
// and the diagonal step is a renaming of the state's registers.
template <u64 S>
PK_DEV void b2b_round1(u64 *v, const u64 *m) {
  b2b_g1(v[0], v[4], v[8], v[12], m[(S >> 60) & 15], m[(S >> 56) & 15]);
  b2b_g1(v[1], v[5], v[9], v[13], m[(S >> 52) & 15], m[(S >> 48) & 15]);
  b2b_g1(v[2], v[6], v[10], v[14], m[(S >> 44) & 15], m[(S >> 40) & 15]);
  b2b_g1(v[3], v[7], v[11], v[15], m[(S >> 36) & 15], m[(S >> 32) & 15]);
  b2b_g1(v[0], v[5], v[10], v[15], m[(S >> 28) & 15], m[(S >> 24) & 15]);
  b2b_g1(v[1], v[6], v[11], v[12], m[(S >> 20) & 15], m[(S >> 16) & 15]);
  b2b_g1(v[2], v[7], v[8], v[13], m[(S >> 12) & 15], m[(S >> 8) & 15]);
  b2b_g1(v[3], v[4], v[9], v[14], m[(S >> 4) & 15], m[S & 15]);
}

// Unkeyed Blake2b-256 of one final block: the message words m[0..15]
// (n <= 128 bytes, little-endian, zero past n) -> the digest's words
// h[0..3] (digest byte 8j + k is byte k of h[j]). The state and the
// message stay in registers: 12 unrolled rounds of 8 G, whose four
// columns (then four diagonals) are independent, so one thread issues
// four dependent chains side by side.
PK_DEV void b2b_256_1(const u64 *m, u64 n, u64 *h) {
  u64 v[16];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    v[j] = PK_SHA512_H0[j];
    v[8 + j] = PK_SHA512_H0[j];
  }
  v[0] ^= 0x01010000ull ^ 32;
  v[12] ^= n;
  v[14] = ~v[14];
  b2b_round1<PK_B2B_SIGMA_NIB0>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB1>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB2>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB3>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB4>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB5>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB6>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB7>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB8>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB9>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB0>(v, m);
  b2b_round1<PK_B2B_SIGMA_NIB1>(v, m);
#pragma unroll
  for (int j = 0; j < 4; j++)
    h[j] = PK_SHA512_H0[j] ^ (j == 0 ? 0x01010000ull ^ 32 : 0) ^ v[j] ^ v[8 + j];
}

// b2b_256_1 behind a call: one copy of the unrolled compression for a
// kernel that hashes at several places
PK_NOINLINE void blake2b_256_words(const u64 *m, u64 n, u64 *h) { b2b_256_1(m, n, h); }

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

// x mod L for a 512-bit x as eight little-endian words, in 21-bit signed
// limbs in registers, after ref10's sc_reduce:
// L = 2^252 + c, so limb i >= 12 folds into limbs i − 12 .. i − 7 with
// the six signed 21-bit limbs of −c; rounded carries between the folds,
// exact ones at the end (every limb stays under 2^50)
PK_DEV void sc_fold(i64 *s, int i) {
  s[i - 12] += s[i] * 666643;
  s[i - 11] += s[i] * 470296;
  s[i - 10] += s[i] * 654183;
  s[i - 9] -= s[i] * 997805;
  s[i - 8] += s[i] * 136657;
  s[i - 7] -= s[i] * 683901;
  s[i] = 0;
}

PK_DEV void sc_carry21(i64 *s, int k, bool round) {
  i64 c = (s[k] + (round ? (i64)1 << 20 : 0)) >> 21;
  s[k + 1] += c;
  s[k] -= c * ((i64)1 << 21);
}

PK_NOINLINE void sc_reduce_words(const u64 *x, u8 *out) {
  i64 s[24];
#pragma unroll
  for (int k = 0; k < 24; k++) {
    const int off = 21 * k, q = off >> 6, r = off & 63;
    u64 v = x[q] >> r;
    if (r > 43 && q < 7) v |= x[q + 1] << (64 - r);
    s[k] = (i64)(k < 23 ? v & 2097151 : v);
  }
#pragma unroll
  for (int i = 23; i >= 18; i--) sc_fold(s, i);
#pragma unroll
  for (int k = 6; k <= 16; k += 2) sc_carry21(s, k, true);
#pragma unroll
  for (int k = 7; k <= 15; k += 2) sc_carry21(s, k, true);
#pragma unroll
  for (int i = 17; i >= 12; i--) sc_fold(s, i);
#pragma unroll
  for (int k = 0; k <= 10; k += 2) sc_carry21(s, k, true);
#pragma unroll
  for (int k = 1; k <= 11; k += 2) sc_carry21(s, k, true);
  sc_fold(s, 12);
#pragma unroll
  for (int k = 0; k <= 11; k++) sc_carry21(s, k, false);
  sc_fold(s, 12);
#pragma unroll
  for (int k = 0; k <= 10; k++) sc_carry21(s, k, false);
  u64 w[4] = {0, 0, 0, 0};  // limbs 0 .. 10 under 2^21, limb 11 under 2^22
#pragma unroll
  for (int k = 0; k < 12; k++) {
    const int off = 21 * k, q = off >> 6, r = off & 63;
    w[q] |= (u64)s[k] << r;
    if (r > 42) w[q + 1] |= (u64)s[k] >> (64 - r);
  }
#pragma unroll
  for (int k = 0; k < 32; k++) out[k] = (u8)(w[k >> 3] >> (8 * (k & 7)));
}

// 64 little-endian bytes -> 32 bytes of the value mod L
PK_DEV void sc_reduce512(const u8 *in, u8 *out) {
  u64 x[8];
  for (int j = 0; j < 8; j++) {
    u64 v = 0;
    for (int k = 7; k >= 0; k--) v = (v << 8) | in[8 * j + k];
    x[j] = v;
  }
  sc_reduce_words(x, out);
}

// n >= 0 little-endian column sums (the value < 2^512) -> its 64 bytes
// (one sequential carry)
PK_DEV void sc_carry64(const u64 *cols, int n, u8 *out) {
  u64 c = 0;
  for (int i = 0; i < 64; i++) {
    u64 v = c + (i < n ? cols[i] : 0);
    out[i] = (u8)(v & 255);
    c = v >> 8;
  }
}

// a·b mod L for a 4·NA-byte a and a 32-byte b, little-endian (NA 4 or
// 8): the product in 32-bit words in registers, then sc_reduce_words
template <int NA>
PK_NOINLINE void sc_mul(const u8 *a, const u8 *b, u8 *out) {
  u32 x[NA], y[8], r[NA + 8];
#pragma unroll
  for (int k = 0; k < NA; k++)
    x[k] = a[4 * k] | (a[4 * k + 1] << 8) | (a[4 * k + 2] << 16) | ((u32)a[4 * k + 3] << 24);
#pragma unroll
  for (int k = 0; k < 8; k++)
    y[k] = b[4 * k] | (b[4 * k + 1] << 8) | (b[4 * k + 2] << 16) | ((u32)b[4 * k + 3] << 24);
#pragma unroll
  for (int k = 0; k < NA + 8; k++) r[k] = 0;
#pragma unroll
  for (int i = 0; i < NA; i++) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      u64 t = (u64)x[i] * y[j] + r[i + j] + carry;
      r[i + j] = (u32)t;
      carry = t >> 32;
    }
    r[i + 8] = (u32)carry;
  }
  u64 w[8];
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = 2 * k < NA + 8 ? r[2 * k] | (u64)r[2 * k + 1] << 32 : 0;
  sc_reduce_words(w, out);
}

// a + b mod L for 32-byte little-endian scalars (no kernel calls it: the
// host build's pk_sc_add holds it for a later kernel that needs it)
PK_NOINLINE void sc_add(const u8 *a, const u8 *b, u8 *out) {
  u64 cols[32];
  for (int k = 0; k < 32; k++) cols[k] = (u64)a[k] + b[k];
  u8 wide[64];
  sc_carry64(cols, 32, wide);
  sc_reduce512(wide, out);
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
