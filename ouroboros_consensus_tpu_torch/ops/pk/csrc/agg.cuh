// Lane bodies of the window aggregate's three kernels (agg_prep.cu,
// dedupe.cu, msm.cu): the per-lane prep, the key dedupe's tiles, merges
// and slots mod L, and the phases of the shared signed-digit bucket
// machine.
// Each body is a function of its thread's index, so the host build
// (csrc/host_emu.cpp) runs a phase's bodies one after another and the CPU
// tests hold them to the twins (ops/pk/aggregate.py, msm.py).
#pragma once
#include "stages.cuh"
#include "wire.cuh"

// atomics (sequential on the host, where the threads run in turn)
#ifdef PK_HOST
static inline int pk_atomic_add(int *p, int v) { int o = *p; *p += v; return o; }
#else
PK_DEV int pk_atomic_add(int *p, int v) { return atomicAdd(p, v); }
#endif

// ---------------------------------------------------------------------------
// A field element over ten lanes of a warp: lane k of a group holds limb
// k, three groups a warp (lanes 30 and 31 run along), so a round of
// products runs three at once. Lane k forms its own column of the product
// (ten terms, the operands' limbs shuffled in) and the carry passes move
// each column's carry one lane up, so every product, sum and difference
// equals pk.cuh's fe_mul, fe_add and fe_sub limb for limb (and w_inv
// fe_inv, w_dbl / w_add_pt the one-thread ge_dbl / ge_add). agg_prep
// inverts its tree's root this way, msm runs its Horner chain. On the host
// a warp value holds all 32 lanes and a shuffle is an index.
// ---------------------------------------------------------------------------

#ifdef PK_HOST
#define W_N 32
#define W_LANES(l) for (int l = 0; l < 32; l++)
#define W_AT(x, l) ((x).v[l])
#define W_SHFL(x, src) ((x).v[(src) & 31])
#else
#define W_N 1
#define W_LANES(l) for (int l = threadIdx.x & 31, w_once = 0; w_once < 1; w_once++)
#define W_AT(x, l) ((x).v[0])
#define W_SHFL(x, src) __shfl_sync(0xffffffffu, (x).v[0], (src))
#endif

struct wv { u32 v[W_N]; };    // a limb a lane
struct wv64 { u64 v[W_N]; };  // a column a lane

// lane l's limb and its group's first lane
PK_DEV int w_limb(int l) { return l % 10; }
PK_DEV int w_base(int l) { return l - l % 10; }

// one carry pass of fe_carry: limb k keeps its low bits plus the carry
// out of limb k - 1 (limb 0: 19 x limb 9's)
PK_DEV wv64 w_pass(const wv64 &h) {
  wv64 c, r;
  W_LANES(l) { W_AT(c, l) = W_AT(h, l) >> ((w_limb(l) & 1) ? 25 : 26); }
  W_LANES(l) {
    int k = w_limb(l);
    u64 cin = W_SHFL(c, w_base(l) + (k == 0 ? 9 : k - 1));
    W_AT(r, l) = (W_AT(h, l) & ((((u64)1) << ((k & 1) ? 25 : 26)) - 1)) +
                 (k == 0 ? 19 * cin : cin);
  }
  return r;
}

PK_DEV wv w_low(const wv64 &h) {
  wv r;
  W_LANES(l) { W_AT(r, l) = (u32)W_AT(h, l); }
  return r;
}

// fe_mul's column k on lane k: term (i, k - i mod 10) doubled when both
// limbs are odd (i odd, k even) and times 19 when it wraps (i > k)
PK_DEV wv w_mul(const wv &a, const wv &b) {
  wv64 h;
  W_LANES(l) {
    int k = w_limb(l), g = w_base(l);
    u64 acc = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      u32 ai = W_SHFL(a, g + i);
      if (i & 1) ai = (k & 1) ? ai : 2 * ai;
      u32 bj = W_SHFL(b, g + (k >= i ? k - i : k - i + 10));
      acc += (u64)ai * (i > k ? 19 * bj : bj);
    }
    W_AT(h, l) = acc;
  }
  return w_low(w_pass(w_pass(h)));
}

PK_DEV wv w_add(const wv &a, const wv &b) {
  wv64 h;
  W_LANES(l) { W_AT(h, l) = (u64)W_AT(a, l) + W_AT(b, l); }
  return w_low(w_pass(h));
}

// limb k of 2p (PK_TWO_P)
PK_DEV u32 w_two_p(int k) { return k == 0 ? 0x7ffffdau : (k & 1) ? 0x3fffffeu : 0x7fffffeu; }

PK_DEV wv w_sub(const wv &a, const wv &b) {
  wv64 h;
  W_LANES(l) { W_AT(h, l) = (u64)W_AT(a, l) + w_two_p(w_limb(l)) - W_AT(b, l); }
  return w_low(w_pass(h));
}

// group 0 takes a, group 1 b, the rest c
PK_DEV wv w_pick(const wv &a, const wv &b, const wv &c) {
  wv r;
  W_LANES(l) { W_AT(r, l) = l < 10 ? W_AT(a, l) : l < 20 ? W_AT(b, l) : W_AT(c, l); }
  return r;
}

// group g's element in every group
PK_DEV wv w_from(const wv &x, int g) {
  wv r;
  W_LANES(l) { W_AT(r, l) = W_SHFL(x, 10 * g + w_limb(l)); }
  return r;
}

// w_mul(a, a) with half the shuffles and products: column k's ten terms
// pair up (a_i·a_j and a_j·a_i, i + j ≡ k mod 10: both odd or not, both
// wrapping or not), so lane k sums five products and doubles them, and an
// even k adds the squares of limbs k/2 and k/2 + 5 (the second wraps).
// The column sums are w_mul's, so are the limbs
PK_DEV wv w_sq(const wv &a) {
  wv64 h;
  W_LANES(l) {
    const int k = w_limb(l), g = w_base(l), even = (k & 1) == 0;
    const int base = (k + 1) >> 1;
    u64 pairs = 0, squares = 0;
#pragma unroll
    for (int t = 0; t < 5; t++) {
      const int i = base + t < 10 ? base + t : base + t - 10;
      const int j = k >= i ? k - i : k - i + 10;
      const u32 f = ((even && (i & 1)) ? 2 : 1) * (i > k ? 19 : 1);  // f · a_i < 2^32
      const u64 p = (u64)(f * W_SHFL(a, g + i)) * W_SHFL(a, g + j);
      if (even && t == 0) squares += p;  // limb k/2 squared
      else pairs += p;
    }
    const int d = (k >> 1) + 5;  // every lane shuffles; an even k adds it
    const u32 ad = W_SHFL(a, g + d);
    if (even) squares += (u64)(((d & 1) ? 38 : 19) * ad) * ad;
    W_AT(h, l) = 2 * pairs + squares;
  }
  return w_low(w_pass(w_pass(h)));
}

// k squarings in a row
PK_DEV wv w_sqn(wv a, int k) {
#pragma unroll 1
  for (int i = 0; i < k; i++) a = w_sq(a);
  return a;
}

// x^(p − 2): fe_inv's chain, a round a product (one group of the three
// carries it)
PK_DEV wv w_inv(const wv &x) {
  wv t0 = w_sq(x);
  wv t1 = w_mul(x, w_sqn(t0, 2));
  wv x11 = w_mul(t0, t1);
  wv t31 = w_mul(t1, w_sq(x11));
  wv a = w_mul(w_sqn(t31, 5), t31);
  wv b = w_mul(w_sqn(a, 10), a);
  wv c = w_mul(w_sqn(b, 20), b);
  wv d = w_mul(w_sqn(c, 10), a);
  wv e = w_mul(w_sqn(d, 50), d);
  wv f = w_mul(w_sqn(e, 100), e);
  wv g = w_mul(w_sqn(f, 50), d);
  return w_mul(w_sqn(g, 5), x11);
}

// ---------------------------------------------------------------------------
// agg_prep: one lane over ten warps, 32 lanes a block
// ---------------------------------------------------------------------------
//
// A warp a role. Eight roles decompress one key each (A_e, R_e, V, A_l,
// R_k, Y, U, Γ); AW_AE first hashes the OCert challenge, AW_AL then walks
// the KES Merkle path, AW_Y then forms the leader value and eta, AW_G then
// multiplies Γ by the cofactor. AW_H hashes to the curve (H = 8 ·
// Elligator2). AW_HASH hashes the KES challenge and the lane's Fiat–Shamir
// transcript (from the input columns and the two digests, a block at a
// time). H and 8Γ are compressed with one inversion a block: their 64 Z
// coordinates are the leaves of a product tree in shared memory; AW_H
// forms the tree, inverts its root on the warp (w_inv) and walks back
// down. Each mod-L product runs on a warp that holds its other factor once
// AW_HASH has published z. Warps meet at named barriers, each between the
// warps it names (agg_prep.cu), so no warp waits on work it does not read.
// Every body below is a function of (lane, scratch); host_emu.cpp runs
// them phase by phase in an order the barriers allow.

// the 22 limb-first input arrays, unpack_limb_first's order
enum {
  AI_ED_PK, AI_ED_R, AI_ED_S, AI_ED_HB, AI_ED_HNB, AI_KES_VK, AI_KES_PER,
  AI_KES_R, AI_KES_S, AI_KES_LEAF, AI_KES_SIB, AI_KES_HB, AI_KES_HNB,
  AI_VRF_PK, AI_VRF_G, AI_VRF_U, AI_VRF_V, AI_VRF_S, AI_VRF_AL, AI_BETA,
  AI_TLO, AI_THI, AI_N
};
struct AggIn { const int32_t *c[AI_N]; };
// alone: the grid has at most one block an SM (agg_prep.cu orders its
// warps' roles by it; the host build ignores it)
struct AggShape { int B, depth, nb_ed, nb_kes, alone; };
// outputs: points [9][B][40] int32 (point-major), scalars [12][B][32]
// bytes, flags [5][B], eta and leader value [32][B]
// (stamps: the instrument build's clock64 buffer, agg_stamps.cu; else null)
struct AggOut { int32_t *pts; u8 *sc; int32_t *flags, *eta, *lv; u64 *stamps; };
enum { PT_RK, PT_U, PT_V, PT_G, PT_H, PT_RE, PT_AE, PT_AL, PT_Y };
enum { SC_Z2, SC_Z3, SC_Z4, SC_Z4C, SC_Z4S, SC_Z1, SC_Z1H, SC_Z2H, SC_Z3C,
       SC_B1, SC_B2, SC_B3 };

#define AGG_WARPS 10
#define AGG_LEAVES (2 * PK_GROUP)  // the tree's leaves: Z of H (2l) and of 8Γ (2l + 1)
#define AGG_TN (2 * AGG_LEAVES)    // tree nodes in heap order: root 1, leaves 64 .. 127
enum { AW_AE, AW_RE, AW_V, AW_AL, AW_RK, AW_Y, AW_U, AW_G, AW_H, AW_HASH };
// the cheap checks, a row a role (OK_RE and OK_RK with s < L, OK_G with
// s_v < L and β' = β)
enum { OK_AE, OK_RE, OK_V, OK_AL, OK_RK, OK_Y, OK_U, OK_G, OK_MERKLE, OK_N };

// what the roles hand on: bytes lane-minor, field elements limb-major
struct AggScratch {
  u8 ed_dig[64 * PK_GROUP];   // the OCert challenge digest (AW_AE)
  u8 kes_dig[64 * PK_GROUP];  // the KES challenge digest (AW_HASH)
  u8 he[32 * PK_GROUP];       // h_e = ed_dig mod L (AW_AE)
  u8 z[64 * PK_GROUP];        // the Fiat–Shamir digest, low bits forced (AW_HASH)
  u8 c16[16 * PK_GROUP];      // c (AW_H)
  u32 xy[4][10 * PK_GROUP];   // X, Y of H, then of 8Γ
  u32 node[10 * AGG_TN];      // the product tree (a zero Z's leaf holds 1)
  u32 inv[10 * AGG_TN];       // the inverses of its nodes
  u8 zero[AGG_LEAVES];        // the leaves whose Z is 0
  int32_t ok[OK_N * PK_GROUP];
};

PK_DEV fe agg_fe_get(const u32 *a, int stride, int k) {
  fe r;
  for (int l = 0; l < 10; l++) r.v[l] = a[l * stride + k];
  return r;
}

PK_DEV void agg_fe_put(u32 *a, int stride, int k, const fe &x) {
  for (int l = 0; l < 10; l++) a[l * stride + k] = x.v[l];
}

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

PK_DEV bool agg_scalar_ok(const int32_t *col, int i, int B) {
  u8 b[32];
  load_bytes(col, 32, i, B, b);
  return sc_lt_l(b);
}

// 64 lane-minor scratch bytes (a digest) mod L
PK_DEV void agg_reduce_lane(const u8 *dig, int lane, u8 *out) {
  u64 x[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 v = 0;
    for (int k = 7; k >= 0; k--) v = (v << 8) | dig[((8 * j + k) << 5) + lane];
    x[j] = v;
  }
  sc_reduce_words(x, out);
}

// a decompression role: the key of input column `col`, negated, into
// point column `pt`; whether it decodes into ok row `row`
PK_DEV void agg_decompress(int col, int pt, int row, int i, bool live, int lane,
                           const AggShape &s, const AggIn &in, const AggOut &o,
                           AggScratch &sc) {
  ge p;
  sc.ok[row * PK_GROUP + lane] = agg_decode(in.c[col], i, s.B, p) ? 1 : 0;
  if (live) agg_put_point(o, pt, i, s.B, ge_neg(p));
}

// AW_AE, first: the OCert challenge digest
PK_DEV void agg_ae_digest(int i, int lane, const AggShape &s, const AggIn &in, AggScratch &sc) {
  u8 dig[64];
  sha512_columns(in.c[AI_ED_HB], s.nb_ed, in.c[AI_ED_HNB][i], i, s.B, dig);
  for (int k = 0; k < 64; k++) sc.ed_dig[(k << 5) + lane] = dig[k];
}

// AW_AE, then: h_e and A_e
PK_DEV void agg_ae_point(int i, bool live, int lane, const AggShape &s, const AggIn &in,
                         const AggOut &o, AggScratch &sc) {
  u8 h[32];
  agg_reduce_lane(sc.ed_dig, lane, h);
  for (int k = 0; k < 32; k++) sc.he[(k << 5) + lane] = h[k];
  agg_decompress(AI_ED_PK, PT_AE, OK_AE, i, live, lane, s, in, o, sc);
}

// AW_RE: R_e, and s_e < L
PK_DEV void agg_re_point(int i, bool live, int lane, const AggShape &s, const AggIn &in,
                         const AggOut &o, AggScratch &sc) {
  agg_decompress(AI_ED_R, PT_RE, OK_RE, i, live, lane, s, in, o, sc);
  sc.ok[OK_RE * PK_GROUP + lane] &= agg_scalar_ok(in.c[AI_ED_S], i, s.B) ? 1 : 0;
}

// AW_RK: R_k, and s_k < L
PK_DEV void agg_rk_point(int i, bool live, int lane, const AggShape &s, const AggIn &in,
                         const AggOut &o, AggScratch &sc) {
  agg_decompress(AI_KES_R, PT_RK, OK_RK, i, live, lane, s, in, o, sc);
  sc.ok[OK_RK * PK_GROUP + lane] &= agg_scalar_ok(in.c[AI_KES_S], i, s.B) ? 1 : 0;
}

// AW_AL: A_l, then the Merkle walk and the period's range
PK_DEV void agg_al_point(int i, bool live, int lane, const AggShape &s, const AggIn &in,
                         const AggOut &o, AggScratch &sc) {
  agg_decompress(AI_KES_LEAF, PT_AL, OK_AL, i, live, lane, s, in, o, sc);
  sc.ok[OK_MERKLE * PK_GROUP + lane] =
      kes_merkle(i, s.B, s.depth, in.c[AI_KES_VK], in.c[AI_KES_PER], in.c[AI_KES_LEAF],
                 in.c[AI_KES_SIB]) ? 1 : 0;
}

// AW_Y: Y, then the leader value, eta and the two threshold compares
// (flag rows 3 and 4), which read only the declared β
PK_DEV void agg_y_point(int i, bool live, int lane, const AggShape &s, const AggIn &in,
                        const AggOut &o, AggScratch &sc) {
  agg_decompress(AI_VRF_PK, PT_Y, OK_Y, i, live, lane, s, in, o, sc);
  finish_role_leader(i, s.B, live, in.c[AI_BETA], in.c[AI_TLO], in.c[AI_THI], o.flags, o.eta, o.lv);
}

// a tree leaf: Z, or 1 in place of a zero Z (whose inverse is then 0, as
// fe_inv(0) is)
PK_DEV void agg_tree_leaf(AggScratch &sc, int k, const fe &z) {
  bool zero = fe_is_zero(z);
  sc.zero[k] = zero ? 1 : 0;
  agg_fe_put(sc.node, AGG_TN, AGG_LEAVES + k, zero ? fe_one() : z);
}

// AW_G, first: Γ and s_v < L, −Γ, and 8Γ's X, Y and leaf
PK_DEV void agg_g_point(int i, bool live, int lane, const AggShape &s, const AggIn &in,
                        const AggOut &o, AggScratch &sc) {
  ge g;
  sc.ok[OK_G * PK_GROUP + lane] =
      vrf_decode_gamma(i, s.B, in.c[AI_VRF_G], in.c[AI_VRF_S], g) ? 1 : 0;
  ge g8 = ge_mul_cofactor(g);
  agg_fe_put(sc.xy[2], PK_GROUP, lane, g8.x);
  agg_fe_put(sc.xy[3], PK_GROUP, lane, g8.y);
  agg_tree_leaf(sc, 2 * lane + 1, g8.z);
  if (live) agg_put_point(o, PT_G, i, s.B, ge_neg(g));
}

// AW_H, first: H = 8·Elligator2(SHA-512(suite ‖ 1 ‖ Y ‖ alpha) mod 2^255)
// (stages.cuh's vrf_hash_h), and its X, Y and leaf
PK_DEV void agg_h_point(int i, bool live, int lane, const AggShape &s, const AggIn &in,
                        const AggOut &o, AggScratch &sc) {
  ge h = vrf_hash_h(i, s.B, in.c[AI_VRF_PK], in.c[AI_VRF_AL]);
  agg_fe_put(sc.xy[0], PK_GROUP, lane, h.x);
  agg_fe_put(sc.xy[1], PK_GROUP, lane, h.y);
  agg_tree_leaf(sc, 2 * lane, h.z);
  if (live) agg_put_point(o, PT_H, i, s.B, h);
}

// the tree, a thread a node: node n + t of the level of n nodes from its
// children (up), then their inverses from its own (down; below the
// lowest level a zero Z's inverse is 0)
PK_DEV void agg_tree_up(AggScratch &sc, int n, int t) {
  int m = n + t;
  agg_fe_put(sc.node, AGG_TN, m, fe_mul(agg_fe_get(sc.node, AGG_TN, 2 * m),
                                        agg_fe_get(sc.node, AGG_TN, 2 * m + 1)));
}

PK_DEV void agg_tree_down(AggScratch &sc, int n, int t) {
  int m = n + t;
  fe iv = agg_fe_get(sc.inv, AGG_TN, m);
  fe il = fe_mul(iv, agg_fe_get(sc.node, AGG_TN, 2 * m + 1));
  fe ir = fe_mul(iv, agg_fe_get(sc.node, AGG_TN, 2 * m));
  if (2 * m >= AGG_LEAVES) {
    if (sc.zero[2 * m - AGG_LEAVES]) il = fe_zero();
    if (sc.zero[2 * m + 1 - AGG_LEAVES]) ir = fe_zero();
  }
  agg_fe_put(sc.inv, AGG_TN, 2 * m, il);
  agg_fe_put(sc.inv, AGG_TN, 2 * m + 1, ir);
}

// the root's inverse, on the whole warp (a field element over ten lanes)
PK_DEV void agg_tree_invert(AggScratch &sc) {
  wv x;
  W_LANES(l) { W_AT(x, l) = sc.node[w_limb(l) * AGG_TN + 1]; }
  wv r = w_inv(x);
  W_LANES(l) {
    if (l < 10) sc.inv[l * AGG_TN + 1] = W_AT(r, l);
  }
}

// leaf 2·lane + which's point (0: H, 1: 8Γ) compressed with its inverse
PK_DEV void agg_compress(const AggScratch &sc, int which, int lane, u8 *out) {
  fe iz = agg_fe_get(sc.inv, AGG_TN, AGG_LEAVES + 2 * lane + which);
  fe x = fe_mul(agg_fe_get(sc.xy[2 * which], PK_GROUP, lane), iz);
  fe y = fe_mul(agg_fe_get(sc.xy[2 * which + 1], PK_GROUP, lane), iz);
  fe_to_bytes(out, y);
  out[31] |= (u8)(fe_parity(x) << 7);
}

// AW_G, after the tree: β' = SHA-512(suite ‖ 3 ‖ 8Γ) against the declared β
PK_DEV void agg_g_beta(int i, int lane, const AggShape &s, const AggIn &in, AggScratch &sc) {
  u8 enc[32], dg[64];
  agg_compress(sc, 1, lane, enc);
  vrf_beta(enc, dg);
  bool ok = true;
  for (int k = 0; k < 64; k++) ok = ok && dg[k] == (u8)in.c[AI_BETA][(size_t)k * s.B + i];
  if (!ok) sc.ok[OK_G * PK_GROUP + lane] = 0;
}

// AW_H, after the tree: c = SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖ V)[:16]
PK_DEV void agg_h_challenge(int i, int lane, const AggShape &s, const AggIn &in,
                            AggScratch &sc) {
  u8 enc[32], dg[64];
  agg_compress(sc, 0, lane, enc);
  vrf_challenge(enc, i, s.B, in.c[AI_VRF_G], in.c[AI_VRF_U], in.c[AI_VRF_V], dg);
  for (int k = 0; k < 16; k++) sc.c16[(k << 5) + lane] = dg[k];
}

// AW_HASH, first: the KES challenge digest
PK_DEV void agg_kes_digest(int i, int lane, const AggShape &s, const AggIn &in,
                           AggScratch &sc) {
  u8 dig[64];
  sha512_columns(in.c[AI_KES_HB], s.nb_kes, in.c[AI_KES_HNB][i], i, s.B, dig);
  for (int k = 0; k < 64; k++) sc.kes_dig[(k << 5) + lane] = dig[k];
}

// AW_HASH, after AW_AE's digest: the Fiat–Shamir digest of the lane's
// transcript (tag ‖ R_e ‖ s_e ‖ OCert digest ‖ R_k ‖ s_k ‖ KES digest ‖ Γ ‖
// U ‖ V ‖ s_v ‖ Y ‖ alpha ‖ β, 520 bytes: aggregate.fs_coefficients)
PK_DEV void agg_fs(int i, int lane, const AggShape &s, const AggIn &in, AggScratch &sc) {
  const u64 tag = 0x6f6374524c432d31ull;  // "octRLC-1"
  // after the tag, the transcript's 32-byte runs q = 0 .. 15: R_e, s_e, the
  // OCert digest (2), R_k, s_k, the KES digest (2), Γ, U, V, s_v, Y,
  // alpha, β (2)
  const int32_t *col[14] = {in.c[AI_ED_R], in.c[AI_ED_S], nullptr, nullptr,
                            in.c[AI_KES_R], in.c[AI_KES_S], nullptr, nullptr,
                            in.c[AI_VRF_G], in.c[AI_VRF_U], in.c[AI_VRF_V], in.c[AI_VRF_S],
                            in.c[AI_VRF_PK], in.c[AI_VRF_AL]};
  const int32_t *beta = in.c[AI_BETA];
  const int B = s.B;
  u8 z[64];
  sha512_msg<520>([&](int k) -> u8 {
    if (k < 8) return (u8)(tag >> (56 - 8 * k));
    const int q = (k - 8) >> 5, r = (k - 8) & 31;
    if (q == 2 || q == 3) return sc.ed_dig[((32 * (q - 2) + r) << 5) + lane];
    if (q == 6 || q == 7) return sc.kes_dig[((32 * (q - 6) + r) << 5) + lane];
    if (q < 14) return (u8)col[q][(size_t)r * B + i];
    return (u8)beta[(size_t)(32 * (q - 14) + r) * B + i];
  }, z);
  for (int k = 0; k < 64; k++) sc.z[(k << 5) + lane] = (k & 15) == 0 ? (z[k] | 1) : z[k];
}

// once z is published: coefficient z_(r+1) into scalar row `row`, and its
// product with the n bytes x mod L
PK_DEV void agg_coef(int r, int row, int i, bool live, int lane, const AggShape &s,
                     const AggOut &o, const AggScratch &sc) {
  u8 z[16];
  for (int k = 0; k < 16; k++) z[k] = sc.z[((16 * r + k) << 5) + lane];
  if (live) agg_put_scalar(o, row, i, s.B, z, 16);
}

// x: n (16 or 32) bytes
PK_DEV void agg_product(int r, const u8 *x, int n, int row, int i, bool live, int lane,
                        const AggShape &s, const AggOut &o, const AggScratch &sc) {
  u8 z[16], xx[32], p[32];
  for (int k = 0; k < 16; k++) z[k] = sc.z[((16 * r + k) << 5) + lane];
  for (int k = 0; k < 32; k++) xx[k] = k < n ? x[k] : 0;
  sc_mul<4>(z, xx, p);
  if (live) agg_put_scalar(o, row, i, s.B, p, 32);
}

// a product with 32 bytes of input column `col`
PK_DEV void agg_product_col(int r, int col, int row, int i, bool live, int lane,
                            const AggShape &s, const AggIn &in, const AggOut &o,
                            const AggScratch &sc) {
  u8 x[32];
  load_bytes(in.c[col], 32, i, s.B, x);
  agg_product(r, x, 32, row, i, live, lane, s, o, sc);
}

// the products, by role: z1, z1·h_e (AW_AE); z1·s_e (AW_RE); z3, z3·s_v
// (AW_V); z2·s_k (AW_RK); z4, z4·s_v (AW_U); z4·c (AW_G); z3·c (AW_H);
// z2, z2·h_k (AW_HASH)
PK_DEV void agg_products(int role, int i, bool live, int lane, const AggShape &s,
                         const AggIn &in, const AggOut &o, const AggScratch &sc) {
  u8 x[32];
  if (role == AW_AE) {
    for (int k = 0; k < 32; k++) x[k] = sc.he[(k << 5) + lane];
    agg_coef(0, SC_Z1, i, live, lane, s, o, sc);
    agg_product(0, x, 32, SC_Z1H, i, live, lane, s, o, sc);
  } else if (role == AW_RE) {
    agg_product_col(0, AI_ED_S, SC_B1, i, live, lane, s, in, o, sc);
  } else if (role == AW_V) {
    agg_coef(2, SC_Z3, i, live, lane, s, o, sc);
    agg_product_col(2, AI_VRF_S, SC_B3, i, live, lane, s, in, o, sc);
  } else if (role == AW_RK) {
    agg_product_col(1, AI_KES_S, SC_B2, i, live, lane, s, in, o, sc);
  } else if (role == AW_U) {
    agg_coef(3, SC_Z4, i, live, lane, s, o, sc);
    agg_product_col(3, AI_VRF_S, SC_Z4S, i, live, lane, s, in, o, sc);
  } else if (role == AW_G || role == AW_H) {
    for (int k = 0; k < 16; k++) x[k] = sc.c16[(k << 5) + lane];
    if (role == AW_G) agg_product(3, x, 16, SC_Z4C, i, live, lane, s, o, sc);
    else agg_product(2, x, 16, SC_Z3C, i, live, lane, s, o, sc);
  } else if (role == AW_HASH) {
    agg_reduce_lane(sc.kes_dig, lane, x);
    agg_coef(1, SC_Z2, i, live, lane, s, o, sc);
    agg_product(1, x, 32, SC_Z2H, i, live, lane, s, o, sc);
  }
}

// last, after every role: the three cheap-check flag rows
PK_DEV void agg_flags(int i, bool live, int lane, const AggShape &s, const AggOut &o,
                      const AggScratch &sc) {
  if (!live) return;
  const int32_t *ok = sc.ok + lane;
  const int G = PK_GROUP;
  o.flags[i] = ok[OK_AE * G] & ok[OK_RE * G];
  o.flags[(size_t)s.B + i] = ok[OK_AL * G] & ok[OK_RK * G] & ok[OK_MERKLE * G];
  o.flags[(size_t)2 * s.B + i] = ok[OK_Y * G] & ok[OK_G * G] & ok[OK_U * G] & ok[OK_V * G];
}

// ---------------------------------------------------------------------------
// dedupe: a window's four repeated-key columns, each collapsed into at most
// `cap` slots by its exact 32-byte key and reduced mod L, and the window's
// B row (ops/pk/aggregate.py: window_tables). A block a tile of DD_TILE
// lanes of one column; the tiles' lists of distinct keys merge up a tree
// of tickets (a node's last child to finish merges it; keys and lane
// counts only); the block that completes a column's root ranks every
// tile's groups in it, sums their bytes into the slots and finishes them;
// the last tile of columns 0-2 to finish reduces the B row. The block
// body (dd_block) is written once: on the card each thread runs it; on
// the host (PK_HOST) one call runs a whole block, each DD_EACH over the
// threads in turn, and DD_SYNC is a barrier only on the card, so what a
// thread carries across a barrier lives in DedupeSmem.
// ---------------------------------------------------------------------------

#define DD_TILE 256                // lanes a tile, threads a block
#define DD_KEYS 4                  // key columns a window
#define DD_BROWS 3                 // the B coefficient's rows a lane
#define DD_MAXN (1 << 22)          // lanes a column (a slot's byte sums stay below 2^30)
#define DD_MAXCAP DD_TILE          // slots a column (a thread a slot)
#define DD_FAN 4                   // children of a merge node, searched at once
#define DD_LEVELS 8                // tree levels, the tiles' included
#define DD_STAGE (5 * DD_TILE)     // keys a merge stages in shared memory (40 KB)

#ifdef PK_HOST
#define DD_HD static inline
#define DD_EACH(i) for (int i = 0; i < DD_TILE; i++)
#define DD_SYNC() ((void)0)
#define DD_FENCE() ((void)0)
#define DD_LD32(p) (*(const u32 *)(p))
static inline void pk_atomic_add64(u64 *p, u64 v) { *p += v; }
#else
#define DD_HD __host__ __device__ inline  // the launcher calls these too
#define DD_EACH(i) for (int i = threadIdx.x, dd_once = 0; dd_once < 1; dd_once++)
#define DD_SYNC() __syncthreads()
#define DD_FENCE() __threadfence()
// what other blocks wrote is read from L2 (an SM's L1 may hold a line of
// the same address from an earlier level)
#define DD_LD32(p) ((u32)__ldcg((const unsigned int *)(p)))
PK_DEV void pk_atomic_add64(u64 *p, u64 v) {
  atomicAdd((unsigned long long *)p, (unsigned long long)v);
}
#endif

// the lanes a tree of `levels` levels reaches (the tiles' the first)
DD_HD constexpr long long dd_reach(int levels) {
  return levels <= 1 ? DD_TILE : DD_FAN * dd_reach(levels - 1);
}
static_assert(dd_reach(DD_LEVELS) >= DD_MAXN, "DD_LEVELS: the root of the widest column");
// a column within its cap stages all its merges' keys
static_assert(DD_FAN * DD_MAXCAP <= DD_STAGE, "DD_STAGE");

// an entry's key (4 words), meta (4) and sums (32) from L2, 16 bytes a
// load on the card, so that a row's loads are in flight together
PK_DEV void dd_ld_key(const u64 *e, u64 *k) {
#ifdef PK_HOST
  for (int w = 0; w < 4; w++) k[w] = e[w];
#else
  ulonglong2 x = __ldcg((const ulonglong2 *)e), y = __ldcg((const ulonglong2 *)e + 1);
  k[0] = x.x; k[1] = x.y; k[2] = y.x; k[3] = y.y;
#endif
}

PK_DEV void dd_ld_words(const u32 *e, u32 *x, int n) {  // n a multiple of 4
#ifdef PK_HOST
  for (int q = 0; q < n; q++) x[q] = e[q];
#else
  for (int q = 0; q < n; q += 4) {
    uint4 v = __ldcg((const uint4 *)(e + q));
    x[q] = v.x; x[q + 1] = v.y; x[q + 2] = v.z; x[q + 3] = v.w;
  }
#endif
}

// a key from shared memory, 16 bytes a load on the card
PK_DEV void dd_smem_key(const u64 *e, u64 *k) {
#ifdef PK_HOST
  for (int w = 0; w < 4; w++) k[w] = e[w];
#else
  ulonglong2 x = ((const ulonglong2 *)e)[0], y = ((const ulonglong2 *)e)[1];
  k[0] = x.x; k[1] = x.y; k[2] = y.x; k[3] = y.y;
#endif
}

PK_DEV bool dd_key_lt(const u64 *y, const u64 *x) {
  return y[0] < x[0] ||
         (y[0] == x[0] && (y[1] < x[1] || (y[1] == x[1] && (y[2] < x[2] ||
                                                            (y[2] == x[2] && y[3] < x[3])))));
}

PK_DEV bool dd_key_eq(const u64 *y, const u64 *x) {
  return y[0] == x[0] && y[1] == x[1] && y[2] == x[2] && y[3] == x[3];
}

// the instrument build (dedupe_stamps.cu): thread 0 stamps the global
// timer (ns; one clock for every SM, where clock64 is an SM's own) after a
// phase's barrier into [block][DD_NSTAMP]
#define DD_NSTAMP 16
#ifdef DD_STAMPS
PK_DEV long long dd_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DD_STAMP(k)                                                          \
  do {                                                                       \
    __syncthreads();                                                         \
    if (threadIdx.x == 0) a.stamps[blockIdx.x * DD_NSTAMP + (k)] = dd_now(); \
  } while (0)
#else
#define DD_STAMP(k) ((void)0)
#endif

struct DedupeArgs {
  int B, cap, T;                  // lanes, slots a column, tiles a column
  const int32_t *key[DD_KEYS];    // [32][B] bytes, lane-minor
  const u8 *coeff;                // [DD_KEYS][B][32]
  const int32_t *pts;             // [DD_KEYS][B][40]
  const u8 *brows;                // [DD_BROWS][B][32]
  // scratch: NE = T * DD_TILE entries a column and buffer; a list sits
  // at its node's first lane, the tiles' in buffer 0, level h's in buffer
  // 1 + (h - 1) % 2
  u64 *lkey;                      // [3][DD_KEYS][NE][4]: big-endian words
  u32 *lmeta;                     // [3][DD_KEYS][NE][4]: lanes, lanes below, first lane, -
  u32 *lsum;                      // [DD_KEYS][NE][32]: the tiles' groups' byte sums
  u32 *flag;                      // [DD_KEYS][NE]: a merge's first-of-key flags, then ranks
  u32 *bpart;                     // [DD_BROWS][T][32]: the tiles' B row sums
  int *size;                      // [DD_KEYS][DD_LEVELS][T]: each node's list length
  int *ticket;                    // [DD_KEYS][DD_LEVELS][T] and one: zero between launches
  u8 *red;                        // [DD_KEYS * cap + 1][32]: the slots mod L, the B row last
  int32_t *tpts;                  // [DD_KEYS * cap][40]
  u8 *ok;                         // [DD_KEYS]
#ifdef DD_STAMPS
  long long *stamps;
#endif
};

DD_HD bool dd_shape_ok(int B, int cap) {
  return B >= 1 && B <= DD_MAXN && cap >= 1 && cap <= DD_MAXCAP;
}

DD_HD int dd_tiles(int B) { return (B + DD_TILE - 1) / DD_TILE; }

DD_HD size_t dd_scratch_bytes(int T) {
  size_t ne = (size_t)T * DD_TILE;
  return ne * (3 * DD_KEYS * (32 + 16) + DD_KEYS * (128 + 4)) +
         (size_t)T * (DD_BROWS * 128 + DD_KEYS * DD_LEVELS * 4);
}

DD_HD int dd_ticket_count(int T) { return DD_KEYS * DD_LEVELS * T + 1; }

DD_HD DedupeArgs dd_args(int B, int cap, const void *const *keys, const void *coeffs,
                         const void *pts, const void *brows, void *scratch, void *tickets,
                         void *red, void *tpts, void *ok) {
  DedupeArgs a;
  a.B = B; a.cap = cap; a.T = dd_tiles(B);
  for (int c = 0; c < DD_KEYS; c++) a.key[c] = (const int32_t *)keys[c];
  a.coeff = (const u8 *)coeffs; a.pts = (const int32_t *)pts; a.brows = (const u8 *)brows;
  size_t ne = (size_t)a.T * DD_TILE;
  u8 *p = (u8 *)scratch;
  a.lkey = (u64 *)p; p += 3 * DD_KEYS * ne * 32;
  a.lmeta = (u32 *)p; p += 3 * DD_KEYS * ne * 16;
  a.lsum = (u32 *)p; p += DD_KEYS * ne * 128;
  a.flag = (u32 *)p; p += DD_KEYS * ne * 4;
  a.bpart = (u32 *)p; p += (size_t)DD_BROWS * a.T * 128;
  a.size = (int *)p;
  a.ticket = (int *)tickets;
  a.red = (u8 *)red; a.tpts = (int32_t *)tpts; a.ok = (u8 *)ok;
  return a;
}

struct DedupeSmem {
  // rows 0 .. DD_TILE - 1: the tile's keys as big-endian words, at the
  // root its first keys; the rest (DD_GS): the tile's group byte sums, at
  // the root the slots'; all of it: a merge's staged keys
  alignas(16) u64 kw[DD_STAGE][4];
  int below[DD_TILE];    // a lane's tile lanes with smaller keys
  int cnt[DD_TILE];      // a lane's tile lanes with its key
  int grp[DD_TILE];      // a lane's group rank in the tile
  int lead[DD_TILE];     // the lowest lane of its key; a scan's own values
  int sc[DD_TILE];       // a block scan's values, then their exclusive sums
  int part[DD_TILE / 32];
  int bp[32];            // the tile's B row byte sums
  int cs[DD_FAN + 1];    // a merge's children's list offsets
  int tot, last, carry, lane, gstar;
  u64 obelow;            // an overflow slot's starts summed
  u64 bsum[32];          // the B row's byte columns
};
// under the 48 KB of static shared memory a block may declare
static_assert(sizeof(DedupeSmem) <= 48 * 1024, "DedupeSmem");
#define DD_GS(s) ((int(*)[32])(s).kw[DD_TILE])

#ifdef PK_HOST
// exclusive scan of sc in place, the total in tot
static void dd_block_scan(DedupeSmem &s) {
  int r = 0;
  for (int i = 0; i < DD_TILE; i++) {
    int v = s.sc[i];
    s.sc[i] = r;
    r += v;
  }
  s.tot = r;
}
#else
__device__ void dd_block_scan(DedupeSmem &s) {
  int i = threadIdx.x, lane = i & 31, w = i >> 5, v = s.sc[i], x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s.part[w] = x;
  __syncthreads();
  if (w == 0) {
    int p = lane < DD_TILE / 32 ? s.part[lane] : 0, z = p;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    if (lane < DD_TILE / 32) s.part[lane] = z - p;
    if (lane == DD_TILE / 32 - 1) s.tot = z;
  }
  __syncthreads();
  s.sc[i] = s.part[w] + x - v;
  __syncthreads();
}
#endif

// a node's list: its entries' keys and meta rows
struct DdList { u64 *key; u32 *meta; };

// level h's list of column c at entry off
PK_DEV DdList dd_list(const DedupeArgs &a, int h, int c, size_t off) {
  int buf = h == 0 ? 0 : 1 + (h - 1) % 2;
  size_t base = ((size_t)buf * DD_KEYS + c) * a.T * DD_TILE + off;
  return DdList{a.lkey + base * 4, a.lmeta + base * 4};
}

// tile t of column c's groups' byte sums
PK_DEV u32 *dd_tile_sums_at(const DedupeArgs &a, int c, int t) {
  return a.lsum + ((size_t)c * a.T + t) * DD_TILE * 32;
}

PK_DEV int dd_idx(const DedupeArgs &a, int c, int h, int m) {
  return (c * DD_LEVELS + h) * a.T + m;
}

// lanes from l0, at most n
PK_DEV int dd_lanes(const DedupeArgs &a, size_t l0, size_t n) {
  size_t r = (size_t)a.B - l0;
  return (int)(r < n ? r : n);
}

// lane l's key as four big-endian words: their unsigned order is the
// bytes' lexicographic order
PK_DEV void dd_key_words(const int32_t *key, int B, int l, u64 *w) {
  for (int q = 0; q < 4; q++) {
    u64 v = 0;
    for (int j = 0; j < 8; j++) v = (v << 8) | (u8)key[(size_t)(8 * q + j) * B + l];
    w[q] = v;
  }
}

// the last of n arrivals at a ticket sees true and resets it
PK_DEV bool dd_arrive(int *ticket, int n) {
  if (pk_atomic_add(ticket, 1) != n - 1) return false;
  *ticket = 0;
  return true;
}

// a row of column sums (each < 2^31, the value < 2^512) -> 32 bytes of
// the value mod L: the carry into eight words, then sc_reduce_words
PK_DEV void agg_table_row(const u64 *cols, u8 *out) {
  u64 x[8] = {0, 0, 0, 0, 0, 0, 0, 0}, c = 0;
#pragma unroll
  for (int i = 0; i < 64; i++) {
    u64 v = c + (i < 32 ? cols[i] : 0);
    x[i >> 3] |= (v & 255) << (8 * (i & 7));
    c = v >> 8;
  }
  sc_reduce_words(x, out);
}

// ---- the tile: lanes l0 .. l0 + n - 1 of column c --------------------------

PK_DEV void dd_tile_load(int i, int c, int l0, int n, const DedupeArgs &a, DedupeSmem &s) {
  s.sc[i] = 0;
  if (i < 32) s.bp[i] = 0;
  if (i < n) dd_key_words(a.key[c], a.B, l0 + i, s.kw[i]);
}

// lane i against every lane of the tile (broadcast reads, no barrier
// between them): its lanes below and equal, and whether it is its key's
// lowest lane; a leader marks its sorted position (a warp's of more than
// 8 keys: dd_tile_rank_warp)
PK_DEV void dd_tile_rank(int i, int n, DedupeSmem &s) {
  u64 x[4];
  dd_smem_key(s.kw[i], x);
  int less = 0, eq = 0;
  bool before = false;
#pragma unroll 4
  for (int j = 0; j < n; j++) {
    u64 y[4];
    dd_smem_key(s.kw[j], y);
    bool same = dd_key_eq(y, x);
    less += dd_key_lt(y, x);
    eq += same;
    before = before || (same && j < i);
  }
  s.below[i] = less;
  s.cnt[i] = eq;
  s.lead[i] = !before;
  if (!before) s.sc[less] = 1;
}

#ifndef PK_HOST
// dd_tile_rank on the card, a warp at a time: the warp's distinct keys
// (__match_any_sync on each word) in turn, each compared with the tile's
// lanes 32 at a time (8 a lane) and the counts summed over the warp, so a
// warp of one key makes 8 comparisons a lane, not 256; a warp of more
// than 8 keys runs dd_tile_rank
__device__ void dd_tile_rank_warp(int i, int n, DedupeSmem &s) {
  const unsigned all = 0xffffffffu;
  const int lane = i & 31, w0 = i - lane;
  const bool live = i < n;
  u64 x[4] = {0, 0, 0, 0};
  if (live) dd_smem_key(s.kw[i], x);
  unsigned peers = __match_any_sync(all, x[0]) & __match_any_sync(all, x[1]) &
                   __match_any_sync(all, x[2]) & __match_any_sync(all, x[3]) &
                   __ballot_sync(all, live);
  if (!live) peers = 0;
  unsigned reps = __ballot_sync(all, live && __ffs(peers) - 1 == lane);
  if (__popc(reps) > 8) {  // many keys: a lane's own 256 comparisons cost less
    if (live) dd_tile_rank(i, n, s);
    return;
  }
  int less = 0, eq = 0;
  bool before = false;
  while (reps) {
    const int r = __ffs(reps) - 1;
    reps &= reps - 1;
    u64 y[4];
    for (int w = 0; w < 4; w++) y[w] = __shfl_sync(all, x[w], r);
    int cl = 0, ce = 0;
    bool cb = false;
    for (int j = lane; j < n; j += 32) {
      u64 z[4];
      dd_smem_key(s.kw[j], z);
      bool same = dd_key_eq(z, y);
      cl += dd_key_lt(z, y);
      ce += same;
      cb = cb || (same && j < w0 + r);
    }
    cl = __reduce_add_sync(all, cl);
    ce = __reduce_add_sync(all, ce);
    cb = __any_sync(all, cb);
    if (peers >> r & 1) {
      less = cl;
      eq = ce;
      before = lane != r || cb;
    }
  }
  if (!live) return;
  s.below[i] = less;
  s.cnt[i] = eq;
  s.lead[i] = !before;
  if (!before) s.sc[less] = 1;
}
#else
// dd_tile_rank_warp on the host for warp w: each step over the warp's 32
// lanes in turn, the match, ballot and shuffles over arrays, the sums
// over the lanes' strided comparisons in one loop
static void dd_tile_rank_warp(int w, int n, DedupeSmem &s) {
  const int w0 = 32 * w;
  u64 x[32][4];
  bool live[32];
  for (int l = 0; l < 32; l++) {
    live[l] = w0 + l < n;
    for (int q = 0; q < 4; q++) x[l][q] = 0;
    if (live[l]) dd_smem_key(s.kw[w0 + l], x[l]);
  }
  unsigned peers[32], reps = 0;
  for (int l = 0; l < 32; l++) {
    peers[l] = 0;
    for (int m = 0; m < 32; m++)
      if (live[l] && live[m] && dd_key_eq(x[m], x[l])) peers[l] |= 1u << m;
    if (live[l] && (peers[l] & (1u << l)) && !(peers[l] & ((1u << l) - 1))) reps |= 1u << l;
  }
  if (__builtin_popcount(reps) > 8) {
    for (int l = 0; l < 32; l++)
      if (live[l]) dd_tile_rank(w0 + l, n, s);
    return;
  }
  int less[32] = {0}, eq[32] = {0};
  bool before[32] = {false};
  while (reps) {
    const int r = __builtin_ctz(reps);
    reps &= reps - 1;
    int cl = 0, ce = 0;
    bool cb = false;
    for (int j = 0; j < n; j++) {
      bool same = dd_key_eq(s.kw[j], x[r]);
      cl += dd_key_lt(s.kw[j], x[r]);
      ce += same;
      cb = cb || (same && j < w0 + r);
    }
    for (int l = 0; l < 32; l++)
      if (peers[l] >> r & 1) {
        less[l] = cl;
        eq[l] = ce;
        before[l] = l != r || cb;
      }
  }
  for (int l = 0; l < 32; l++) {
    if (!live[l]) continue;
    const int i = w0 + l;
    s.below[i] = less[l];
    s.cnt[i] = eq[l];
    s.lead[i] = !before[l];
    if (!before[l]) s.sc[less[l]] = 1;
  }
}
#endif

// warp w, lane k = coefficient byte k, over the warp's 32 lanes of the
// tile: runs of one group summed, each run added to its group's sum
PK_DEV void dd_tile_sums(int w, int k, int n, const u8 *coeff, DedupeSmem &s) {
  int lo = 32 * w, hi = lo + 32 < n ? lo + 32 : n;
  int g0 = -1, run = 0;
  for (int j0 = lo; j0 < hi; j0 += 16) {
    int val[16];  // the batch's loads first, so they are in flight together
    for (int u = 0; u < 16; u++) val[u] = j0 + u < hi ? coeff[(size_t)(j0 + u) * 32 + k] : 0;
    for (int u = 0; u < 16 && j0 + u < hi; u++) {
      int g = s.grp[j0 + u];
      if (g != g0) {
        if (g0 >= 0) pk_atomic_add(&DD_GS(s)[g0][k], run);
        g0 = g;
        run = 0;
      }
      run += val[u];
    }
  }
  if (g0 >= 0) pk_atomic_add(&DD_GS(s)[g0][k], run);
}

// the tile's n rows of 32 bytes as words: thread i sums bytes
// 4 (i & 7) .. + 3 of every DD_TILE-th word from i
PK_DEV void dd_tile_brow(int i, int n, const u32 *rows, DedupeSmem &s) {
  int sum[4] = {0, 0, 0, 0};
  for (int q = i; q < n * 8; q += DD_TILE) {
    u32 v = rows[q];
    for (int b = 0; b < 4; b++) sum[b] += (v >> (8 * b)) & 255;
  }
  for (int b = 0; b < 4; b++)
    if (sum[b]) pk_atomic_add(&s.bp[4 * (i & 7) + b], sum[b]);
}

// the tile's list at its first lane: a leader writes its group's key and
// meta at its rank, the threads the sums; its length and its B row sums
PK_DEV void dd_tile_store(int i, int n, int c, int t, const DedupeArgs &a,
                          const DedupeSmem &s) {
  DdList o = dd_list(a, 0, c, (size_t)t * DD_TILE);
  u32 *sum = dd_tile_sums_at(a, c, t);
  if (i < n && s.lead[i]) {
    size_t r = s.grp[i];
    for (int w = 0; w < 4; w++) o.key[4 * r + w] = s.kw[i][w];
    o.meta[4 * r] = s.cnt[i];
    o.meta[4 * r + 1] = s.below[i];
    o.meta[4 * r + 2] = t * DD_TILE + i;
  }
  for (int q = i; q < s.tot * 32; q += DD_TILE) sum[q] = DD_GS(s)[q >> 5][q & 31];
  if (c < DD_BROWS && i < 32) a.bpart[((size_t)c * a.T + t) * 32 + i] = s.bp[i];
  if (i == 0) a.size[dd_idx(a, c, 0, t)] = s.tot;
}

// ---- a merge node: its children's sorted lists into one ---------------------

// child u of a node whose children (level h - 1, spanc tiles each) start at cm0
PK_DEV DdList dd_child(const DedupeArgs &a, int c, int h, int cm0, int u, int spanc) {
  return dd_list(a, h - 1, c, (size_t)(cm0 + u) * spanc * DD_TILE);
}

// entry q of child v (v's list in L2, or staged: at row cs[v] + q)
PK_DEV void dd_child_key(const DedupeArgs &a, const DedupeSmem &s, bool staged, int c, int h,
                         int cm0, int spanc, int v, size_t q, u64 *k) {
  if (staged) dd_smem_key(s.kw[s.cs[v] + q], k);
  else dd_ld_key(dd_child(a, c, h, cm0, v, spanc).key + 4 * q, k);
}

// key k's lower bounds in the node's nch children, the binary searches in
// step with each other (their loads in flight together)
PK_DEV void dd_lower_bounds(const DedupeArgs &a, int c, int h, int cm0, int spanc,
                            const DedupeSmem &s, bool staged, int nch, const u64 *k, int *pos) {
  int len[DD_FAN];
#pragma unroll
  for (int v = 0; v < DD_FAN; v++) {
    pos[v] = 0;
    len[v] = v < nch ? s.cs[v + 1] - s.cs[v] : 0;
  }
  for (;;) {
    bool more = false;
    u64 y[DD_FAN][4];
#pragma unroll
    for (int v = 0; v < DD_FAN; v++)
      if (len[v] > 0) {
        more = true;
        dd_child_key(a, s, staged, c, h, cm0, spanc, v, pos[v] + len[v] / 2, y[v]);
      }
    if (!more) break;
#pragma unroll
    for (int v = 0; v < DD_FAN; v++)
      if (len[v] > 0) {
        int half = len[v] / 2;
        if (dd_key_lt(y[v], k)) {
          pos[v] += half + 1;
          len[v] -= half + 1;
        } else {
          len[v] = half;
        }
      }
  }
}

// entry e of the children's lists (child u's j-th): its place among all
// the children's entries (those below its key, then its key's entries in
// earlier children) and whether it is its key's first, by its lower bound
// in every other child (in shared memory where the merge staged the
// keys). The first writes the merged entry at
// its place (the lanes with its key, the lanes below it in all the
// children, its lowest lane), and flags it.
PK_NOINLINE void dd_merge_entry(int e, int c, int h, int cm0, int nch, int spanc, bool staged,
                                const DedupeArgs &a, const DedupeSmem &s, const DdList &out,
                                size_t fo) {
  int u = 0;
  while (u + 1 < nch && s.cs[u + 1] <= e) u++;
  const size_t j = e - s.cs[u];
  u64 k[4];
  u32 m[4];
  dd_child_key(a, s, staged, c, h, cm0, spanc, u, j, k);
  dd_ld_words(dd_child(a, c, h, cm0, u, spanc).meta + 4 * j, m, 4);
  u32 cnt = m[0], ll = m[1];
  int place = (int)j, before = 0;
  int pos[DD_FAN];
  dd_lower_bounds(a, c, h, cm0, spanc, s, staged, nch, k, pos);
  u32 ym[DD_FAN][4];
  bool hit[DD_FAN];
#pragma unroll
  for (int v = 0; v < DD_FAN; v++) {
    hit[v] = v < nch && v != u && pos[v] < s.cs[v + 1] - s.cs[v];
    if (hit[v]) dd_ld_words(dd_child(a, c, h, cm0, v, spanc).meta + 4 * (size_t)pos[v], ym[v], 4);
  }
#pragma unroll
  for (int v = 0; v < DD_FAN; v++) {
    if (v >= nch || v == u) continue;
    place += pos[v];
    if (!hit[v]) {  // every entry of child v is below k
      ll += dd_lanes(a, (size_t)(cm0 + v) * spanc * DD_TILE, (size_t)spanc * DD_TILE);
      continue;
    }
    ll += ym[v][1];
    u64 y[4];
    dd_child_key(a, s, staged, c, h, cm0, spanc, v, pos[v], y);
    if (!dd_key_eq(y, k)) continue;
    if (v < u) before++;
    else cnt += ym[v][0];  // used only if this entry is its key's first
  }
  place += before;
  a.flag[fo + place] = before == 0;
  if (before) return;
  for (int w = 0; w < 4; w++) out.key[4 * (size_t)place + w] = k[w];
  out.meta[4 * (size_t)place] = cnt;
  out.meta[4 * (size_t)place + 1] = ll;
  out.meta[4 * (size_t)place + 2] = m[2];
}

struct DdRec { u64 key[4]; u32 meta[4]; int dst; };

#ifdef PK_HOST
#define DD_PRIVATE(T, x) static T x##_v[DD_TILE]
#define DD_OWN(x, i) x##_v[i]
#else
#define DD_PRIVATE(T, x) T x##_v
#define DD_OWN(x, i) x##_v
#endif

// level h's node m of column c from its children (spanc tiles each): the
// merged entries at their places, an exclusive scan of the first-of-key
// flags (rank << 1 | flag), then the firsts moved down to their ranks a
// chunk at a time (each chunk read before it is written: a rank is never
// above its place). -> the node's list length
PK_DEV int dd_merge(int c, int h, int m, int spanc, const DedupeArgs &a, DedupeSmem &s) {
  int cm0 = m * DD_FAN, nodes = (a.T + spanc - 1) / spanc;
  int nch = nodes - cm0 < DD_FAN ? nodes - cm0 : DD_FAN;
  DD_EACH(i) if (i < nch) s.cs[i + 1] = (int)DD_LD32(a.size + dd_idx(a, c, h - 1, cm0 + i));
  DD_SYNC();
  DD_EACH(i) if (i == 0) {
    s.cs[0] = 0;
    for (int u = 0; u < nch; u++) s.cs[u + 1] += s.cs[u];
    s.carry = 0;
  }
  DD_SYNC();
  DD_STAMP(10);
  const int D = s.cs[nch];
  const size_t off = (size_t)cm0 * spanc * DD_TILE, fo = (size_t)c * a.T * DD_TILE + off;
  const DdList out = dd_list(a, h, c, off);
  // the children's keys into shared memory, where they fit: always while
  // the column's keys are within the cap (a list then holds at most cap
  // keys, and DD_FAN · cap <= DD_STAGE); an overflowing column's merges may
  // search its lists in L2
  const bool staged = D <= DD_STAGE;
  if (staged) {
    DD_EACH(i) for (int e = i; e < D; e += DD_TILE) {
      int u = 0;
      while (u + 1 < nch && s.cs[u + 1] <= e) u++;
      dd_ld_key(dd_child(a, c, h, cm0, u, spanc).key + 4 * (size_t)(e - s.cs[u]), s.kw[e]);
    }
    DD_SYNC();
  }
  DD_STAMP(11);
  DD_EACH(i) for (int e = i; e < D; e += DD_TILE)
    dd_merge_entry(e, c, h, cm0, nch, spanc, staged, a, s, out, fo);
  DD_SYNC();
  DD_STAMP(12);
  for (int base = 0; base < D; base += DD_TILE) {
    DD_EACH(i) {
      int f = base + i < D ? (int)DD_LD32(a.flag + fo + base + i) : 0;
      s.sc[i] = f;
      s.lead[i] = f;
    }
    DD_SYNC();
    dd_block_scan(s);
    DD_EACH(i) if (base + i < D)
      a.flag[fo + base + i] = ((u32)(s.carry + s.sc[i]) << 1) | (u32)s.lead[i];
    DD_SYNC();
    DD_EACH(i) if (i == 0) s.carry += s.tot;
    DD_SYNC();
  }
  const int G = s.carry;
  DD_STAMP(13);
  if (G < D) {
    DD_PRIVATE(DdRec, rec);
    for (int base = 0; base < D; base += DD_TILE) {
      DD_EACH(i) {
        DdRec &r = DD_OWN(rec, i);
        size_t q = base + i;
        u32 f = q < (size_t)D ? DD_LD32(a.flag + fo + q) : 0;
        r.dst = (f & 1) && (f >> 1) != q ? (int)(f >> 1) : -1;
        if (r.dst >= 0) {
          dd_ld_key(out.key + 4 * q, r.key);
          dd_ld_words(out.meta + 4 * q, r.meta, 4);
        }
      }
      DD_SYNC();
      DD_EACH(i) {
        const DdRec &r = DD_OWN(rec, i);
        if (r.dst >= 0) {
          size_t d = r.dst;
          for (int w = 0; w < 4; w++) out.key[4 * d + w] = r.key[w];
          for (int k = 0; k < 3; k++) out.meta[4 * d + k] = r.meta[k];
        }
      }
      DD_SYNC();
    }
  }
  DD_STAMP(14);
  DD_EACH(i) if (i == 0) a.size[dd_idx(a, c, h, m)] = G;
  return G;
}

// ---- the root: a column's G distinct keys in order -------------------------

// the root's first min(G, cap) keys into rows 0 .. of kw, the slots' sums
// (DD_GS) zeroed
PK_DEV void dd_root_stage(int i, const DdList &root, int G, const DedupeArgs &a, DedupeSmem &s) {
  const int n = G < a.cap ? G : a.cap;
  if (i < n) dd_ld_key(root.key + 4 * (size_t)i, s.kw[i]);
  for (int q = i; q < a.cap * 32; q += DD_TILE) DD_GS(s)[q >> 5][q & 31] = 0;
}

// warp w, lane l: the groups of tiles w, w + 8, ... of column c, each
// ranked in the root's staged keys (a group past them, or at rank
// cap - 1 or beyond, falls in the last slot), its byte sums added to its
// slot's
PK_DEV void dd_gather(int w, int l, int c, int G, const DedupeArgs &a, DedupeSmem &s) {
  const int n = G < a.cap ? G : a.cap;
  for (int t = w; t < a.T; t += DD_TILE / 32) {
    const int d = (int)DD_LD32(a.size + dd_idx(a, c, 0, t));
    const DdList tl = dd_list(a, 0, c, (size_t)t * DD_TILE);
    const u32 *sums = dd_tile_sums_at(a, c, t);
    for (int q = l; q < d; q += 32) {
      u64 k[4];
      u32 x[32];
      dd_ld_key(tl.key + 4 * (size_t)q, k);
      dd_ld_words(sums + 32 * (size_t)q, x, 32);
      int lo = 0, len = n;
      while (len > 0) {
        int half = len / 2;
        u64 y[4];
        dd_smem_key(s.kw[lo + half], y);
        if (dd_key_lt(y, k)) {
          lo += half + 1;
          len -= half + 1;
        } else {
          len = half;
        }
      }
      const int sl = lo < a.cap - 1 ? lo : a.cap - 1;
      for (int k2 = 0; k2 < 32; k2++)
        if (x[k2]) pk_atomic_add(&DD_GS(s)[sl][k2], (int)x[k2]);
    }
  }
}

// slot sl (< cap) of column c: its sums mod L; its point, its group's
// lowest lane (an unused slot takes sorted position 0's, group 0's
// lowest; the last slot under overflow the block's lane). A row of zero
// sums is 0 mod L without the reduction.
PK_DEV void dd_finish_slot(int sl, int c, const DdList &root, int G, const DedupeArgs &a,
                           const DedupeSmem &s) {
  int lane;
  if (G > a.cap && sl == a.cap - 1) lane = s.lane;
  else lane = (int)DD_LD32(root.meta + 4 * (size_t)(sl < G ? sl : 0) + 2);
  // the point first: its loads in flight beside the reduction
  const int32_t *p = a.pts + ((size_t)c * a.B + lane) * 40;
  int32_t *o = a.tpts + ((size_t)c * a.cap + sl) * 40;
#ifdef PK_HOST
  for (int k = 0; k < 40; k++) o[k] = p[k];
#else
  int4 pv[10];
  for (int k = 0; k < 10; k++) pv[k] = ((const int4 *)p)[k];
#endif
  u8 *row = a.red + ((size_t)c * a.cap + sl) * 32;
  u64 cols[32];
  u32 any = 0;
#pragma unroll
  for (int k = 0; k < 32; k++) {
    cols[k] = (u32)DD_GS(s)[sl][k];
    any |= (u32)cols[k];
  }
  if (any) {
    agg_table_row(cols, row);
  } else {
    for (int k = 0; k < 32; k++) row[k] = 0;
  }
#ifndef PK_HOST
  for (int k = 0; k < 10; k++) ((int4 *)o)[k] = pv[k];
#endif
}

// past the cap the last slot's lane is the one at sorted position
// min(the starts of groups cap - 1 on summed, B - 1), as the reference's:
// the group holding that position, then its key's r-th lane in lane order
// (8 lanes a thread a round)
PK_DEV void dd_overflow(int c, const DdList &root, int G, const DedupeArgs &a, DedupeSmem &s) {
  DD_EACH(i) if (i == 0) {
    s.obelow = 0;
    s.lane = -1;
  }
  DD_SYNC();
  DD_EACH(i) {
    u64 starts = 0;
    for (int g = a.cap - 1 + i; g < G; g += DD_TILE) starts += DD_LD32(root.meta + 4 * (size_t)g + 1);
    if (starts) pk_atomic_add64(&s.obelow, starts);
  }
  DD_SYNC();
  DD_EACH(i) {
    u64 p = s.obelow < (u64)(a.B - 1) ? s.obelow : (u64)(a.B - 1);
    for (int g = i; g < G; g += DD_TILE) {
      u64 b = DD_LD32(root.meta + 4 * (size_t)g + 1), n = DD_LD32(root.meta + 4 * (size_t)g);
      if (b <= p && p < b + n) {
        s.gstar = g;
        s.carry = (int)(p - b);
      }
    }
  }
  DD_SYNC();
  u64 k[4];
  dd_ld_key(root.key + 4 * (size_t)s.gstar, k);
  // `per` lanes a thread a round: thread i's are base + per · i onwards
  const int per = 8;
  int seen = 0;
  for (int base = 0; base < a.B && s.lane < 0; base += per * DD_TILE) {
    DD_EACH(i) {
      int eq = 0;
      for (int l = base + per * i; l < base + per * (i + 1) && l < a.B; l++) {
        u64 x[4];
        dd_key_words(a.key[c], a.B, l, x);
        eq += dd_key_eq(x, k);
      }
      s.sc[i] = eq;
      s.lead[i] = eq;
    }
    DD_SYNC();
    dd_block_scan(s);
    DD_EACH(i) {
      int r = s.carry - seen - s.sc[i];  // the wanted lane's rank among this thread's
      if (s.lead[i] && r >= 0 && r < s.lead[i])
        for (int l = base + per * i; l < base + per * (i + 1) && l < a.B; l++) {
          u64 x[4];
          dd_key_words(a.key[c], a.B, l, x);
          if (dd_key_eq(x, k) && r-- == 0) s.lane = l;
        }
    }
    seen += s.tot;
    DD_SYNC();
  }
}

// ---- a block: a tile, the merges it completes, a root, the B row -----------

PK_DEV void dd_block(int blk, const DedupeArgs &a, DedupeSmem &s) {
  const int c = blk % DD_KEYS, t = blk / DD_KEYS, l0 = t * DD_TILE;
  const int n = dd_lanes(a, l0, DD_TILE);
  DD_STAMP(0);
  DD_EACH(i) dd_tile_load(i, c, l0, n, a, s);
  DD_SYNC();
  DD_STAMP(1);
#ifdef PK_HOST
  for (int w = 0; w < DD_TILE / 32; w++) dd_tile_rank_warp(w, n, s);
#else
  dd_tile_rank_warp(threadIdx.x, n, s);
#endif
  DD_SYNC();
  DD_STAMP(2);
  dd_block_scan(s);  // the leaders' ranks at their sorted positions
  DD_EACH(i) {
    if (i < n) s.grp[i] = s.sc[s.below[i]];
    for (int q = i; q < s.tot * 32; q += DD_TILE) DD_GS(s)[q >> 5][q & 31] = 0;
  }
  DD_SYNC();
  DD_STAMP(3);
  DD_EACH(i) {
    dd_tile_sums(i >> 5, i & 31, n, a.coeff + ((size_t)c * a.B + l0) * 32, s);
    if (c < DD_BROWS) dd_tile_brow(i, n, (const u32 *)(a.brows + ((size_t)c * a.B + l0) * 32), s);
  }
  DD_SYNC();
  DD_STAMP(4);
  DD_EACH(i) dd_tile_store(i, n, c, t, a, s);
  int G = s.tot, h = 0, m = t;
  DD_STAMP(5);
  // the last tile of columns 0-2 to finish: the B row, off the columns' path
  if (c < DD_BROWS) {
    DD_FENCE();
    DD_SYNC();
    DD_EACH(i) {
      if (i == 0) s.last = dd_arrive(a.ticket + DD_KEYS * DD_LEVELS * a.T, DD_BROWS * a.T);
      if (i < 32) s.bsum[i] = 0;
    }
    DD_SYNC();
    if (s.last) {
      DD_FENCE();
      DD_EACH(i) {
        u64 v = 0;
        for (int q = i >> 5; q < DD_BROWS * a.T; q += DD_TILE / 32)
          v += DD_LD32(a.bpart + (size_t)q * 32 + (i & 31));
        pk_atomic_add64(&s.bsum[i & 31], v);
      }
      DD_SYNC();
      DD_EACH(i) if (i == 0) agg_table_row(s.bsum, a.red + (size_t)DD_KEYS * a.cap * 32);
      DD_STAMP(8);
    }
  }
  // up the tree while this block completes a node: span tiles a level-h node
  for (int span = 1; span < a.T; span *= DD_FAN) {
    const int nodes = (a.T + span - 1) / span, parent = m / DD_FAN;
    const int nch = nodes - parent * DD_FAN < DD_FAN ? nodes - parent * DD_FAN : DD_FAN;
    DD_FENCE();
    DD_SYNC();
    DD_EACH(i) if (i == 0) s.last = dd_arrive(a.ticket + dd_idx(a, c, h + 1, parent), nch);
    DD_SYNC();
    if (!s.last) return;
    DD_FENCE();
    h++;
    m = parent;
    G = dd_merge(c, h, m, span, a, s);
    DD_STAMP(6);
#ifdef DD_STAMPS
    if (threadIdx.x == 0) a.stamps[blockIdx.x * DD_NSTAMP + 9] = h;  // the merges it ran
#endif
  }
  // the column's root: level h, node 0. Every tile group's sums into its
  // slot, then the slots mod L
  const DdList root = dd_list(a, h, c, 0);
  DD_EACH(i) dd_root_stage(i, root, G, a, s);
  DD_SYNC();
  DD_EACH(i) dd_gather(i >> 5, i & 31, c, G, a, s);
  DD_SYNC();
  if (G > a.cap) dd_overflow(c, root, G, a, s);
  DD_STAMP(15);
  DD_EACH(i) {
    if (i < a.cap) dd_finish_slot(i, c, root, G, a, s);
    if (i == 0) a.ok[c] = G <= a.cap;
  }
  DD_STAMP(7);
}

// ---------------------------------------------------------------------------
// msm: the shared signed-digit bucket machine (ops/pk/msm.py)
// ---------------------------------------------------------------------------

#define MSM_C 12
#define MSM_HALF 2048              // |d| <= 2^11
#define MSM_D (MSM_HALF + 1)       // buckets of a window, |d| = 0 .. 2^11
#define MSM_WMAX 32                // windows the final block holds
#define MSM_CH 16                  // entries a thread of the chunk phase sums
#define MSM_SPAN 8                 // pieces a thread of the span phase joins
#define MSM_BIG 128                // a bucket of more pieces takes a block of these
#define MSM_WIDE 3                 // tree levels a thread a node (the first two as
                                   // running sums); the rest on quads
#define MSM_JOIN (MSM_HALF >> MSM_WIDE)  // nodes a window after the wide levels

// n points, the first n_small with ws windows, the rest with ww (ws <= ww)
struct MsmShape { int n, n_small, ws, ww; };

// a point row [40] as X ‖ Y ‖ Z ‖ T; on the card 16-byte loads and stores
// (every point array is 16-byte aligned: torch's, and shared arrays
// declared so)
PK_DEV ge msm_words(const u32 *w) {
  ge p;
  for (int l = 0; l < 10; l++) {
    p.x.v[l] = w[l];
    p.y.v[l] = w[10 + l];
    p.z.v[l] = w[20 + l];
    p.t.v[l] = w[30 + l];
  }
  return p;
}

PK_DEV ge msm_load(const int32_t *pts, size_t k) {
  u32 w[40];
#ifdef PK_HOST
  for (int m = 0; m < 40; m++) w[m] = (u32)pts[k * 40 + m];
#else
  const uint4 *e = (const uint4 *)(pts + k * 40);
#pragma unroll
  for (int i = 0; i < 10; i++) {
    uint4 v = e[i];
    w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
  }
#endif
  return msm_words(w);
}

PK_DEV void msm_store(int32_t *pts, size_t k, const ge &p) {
  u32 w[40];
  for (int l = 0; l < 10; l++) {
    w[l] = p.x.v[l];
    w[10 + l] = p.y.v[l];
    w[20 + l] = p.z.v[l];
    w[30 + l] = p.t.v[l];
  }
#ifdef PK_HOST
  for (int m = 0; m < 40; m++) pts[k * 40 + m] = (int32_t)w[m];
#else
  uint4 *e = (uint4 *)(pts + k * 40);
#pragma unroll
  for (int i = 0; i < 10; i++)
    e[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
#endif
}

// bucket (window w, |d| = d >= 1) of key w · D + d in the [ww · HALF]
// bucket array
PK_DEV size_t msm_bidx(int key) {
  return (size_t)(key / MSM_D) * MSM_HALF + key % MSM_D - 1;
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
// (the sign in bit 31) at the bucket's next free place, and the bucket's
// key beside it
PK_DEV void msm_scatter(int p, const MsmShape &s, const int32_t *digits,
                        int *cursor, u32 *ent, int *ekey) {
  for (int w = 0; w < s.ww; w++) {
    int d = digits[(size_t)w * s.n + p];
    if (d == 0) continue;
    int key = w * MSM_D + (d < 0 ? -d : d);
    int pos = pk_atomic_add(&cursor[key], 1);
    ent[pos] = (u32)p | (d < 0 ? 0x80000000u : 0u);
    ekey[pos] = key;
  }
}

PK_DEV ge msm_entry(const int32_t *pts, u32 x) {
  ge p = msm_load(pts, x & 0x7FFFFFFFu);
  return (x >> 31) ? ge_neg(p) : p;
}

// the sum of one bucket's entries inside chunk t ([a, b) of the entries):
// the whole bucket into its place; a piece of a bucket begun in an
// earlier chunk into part[t]; a piece that goes on past b into tailp[t]
PK_DEV void msm_flush(int t, int key, const ge &acc, int a, int b, const int *offsets,
                      int32_t *buckets, int32_t *part, int32_t *tailp) {
  if (offsets[key] < a) msm_store(part, t, acc);
  else if (offsets[key + 1] > b) msm_store(tailp, t, acc);
  else msm_store(buckets, msm_bidx(key), acc);
}

// phase 4, a thread a chunk of MSM_CH consecutive entries (the entries
// lie bucket by bucket; offsets[m] is their count): a running sum of the
// entries of each bucket it meets, at most MSM_CH - 1 additions a thread
// whatever the buckets' sizes
PK_DEV void msm_chunk(int t, int m, const int *offsets, const u32 *ent, const int *ekey,
                      const int32_t *pts, int32_t *buckets, int32_t *part, int32_t *tailp) {
  int a = t * MSM_CH, e_n = offsets[m];
  if (a >= e_n) return;
  int b = a + MSM_CH < e_n ? a + MSM_CH : e_n;
  int key = ekey[a];
  ge acc = msm_entry(pts, ent[a]);
  for (int e = a + 1; e < b; e++) {
    int k = ekey[e];
    ge p = msm_entry(pts, ent[e]);
    if (k != key) {
      msm_flush(t, key, acc, a, b, offsets, buckets, part, tailp);
      key = k;
      acc = p;
    } else {
      acc = ge_add(acc, p);
    }
  }
  msm_flush(t, key, acc, a, b, offsets, buckets, part, tailp);
}

// phase 5, a thread a bucket key: a bucket whose entries cross chunks
// c0 < c1 is tailp[c0] + part[c0 + 1] + ... + part[c1]; at most MSM_SPAN
// pieces here, one after another; more are listed in big[1..] (big[0]
// their count) for phase 5b
PK_DEV void msm_span(int key, const int *offsets, const int32_t *part,
                     const int32_t *tailp, int32_t *buckets, int *big) {
  int lo = offsets[key], hi = offsets[key + 1];
  if (hi == lo) return;
  int c0 = lo / MSM_CH, c1 = (hi - 1) / MSM_CH;
  if (c1 == c0) return;
  if (c1 - c0 + 1 > MSM_SPAN) {
    big[1 + pk_atomic_add(big, 1)] = key;
    return;
  }
  ge acc = msm_load(tailp, c0);
  for (int c = c0 + 1; c <= c1; c++) acc = ge_add(acc, msm_load(part, c));
  msm_store(buckets, msm_bidx(key), acc);
}

// phase 5b, a block of MSM_BIG threads a listed bucket of n pieces:
// thread j sums pieces j, j + MSM_BIG, ... (piece 0 is tailp[c0], piece
// k part[c0 + k]) into tree[j] (`msm_big_partial`), then rounds of a
// tree over the threads' sums, each after a barrier (`msm_big_round`,
// half = MSM_BIG / 2 down to 1), and thread 0 stores the bucket
// (`msm_big_store`); tree holds MSM_BIG points, 40 words each
PK_DEV void msm_big_partial(int key, int j, const int *offsets, const int32_t *part,
                            const int32_t *tailp, int32_t *tree) {
  int c0 = offsets[key] / MSM_CH, n = (offsets[key + 1] - 1) / MSM_CH - c0 + 1;
  ge acc = ge_identity();
  for (int k = j; k < n; k += MSM_BIG) {
    ge v = k == 0 ? msm_load(tailp, c0) : msm_load(part, c0 + k);
    acc = k == j ? v : ge_add(acc, v);
  }
  msm_store(tree, j, acc);
}

PK_DEV void msm_big_round(int j, int half, int32_t *tree) {
  if (j < half) msm_store(tree, j, ge_add(msm_load(tree, j), msm_load(tree, j + half)));
}

PK_DEV void msm_big_store(int key, const int32_t *tree, int32_t *buckets) {
  msm_store(buckets, msm_bidx(key), msm_load(tree, 0));
}

// The weighted sums Σ_d d·B_d of a window as a tree. A range of buckets
// from a keeps W = Σ (d − a + 1)·B_d and N = n·S (n buckets, S their
// sum); a bucket alone is W = N = B_d, and two adjacent ranges of n
// buckets each join as W = W_L + W_H + N_H, N = 2·(N_L + N_H), role 0
// forming W (two additions), role 1 N (an addition and a doubling). A
// level of T nodes is [2][T][40] (W, then N), window-major, so node q's
// children are nodes 2q and 2q + 1 of the level below.

// bucket b of the [ww · HALF] array, the identity when empty
PK_DEV ge msm_leaf(int b, const int *offsets, const int32_t *buckets) {
  int key = (b / MSM_HALF) * MSM_D + b % MSM_HALF + 1;
  if (offsets[key + 1] == offsets[key]) return ge_identity();
  return msm_load(buckets, b);
}

// phase 6, a thread a node and role: the first levels by running sums,
// over buckets 4q .. 4q + 3 from the top (run = Σ B, acc = Σ run = W)
// and N = 4·run; a level of t nodes into `out`
PK_DEV void msm_leaf4(int q, int role, int t, const int *offsets, const int32_t *buckets,
                      int32_t *out) {
  ge run = msm_leaf(4 * q + 3, offsets, buckets), acc = run;
  for (int d = 2; d >= 0; d--) {
    run = ge_add(run, msm_leaf(4 * q + d, offsets, buckets));
    if (role == 0) acc = ge_add(acc, run);
  }
  if (role == 1) {
    ge_dbl(run, run, false);
    ge_dbl(acc, run, true);
  }
  msm_store(out, (size_t)role * t + q, acc);
}

// phase 6b, a later wide level, a thread a node and role: node q of a
// level of t nodes from `in` (2t nodes) into `out`
PK_DEV void msm_wide_node(int q, int role, int t, const int32_t *in, int32_t *out) {
  ge wl = msm_load(in, 2 * q), wh = msm_load(in, 2 * q + 1), r;
  ge nl = msm_load(in, (size_t)2 * t + 2 * q), nh = msm_load(in, (size_t)2 * t + 2 * q + 1);
  if (role == 0) {
    r = ge_add(ge_add(wl, wh), nh);
  } else {
    r = ge_add(nl, nh);
    ge_dbl(r, r, true);
  }
  msm_store(out, (size_t)role * t + q, r);
}

// phase 7, lane q of quad `role` (one quad the W of each node, the other
// its N): node q of a window's level from its level below, whose W nodes
// start at `iw` and N nodes at `in`
PK_DEV ge msm_join_node(int role, int q, const int32_t *iw, const int32_t *in, Quad &qd) {
  ge wl = msm_load(iw, 2 * q), wh = msm_load(iw, 2 * q + 1);
  ge nl = msm_load(in, 2 * q), nh = msm_load(in, 2 * q + 1);
  ge t1, r;
  if (role == 0) {
    qadd(qd, t1, wl, wh);
    qadd(qd, r, t1, nh);
  } else {
    qadd(qd, t1, nl, nh);
    qdbl(qd, r, t1);
  }
  return r;
}

// where window w's join level of n nodes (n < MSM_JOIN) lies in `b`: its
// W nodes, its N nodes n after them. Each window owns 2 · MSM_JOIN nodes
// of b from w · 2 · MSM_JOIN, and its levels alternate between two places
// there (level MSM_JOIN / 2 at 0, the next at MSM_JOIN, ...), so no block
// writes where another reads, and a level's writes never meet the level
// below, which it reads
PK_DEV int32_t *msm_join_level(int32_t *b, int w, int n) {
  int odd = 0;
  for (int k = MSM_JOIN / 2; k > n; k >>= 1) odd ^= 1;
  return b + ((size_t)w * 2 * MSM_JOIN + (odd ? MSM_JOIN : 0)) * 40;
}

// ---------------------------------------------------------------------------
// msm's Horner chain on one warp (the ten-lane field elements above)
// ---------------------------------------------------------------------------

struct wge { wv x, y, z, t; };

// ge_dbl: the squares of X, Y, Z in one round, (X + Y)^2 in a second,
// X3 = e·f, Y3 = g·h, Z3 = f·g in a third, T3 = e·h in a fourth when an
// addition reads it
PK_DEV void w_dbl(wge &p, bool with_t) {
  wv s = w_pick(p.x, p.y, p.z);
  s = w_mul(s, s);
  wv a = w_from(s, 0), b = w_from(s, 1), zz = w_from(s, 2);
  wv xy = w_add(p.x, p.y);
  wv c = w_add(zz, zz), h = w_add(a, b), e = w_sub(h, w_mul(xy, xy));
  wv g = w_sub(a, b), f = w_add(c, g);
  wv r = w_mul(w_pick(e, g, f), w_pick(f, h, g));
  p.x = w_from(r, 0);
  p.y = w_from(r, 1);
  p.z = w_from(r, 2);
  if (with_t) p.t = w_mul(e, h);
}

// ge_add (p + q): (Y1 − X1)(Y2 − X2), (Y1 + X1)(Y2 + X2) and T1·T2 in one
// round, Z1·Z2 and (T1·T2)·2d in a second, then the four products of
// ge_add's end in two
PK_DEV void w_add_pt(wge &p, const wge &q, const wv &d2) {
  wv r = w_mul(w_pick(w_sub(p.y, p.x), w_add(p.y, p.x), p.t),
               w_pick(w_sub(q.y, q.x), w_add(q.y, q.x), q.t));
  wv a = w_from(r, 0), b = w_from(r, 1), tt = w_from(r, 2);
  r = w_mul(w_pick(p.z, tt, tt), w_pick(q.z, d2, d2));
  wv zz = w_from(r, 0), c = w_from(r, 1);
  wv d = w_add(zz, zz), e = w_sub(b, a), f = w_sub(d, c), g = w_add(d, c), h = w_add(b, a);
  r = w_mul(w_pick(e, g, f), w_pick(f, h, g));
  p.x = w_from(r, 0);
  p.y = w_from(r, 1);
  p.z = w_from(r, 2);
  p.t = w_mul(e, h);
}

// point k of a [.][40] array, every group a copy
PK_DEV wge w_load(const int32_t *pts, size_t k) {
  wge p;
  W_LANES(l) {
    const int32_t *e = pts + k * 40 + w_limb(l);
    W_AT(p.x, l) = (u32)e[0];
    W_AT(p.y, l) = (u32)e[10];
    W_AT(p.z, l) = (u32)e[20];
    W_AT(p.t, l) = (u32)e[30];
  }
  return p;
}

// phase 8, one warp: the Horner chain over the window sums (most
// significant first, 2^12 a step; T formed only on a step's last
// doubling), plus the B term -> total [40]: the same limbs as ge_dbl /
// ge_add on one thread. The caller tests the identity on the stored limbs.
PK_DEV void msm_horner_warp(const int32_t *sums, int nw, const int32_t *bterm, int32_t *total) {
  wv d2;
  W_LANES(l) { W_AT(d2, l) = PK_D2[w_limb(l)]; }
  wge acc = w_load(sums, nw - 1);
#pragma unroll 1
  for (int w = nw - 2; w >= 0; w--) {
#pragma unroll 1
    for (int k = 0; k < MSM_C; k++) w_dbl(acc, k == MSM_C - 1);
    w_add_pt(acc, w_load(sums, w), d2);
  }
  w_add_pt(acc, w_load(bterm, 0), d2);
  W_LANES(l) {
    if (l < 10) {
      total[l] = (int32_t)W_AT(acc.x, l);
      total[10 + l] = (int32_t)W_AT(acc.y, l);
      total[20 + l] = (int32_t)W_AT(acc.z, l);
      total[30 + l] = (int32_t)W_AT(acc.t, l);
    }
  }
}

PK_DEV int msm_identity(const int32_t *total) {
  ge t = msm_load(total, 0);
  return fe_is_zero(t.x) && fe_eq(t.y, t.z) ? 1 : 0;
}
