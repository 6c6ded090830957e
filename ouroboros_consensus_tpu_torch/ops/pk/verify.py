"""The Praos verifier cores over lanes, plain PyTorch — the twins of the
six CUDA stage kernels (csrc/stages.cuh), same order of operations:

  ed_core           — Ed25519 verify-point of the OCert signature
                      (Praos.hs:580): P = s·B − h·A, compression deferred.
  kes_core          — CompactSum KES leaf verify-point + Merkle root walk
                      + period range check (Praos.hs:582).
  vrf_core_prep     — draft-03 ECVRF stage A: decode Y, Γ, check s and
                      H = 8·Elligator2(SHA-512(suite‖1‖Y‖α)); the
                      challenge is the proof's own 16 bytes.
  vrf_core_bc_prep  — batch-compatible ECVRF stage A: decode Y, Γ, check
                      s, H = 8·Elligator2(SHA-512(suite‖1‖Y‖α)), and the
                      challenge c = SHA-512(suite‖2‖H‖Γ‖U‖V)[:16] over the
                      ANNOUNCED U, V bytes.
  vrf_core_ladders  — stage B: U' = s·B − c·Y, V' = s·H − c·Γ, 8Γ.
  finish_core       — one shared inversion compresses the 7 points; the
                      R-byte compares (ed, kes), c' == c and β checks, the
                      Blake2b leader/nonce range extensions (Praos/VRF.hs
                      :103,116) and the bracketed leader-threshold compare.

Byte arrays are [n, B] (lanes last); failures are mask lanes, never
exceptions. finish's c' == c compare is the draft-03 check itself; for
a batch-compatible proof it holds iff the recomputed U', V' compress to
the announced bytes — the compare-on-bytes form of the two
batch-compatible group equations.
"""

from __future__ import annotations

import torch

from . import curve as pc
from . import field as fe
from . import hashes as ph

SUITE = 0x04
MONT_A = 486662


def _sqrt_of(x: int) -> int:
    """Host sqrt mod p (p = 5 mod 8 Shanks); x must be a square."""
    p = fe.P
    s = pow(x % p, (p + 3) // 8, p)
    if (s * s - x) % p != 0:
        s = s * pow(2, (p - 1) // 4, p) % p
    assert (s * s - x) % p == 0
    return s


# chi(2) = chi(i) = -1 for p = 2^255-19, so both 2i and -2i are squares:
# the branch-2 fix-up constants of the single-chain Elligator2
SQRT_2I = _sqrt_of(2 * fe.SQRT_M1)
SQRT_M2I = _sqrt_of(-2 * fe.SQRT_M1)
_A2 = MONT_A * MONT_A % fe.P
_C2A2 = (-486664) * _A2 % fe.P  # c² · A², c = sqrt(-486664)


def _rows(vals, b: int, device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int64, device=device).reshape(-1, 1).expand(-1, b)


def _all_eq(a, b) -> torch.Tensor:
    return (a.to(torch.int64) == b.to(torch.int64)).all(dim=0)


def ed_core(pk, s, hblocks, hnblocks):
    """(ok_pre bool[B], P) with P = s·B − h·A, h = SHA-512(R‖A‖M) mod L.
    pk, s: [32, B]; hblocks [NB, 128, B]; hnblocks [B]."""
    ok_a, a_pt = pc.decompress(pk)
    s_ok = fe.scalar_lt_l(s)
    h = fe.reduce512(ph.sha512_blocks(hblocks, hnblocks))
    sb = pc.base_mul_w8(s)
    nha = pc.scalar_mul_w4(fe.nibbles_msb(h, 32), pc.neg(a_pt))
    return ok_a & s_ok, pc.add(sb, nha)


def kes_merkle_ok(vk, period, vk_leaf, siblings, depth: int):
    """Bottom-up CompactSum root: bit i of the period puts the running
    vk on the right (H(sib ‖ vk)) or the left (H(vk ‖ sib))."""
    cur = vk_leaf.to(torch.int64)
    period = period.to(torch.int64)
    for i in range(depth):
        sib = siblings[i].to(torch.int64)
        right = ((period >> i) & 1) == 1
        data = torch.where(right.unsqueeze(0), torch.cat([sib, cur]),
                           torch.cat([cur, sib]))
        cur = ph.blake2b_fixed(data, 32)
    return _all_eq(cur, vk)


def kes_core(vk, period, s, vk_leaf, siblings, hblocks, hnblocks, depth: int):
    """(ok_pre bool[B], P): leaf Ed25519 verify-point, Merkle root, and
    0 <= period < 2^depth. period [B]; siblings [depth, 32, B]."""
    ok_ed, p = ed_core(vk_leaf, s, hblocks, hnblocks)
    root_ok = kes_merkle_ok(vk, period, vk_leaf, siblings, depth)
    period = period.to(torch.int64)
    period_ok = (period >= 0) & (period < (1 << depth))
    return ok_ed & root_ok & period_ok, p


def elligator2(r):
    """Field element -> Point (even-x convention of the host ECVRF), with
    ONE exponentiation chain: u = U/W over W = 1 + 2r², the sqrt_ratio
    candidate of num = c²A²W over N1 = -A(A² - A²W + W²) classifies both
    the branch and the root (see the JAX package's ops/pk/verify.py for
    the derivation). The point stays projective: (Y : Z) = (U−W : U+W)."""
    dev = r.device
    b = r.shape[-1]
    one = fe.ones(b, dev)
    zero = fe.zeros(b, dev)
    r2 = fe.sqr(r)
    w_den = fe.add(fe.add(r2, r2), one)
    w = fe.select(fe.is_zero(w_den), one, w_den)
    w2 = fe.sqr(w)
    a2w = fe.mul(fe.const(_A2, dev), w)
    n1 = fe.mul(fe.const(-MONT_A, dev), fe.add(fe.sub(fe.const(_A2, dev), a2w), w2))
    num1 = fe.mul(fe.const(_C2A2, dev), w)
    rho, good, good_alt, is_pi = fe.sqrt_ratio_ext(num1, n1)
    ok1 = good | good_alt | fe.is_zero(n1)
    x1 = fe.select(good, rho, fe.mul(rho, fe.const(fe.SQRT_M1, dev)))
    x2 = fe.mul(fe.mul(r, rho),
                fe.select(is_pi, fe.const(SQRT_M2I, dev), fe.const(SQRT_2I, dev)))
    x = fe.select(ok1, x1, x2)
    x = fe.select(fe.parity(x) == 1, fe.neg(x), x)
    u1 = fe.const(-MONT_A, dev).expand(fe.NL, b)
    u2 = fe.mul(fe.const(MONT_A, dev), fe.sub(one, w))
    un = fe.select(ok1, u1, u2)
    y_num = fe.sub(un, w)
    z = fe.add(un, w)
    z_zero = fe.is_zero(z)
    y_num = fe.select(z_zero, zero, y_num)
    z = fe.select(z_zero, one, z)
    return pc.Point(fe.mul(x, z), y_num, z, fe.mul(x, y_num))


def hash_to_curve(pk, alpha):
    """H = 8 · Elligator2(SHA-512(suite ‖ 1 ‖ pk ‖ alpha) mod 2^255)."""
    b = pk.shape[-1]
    data = torch.cat([_rows([SUITE, 0x01], b, pk.device),
                      pk.to(torch.int64), alpha.to(torch.int64)])
    digest = ph.sha512_fixed(data)
    r = fe.freeze(fe.from_bytes(digest[:32]))
    return pc.mul_cofactor(elligator2(r))


def vrf_core_prep(pk, gamma, s, alpha):
    """-> (ok_pre bool[B], H, Y, Γ): vrf_core_bc_prep without the
    compression of H and the challenge derivation."""
    ok_y, y_pt = pc.decompress(pk)
    ok_g, g_pt = pc.decompress(gamma)
    s_ok = fe.scalar_lt_l(s)
    h_pt = hash_to_curve(pk, alpha)
    return ok_y & ok_g & s_ok, h_pt, y_pt, g_pt


def vrf_core_bc_prep(pk, gamma, u, v, s, alpha):
    """-> (ok_pre bool[B], c16 [16, B], H, Y, Γ)."""
    ok_y, y_pt = pc.decompress(pk)
    ok_g, g_pt = pc.decompress(gamma)
    s_ok = fe.scalar_lt_l(s)
    h_pt = hash_to_curve(pk, alpha)
    (h_enc,) = pc.compress_many([h_pt])
    b = pk.shape[-1]
    cdata = torch.cat([_rows([SUITE, 0x02], b, pk.device), h_enc,
                       gamma.to(torch.int64), u.to(torch.int64),
                       v.to(torch.int64)])
    c16 = ph.sha512_fixed(cdata)[:16]
    return ok_y & ok_g & s_ok, c16, h_pt, y_pt, g_pt


def vrf_core_ladders(c16, s, h_pt, y_pt, g_pt):
    """-> (H, Γ, U', V', 8Γ): U' = s·B − c·Y, V' = s·H − c·Γ."""
    s_digits = fe.nibbles_msb(s, 32)
    c_digits = fe.nibbles_msb(c16, 16)
    sb = pc.base_mul_w8(s)
    u_pt = pc.add(sb, pc.scalar_mul_w4(c_digits, pc.neg(y_pt)))
    v_pt = pc.double_scalar_mul_w4(s_digits, h_pt, c_digits, pc.neg(g_pt))
    return h_pt, g_pt, u_pt, v_pt, pc.mul_cofactor(g_pt)


def _lt_be(a, b):
    """Big-endian lexicographic a < b over [32, B] byte arrays -> bool[B]."""
    lt = torch.zeros(a.shape[-1], dtype=torch.bool, device=a.device)
    gt = torch.zeros_like(lt)
    for i in range(a.shape[0]):
        lt = lt | (~gt & (a[i] < b[i]))
        gt = gt | (~lt & (a[i] > b[i]))
    return lt


def finish_core(ok_ed_pre, ed_point, ed_r, ok_kes_pre, kes_point, kes_r,
                ok_vrf_pre, vrf_points, c16, beta_decl, thr_lo, thr_hi):
    """-> (flags [5, B] int64 rows ok_ocert_sig, ok_kes_sig, ok_vrf,
    ok_leader, leader_ambiguous; eta [32, B]; leader value [32, B])."""
    b = c16.shape[-1]
    dev = c16.device
    encs = pc.compress_many([ed_point, kes_point, *vrf_points])
    ok_ed = ok_ed_pre & _all_eq(encs[0], ed_r)
    ok_kes = ok_kes_pre & _all_eq(encs[1], kes_r)
    h_enc, g_enc, u_enc, v_enc, g8_enc = encs[2:]
    c_prime = ph.sha512_fixed(torch.cat(
        [_rows([SUITE, 0x02], b, dev), h_enc, g_enc, u_enc, v_enc]))[:16]
    beta = ph.sha512_fixed(torch.cat([_rows([SUITE, 0x03], b, dev), g8_enc]))
    beta_decl = beta_decl.to(torch.int64)
    ok_vrf = ok_vrf_pre & _all_eq(c_prime, c16) & _all_eq(beta, beta_decl)
    lv = ph.blake2b_fixed(torch.cat([_rows([ord("L")], b, dev), beta_decl]), 32)
    eta1 = ph.blake2b_fixed(torch.cat([_rows([ord("N")], b, dev), beta_decl]), 32)
    eta = ph.blake2b_fixed(eta1, 32)
    win = _lt_be(lv, thr_lo.to(torch.int64))
    loss = ~_lt_be(lv, thr_hi.to(torch.int64))
    amb = ~win & ~loss
    flags = torch.stack([ok_ed, ok_kes, ok_vrf, win, amb]).to(torch.int64)
    return flags, eta, lv
