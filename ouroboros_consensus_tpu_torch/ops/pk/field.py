"""GF(2^255-19) in radix 2^25.5 over lanes, plain PyTorch (int64), plus
the byte-level scalar helpers mod L.

This is the arithmetic of the port's CUDA kernels (csrc/pk.cuh) written
out as tensor operations, step for step, so that a kernel and its plain
twin produce the same integers:

* A field element is 10 limbs, limb i holding bits OFF[i] .. OFF[i]+W[i]
  with widths 26, 25, 26, 25, ... (ref10's radix). The TPU package used
  20 x 13-bit limbs because that chip has no 64-bit multiply; Hopper has
  a 32x32->64 multiply, so 10 limbs give 100 products per field mul
  instead of 400.
* Loose form (every op's output): limb i < 2^W[i] + 2^14. A product of
  two loose elements sums at most 10 terms below 2^56.3 each (< 2^60),
  so int64 never overflows; `carry` restores the loose form with two
  parallel carry passes after a product and one after a sum or
  difference (no sequential chain — the kernel's ILP).
* Layout: [10, B] int64, limbs first, lanes last.

Scalars mod L stay byte arrays: `reduce512` is TweetNaCl's signed
byte-wise modL (int64, arithmetic shifts), `scalar_lt_l` a big-endian
byte compare.
"""

from __future__ import annotations

from functools import lru_cache

import torch

NL = 10
W = [26 if i % 2 == 0 else 25 for i in range(NL)]
OFF = [sum(W[:i]) for i in range(NL)]
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_I64 = torch.int64
_W_COL = torch.tensor(W, dtype=_I64).reshape(NL, 1)
_M_COL = (1 << _W_COL) - 1


def _toeplitz():
    """Limb k of a product sums f_i · g_(k-i mod 10) · fac(i, k): fac
    doubles the term when both limbs are odd (the half bit of the 25.5
    radix) and multiplies it by 19 when i + j wraps past 2^255."""
    idx = torch.zeros(NL, NL, dtype=_I64)
    fac = torch.ones(NL, NL, dtype=_I64)
    for k in range(NL):
        for i in range(NL):
            j = (k - i) % NL
            idx[k, i] = j
            f = 2 if (i % 2 == 1 and j % 2 == 1) else 1
            fac[k, i] = f * (19 if i + j >= NL else 1)
    return idx, fac.reshape(NL, NL, 1)


_GIDX, _FAC = _toeplitz()
_ROT19 = torch.tensor([19] + [1] * (NL - 1), dtype=_I64).reshape(NL, 1)


def int_to_limbs(x: int) -> list[int]:
    """Canonical limbs of x mod p."""
    x %= P
    return [(x >> OFF[i]) & ((1 << W[i]) - 1) for i in range(NL)]


_TWO_P = torch.tensor(
    [2 * ((1 << W[i]) - 1) for i in range(NL)], dtype=_I64
).reshape(NL, 1)
_TWO_P[0, 0] = 2 * ((1 << 26) - 19)


@lru_cache(maxsize=256)
def _const(x: int, device: str) -> torch.Tensor:
    return torch.tensor(int_to_limbs(x), dtype=_I64, device=device).reshape(NL, 1)


def const(x: int, device="cpu") -> torch.Tensor:
    """[10, 1] canonical limbs of a field constant (broadcasts over lanes;
    shared — never written in place)."""
    return _const(x % P, str(device))


def zeros(b: int, device="cpu") -> torch.Tensor:
    return torch.zeros(NL, b, dtype=_I64, device=device)


def ones(b: int, device="cpu") -> torch.Tensor:
    z = zeros(b, device)
    z[0] = 1
    return z


@lru_cache(maxsize=8)
def _consts_on(device: str):
    return (_W_COL.to(device), _M_COL.to(device), _TWO_P.to(device),
            _GIDX.to(device), _FAC.to(device), _ROT19.to(device))


def carry(h: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Parallel carry passes: limb i keeps its low W[i] bits plus the
    carry out of limb i-1 (limb 0 takes 19 x the carry out of limb 9).
    A product needs two passes to return to the loose form; a sum or
    difference of loose elements needs one (its carries are at most 3)."""
    w, m, _, _, _, rot19 = _consts_on(str(h.device))
    for _ in range(passes):
        c = h >> w
        h = (h & m) + c.roll(1, 0) * rot19
    return h


def add(a, b):
    return carry(a + b, 1)


def sub(a, b):
    return carry(a + _consts_on(str(a.device))[2] - b, 1)


def neg(a):
    return carry(_consts_on(str(a.device))[2] - a, 1)


def mul(a, b):
    """10x10 schoolbook product, 100 32x32->64-bit terms (see _toeplitz),
    then two carry passes."""
    gidx, fac = _consts_on(str(a.device))[3:5]
    if b.shape[-1] < a.shape[-1]:
        a, b = b, a  # the gathered operand carries the lane width
    return carry((b[gidx] * fac * a.unsqueeze(0)).sum(1), 2)


def _sq_terms():
    """The 55 products of ref10's squaring: pair (i, j), i <= j, lands in
    limb (i+j) mod 10 with fe_mul's factor (2 for two odd limbs, 19 past
    2^255), doubled when i < j (the (j, i) term of fe_mul(a, a))."""
    ii, jj, kk, ff = [], [], [], []
    for i in range(NL):
        for j in range(i, NL):
            ii.append(i)
            jj.append(j)
            kk.append((i + j) % NL)
            f = (2 if i % 2 == 1 and j % 2 == 1 else 1) * (19 if i + j >= NL else 1)
            ff.append(f * (1 if i == j else 2))
    return (torch.tensor(ii), torch.tensor(jj), torch.tensor(kk),
            torch.tensor(ff, dtype=_I64).reshape(-1, 1))


_SQ_TERMS = _sq_terms()


@lru_cache(maxsize=8)
def _sq_terms_on(device: str):
    return tuple(t.to(device) for t in _SQ_TERMS)


def sq(a):
    """Dedicated squaring, the twin of pk.cuh's fe_sq: 55 products whose
    column sums equal mul(a, a)'s, then the same two carry passes — so
    the result equals mul(a, a) limb for limb."""
    ii, jj, kk, ff = _sq_terms_on(str(a.device))
    h = torch.zeros(NL, a.shape[-1], dtype=_I64, device=a.device)
    return carry(h.index_add_(0, kk, a[ii] * a[jj] * ff), 2)


def sqr(a):
    """The stages' squaring: mul(a, a), which equals the kernels' fe_sq
    (and `sq`) limb for limb; chip_smoke's bound counts it apart, at 55
    wide products."""
    return mul(a, a)


def pow2k(a, k: int):
    for _ in range(k):
        a = sqr(a)
    return a


def _chain_2_250m1(x):
    t0 = sqr(x)
    t1 = mul(x, pow2k(t0, 2))  # x^9
    x11 = mul(t0, t1)
    t31 = mul(t1, sqr(x11))
    a = mul(pow2k(t31, 5), t31)
    b = mul(pow2k(a, 10), a)
    c = mul(pow2k(b, 20), b)
    d = mul(pow2k(c, 10), a)
    e = mul(pow2k(d, 50), d)
    f = mul(pow2k(e, 100), e)
    g = mul(pow2k(f, 50), d)
    return g, x11


def inv(x):
    """x^(p-2) (0 -> 0)."""
    g, x11 = _chain_2_250m1(x)
    return mul(pow2k(g, 5), x11)


def pow22523(x):
    """x^((p-5)/8)."""
    g, _ = _chain_2_250m1(x)
    return mul(pow2k(g, 2), x)


def _seq(h: list) -> tuple[list, torch.Tensor]:
    """Sequential carry over limb rows; -> (in-width rows, carry out of
    limb 9, worth 2^255)."""
    c = None
    for i in range(NL):
        if c is not None:
            h[i] = h[i] + c
        c = h[i] >> W[i]
        h[i] = h[i] & ((1 << W[i]) - 1)
    return h, c


def freeze(x: torch.Tensor) -> torch.Tensor:
    """The canonical representative in [0, p), limbs in width. Two
    sequential passes fold the 2^255 carry back as 19; a trial add of 19
    then decides the one conditional subtraction of p."""
    h = list(x.unbind(0))
    for _ in range(2):
        h, c = _seq(h)
        h[0] = h[0] + 19 * c
    t = list(h)
    t[0] = t[0] + 19
    t, c = _seq(t)
    ge = c == 1
    return torch.stack([torch.where(ge, ti, hi) for ti, hi in zip(t, h)])


def eq(a, b):
    """Field equality -> bool[B]."""
    return (freeze(a) == freeze(b)).all(dim=0)


def is_zero(a):
    return (freeze(a) == 0).all(dim=0)


def parity(a):
    return freeze(a)[0] & 1


def select(cond, a, b):
    """cond ? a : b with cond bool[B]."""
    return torch.where(cond.unsqueeze(0), a, b)


def from_bytes(b32: torch.Tensor) -> torch.Tensor:
    """[32, B] little-endian bytes (bit 255 ignored) -> in-width limbs."""
    b = b32.to(_I64)
    rows = []
    for i in range(NL):
        lo, hi = OFF[i], OFF[i] + W[i]
        acc = torch.zeros_like(b[0])
        for k in range(lo // 8, (hi - 1) // 8 + 1):
            sh = 8 * k - lo
            v = b[k] & 0x7F if k == 31 else b[k]
            acc = acc | ((v << sh) if sh >= 0 else (v >> -sh))
        rows.append(acc & ((1 << W[i]) - 1))
    return torch.stack(rows)


def to_bytes(x: torch.Tensor) -> torch.Tensor:
    """Canonical little-endian [32, B] bytes (int64 values 0..255)."""
    h = freeze(x)
    rows = []
    for k in range(32):
        bit = 8 * k
        i = max(j for j in range(NL) if OFF[j] <= bit)
        sh = bit - OFF[i]
        v = h[i] >> sh
        if sh + 8 > W[i] and i + 1 < NL:
            v = v | (h[i + 1] << (W[i] - sh))
        rows.append(v & 0xFF)
    return torch.stack(rows)


def geq_p(h: torch.Tensor) -> torch.Tensor:
    """For in-width limbs (value < 2^255): value >= p  ->  bool[B]."""
    t = list(h.unbind(0))
    t[0] = t[0] + 19
    _, c = _seq(t)
    return c == 1


def sqrt_ratio_ext(n, d):
    """Candidate rho for sqrt(n/d) with its classification (good:
    d·rho² = n, good_alt: = -n, is_pi: = i·n). One exponentiation."""
    d2 = sqr(d)
    d3 = mul(d, d2)
    d7 = mul(d3, sqr(d2))
    rho = mul(mul(n, d3), pow22523(mul(n, d7)))
    check = mul(d, sqr(rho))
    good = eq(check, n)
    good_alt = eq(check, neg(n))
    is_pi = eq(check, mul(const(SQRT_M1, n.device), n))
    return rho, good, good_alt, is_pi


def sqrt_ratio(n, d):
    """(ok[B], r): r = sqrt(n/d), the even root."""
    rho, good, good_alt, _ = sqrt_ratio_ext(n, d)
    r = select(good, rho, mul(rho, const(SQRT_M1, n.device)))
    r = select(parity(r) == 1, neg(r), r)
    return good | good_alt, r


# ---------------------------------------------------------------------------
# Scalars mod L (byte arrays)
# ---------------------------------------------------------------------------

L_BYTES = list(L.to_bytes(32, "little"))


def scalar_lt_l(s: torch.Tensor) -> torch.Tensor:
    """[32, B] little-endian bytes: s < L -> bool[B] (s is canonical)."""
    s = s.to(_I64)
    lt = torch.zeros(s.shape[-1], dtype=torch.bool, device=s.device)
    gt = torch.zeros_like(lt)
    for i in range(31, -1, -1):
        lt = lt | (~gt & (s[i] < L_BYTES[i]))
        gt = gt | (~lt & (s[i] > L_BYTES[i]))
    return lt


def reduce512(digest: torch.Tensor) -> torch.Tensor:
    """[64, B] little-endian bytes -> [32, B] bytes of the value mod L
    (TweetNaCl modL: signed int64 byte limbs, arithmetic shifts)."""
    x = list(digest.to(_I64).unbind(0))
    for i in range(63, 31, -1):
        carry_ = torch.zeros_like(x[0])
        for j in range(i - 32, i - 12):
            x[j] = x[j] + carry_ - 16 * x[i] * L_BYTES[j - (i - 32)]
            carry_ = (x[j] + 128) >> 8
            x[j] = x[j] - (carry_ << 8)
        x[i - 12] = x[i - 12] + carry_
        x[i] = torch.zeros_like(x[i])
    carry_ = torch.zeros_like(x[0])
    top = x[31] >> 4
    for j in range(32):
        x[j] = x[j] + carry_ - top * L_BYTES[j]
        carry_ = x[j] >> 8
        x[j] = x[j] & 255
    for j in range(32):
        x[j] = x[j] - carry_ * L_BYTES[j]
    out = []
    for i in range(32):
        if i + 1 < 32:
            x[i + 1] = x[i + 1] + (x[i] >> 8)
        out.append(x[i] & 255)
    return torch.stack(out)


def nibbles_msb(b: torch.Tensor, nbytes: int) -> torch.Tensor:
    """[n, B] little-endian bytes -> [2*nbytes, B] base-16 digits,
    most significant first."""
    b = b.to(_I64)
    rows = []
    for k in range(nbytes - 1, -1, -1):
        rows.append(b[k] >> 4)
        rows.append(b[k] & 0xF)
    return torch.stack(rows)
