"""edwards25519 points and ladders over lanes, plain PyTorch.

Points are extended homogeneous (X, Y, Z, T) coordinates, each a [10, B]
field element of ops/pk/field.py; the same unified addition law, doubling
and window walks as the CUDA device library (csrc/pk.cuh), operation for
operation:

* `double(p, with_t)`: T's product only when the next operation reads T
  (a doubling reads X, Y, Z alone); a skipped T is None;
* `cache` / `add_cached`: a point as (Y+X, Y−X, 2d·T, 2Z), added in 8
  products (7 without T);
* `scalar_mul_w4`: k base-16 digits recoded into k + 1 signed digits in
  [−8, 8), most significant first, over an 8-entry table of 1P..8P in
  cached form (`table8`, 7 additions; a negative digit swaps Y+X and Y−X
  and negates 2dT); the kernel keeps the table in local or shared memory;
* `base_mul_w8`: s·B by 32 additions from the fixed-base table
  `base8()` — [32 windows, 256 digits, 40 limbs], entry (w, d) the affine
  d·2^(8w)·B as (x, y, 1, xy) in canonical limbs (the kernel reads the
  same table from global memory through the read-only cache).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from . import field as fe

# the base point (RFC 8032): y = 4/5, x even
_BY = 4 * pow(5, fe.P - 2, fe.P) % fe.P


def _recover_x(y: int) -> int:
    xx = (y * y - 1) * pow(fe.D * y * y + 1, fe.P - 2, fe.P) % fe.P
    x = pow(xx, (fe.P + 3) // 8, fe.P)
    if (x * x - xx) % fe.P:
        x = x * fe.SQRT_M1 % fe.P
    return fe.P - x if x & 1 else x


_BX = _recover_x(_BY)


class Point(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(b: int, device="cpu") -> Point:
    z = fe.zeros(b, device)
    o = fe.ones(b, device)
    return Point(z, o, o.clone(), z.clone())


def add(p: Point, q: Point) -> Point:
    a = fe.mul(fe.sub(p.y, p.x), fe.sub(q.y, q.x))
    b = fe.mul(fe.add(p.y, p.x), fe.add(q.y, q.x))
    c = fe.mul(fe.mul(p.t, q.t), fe.const(fe.D2, p.x.device))
    zz = fe.mul(p.z, q.z)
    d = fe.add(zz, zz)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def double(p: Point, with_t: bool = True) -> Point:
    a = fe.sqr(p.x)
    b = fe.sqr(p.y)
    zz = fe.sqr(p.z)
    c = fe.add(zz, zz)
    h = fe.add(a, b)
    e = fe.sub(h, fe.sqr(fe.add(p.x, p.y)))
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g),
                 fe.mul(e, h) if with_t else None)


def _dbl4(q: Point) -> Point:
    for j in range(4):
        q = double(q, j == 3)
    return q


def neg(p: Point) -> Point:
    return Point(fe.neg(p.x), p.y, p.z, fe.neg(p.t))


def mul_cofactor(p: Point) -> Point:
    return double(double(double(p, False), False), True)


def stack(p: Point) -> torch.Tensor:
    """Point -> [40, B] (X ‖ Y ‖ Z ‖ T limbs)."""
    return torch.cat(list(p), dim=0)


def unstack(flat: torch.Tensor) -> Point:
    return Point(*(flat[10 * i: 10 * (i + 1)] for i in range(4)))


class Cached(NamedTuple):
    """A point as (Y+X, Y−X, 2d·T, 2Z), each [10, B]."""

    ypx: torch.Tensor
    ymx: torch.Tensor
    t2d: torch.Tensor
    z2: torch.Tensor


def cache(p: Point) -> Cached:
    return Cached(fe.add(p.y, p.x), fe.sub(p.y, p.x),
                  fe.mul(p.t, fe.const(fe.D2, p.x.device)), fe.add(p.z, p.z))


def add_cached(p: Point, q: Cached, with_t: bool = True) -> Point:
    a = fe.mul(fe.sub(p.y, p.x), q.ymx)
    b = fe.mul(fe.add(p.y, p.x), q.ypx)
    c = fe.mul(p.t, q.t2d)
    d = fe.mul(p.z, q.z2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g),
                 fe.mul(e, h) if with_t else None)


def signed_digits(digits_msb: torch.Tensor) -> torch.Tensor:
    """k base-16 digits [k, B] (most significant first) -> k + 1 signed
    digits in [−8, 8), most significant first, the first 0 or 1: the
    nibbles of a + 0x88...8 less 8, and its carry out."""
    k = digits_msb.shape[0]
    out = [None] * (k + 1)
    carry = torch.zeros_like(digits_msb[0], dtype=torch.int64)
    for i in range(k - 1, -1, -1):
        m = digits_msb[i].to(torch.int64) + 8 + carry
        carry = m >> 4
        out[i + 1] = (m & 15) - 8
    out[0] = carry
    return torch.stack(out)


def table8(p: Point) -> torch.Tensor:
    """[8, 40, B]: entry j = (j + 1)·P in cached form, by 7 additions."""
    p1 = cache(p)
    rows = [torch.cat(list(p1))]
    acc = p
    for _ in range(7):
        acc = add_cached(acc, p1, True)
        rows.append(torch.cat(list(cache(acc))))
    return torch.stack(rows)


def select(tbl: torch.Tensor, e: torch.Tensor) -> Cached:
    """The cached point of signed digit e [B] (|e| <= 8): the identity for
    0, and for e < 0 the negation (Y+X and Y−X swapped, 2dT negated)."""
    m = e.abs()
    idx = (m - 1).clamp(min=0).reshape(1, 1, -1).expand(1, tbl.shape[1], -1)
    ent = torch.gather(tbl, 0, idx)[0]
    ypx, ymx, t2d, z2 = (ent[10 * i: 10 * (i + 1)] for i in range(4))
    b = ent.shape[-1]
    zero_m = m == 0
    one = fe.ones(b, ent.device)
    ypx = fe.select(zero_m, one, ypx)
    ymx = fe.select(zero_m, one, ymx)
    t2d = fe.select(zero_m, fe.zeros(b, ent.device), t2d)
    z2 = fe.select(zero_m, fe.const(2, ent.device).expand(fe.NL, b), z2)
    nt = fe.neg(t2d)
    neg_e = e < 0
    return Cached(fe.select(neg_e, ymx, ypx), fe.select(neg_e, ypx, ymx),
                  fe.select(neg_e, nt, t2d), z2)


def scalar_mul_w4(digits_msb: torch.Tensor, p: Point) -> Point:
    """sum(d_i 16^(k-1-i)) · P for digits [k, B], most significant first."""
    tbl = table8(p)
    e = signed_digits(digits_msb)
    k = digits_msb.shape[0]
    q = add_cached(identity(p.x.shape[-1], p.x.device), select(tbl, e[0]), False)
    for i in range(1, k + 1):
        q = add_cached(_dbl4(q), select(tbl, e[i]), i == k)
    return q


def double_scalar_mul_w4(da_msb, pa: Point, db_msb, pb: Point) -> Point:
    """a·PA + b·PB on one doubling chain; len(da) >= len(db)."""
    ka, kb = da_msb.shape[0], db_msb.shape[0]
    ta = table8(pa)
    tb = table8(pb)
    ea = signed_digits(da_msb)
    eb = signed_digits(db_msb)
    q = identity(pa.x.shape[-1], pa.x.device)
    for i in range(ka + 1):
        if i > 0:
            q = _dbl4(q)
        j = i - (ka - kb)
        q = add_cached(q, select(ta, ea[i]), j >= 0 or i == ka)
        if j >= 0:
            q = add_cached(q, select(tb, eb[j]), i == ka)
    return q


@lru_cache(maxsize=1)
def _base8_host() -> torch.Tensor:
    """[32, 256, 40] int64: entry (w, d) = d·2^(8w)·B, affine (x, y, 1, xy)
    in canonical limbs. Built with big-int extended coordinates (the
    unified law, independent of the limb code above) and one batched
    inversion (Montgomery's trick) for all 8192 entries."""
    p_ = fe.P

    def padd(a, b):
        x1, y1, z1, t1 = a
        x2, y2, z2, t2 = b
        aa = (y1 - x1) * (y2 - x2) % p_
        bb = (y1 + x1) * (y2 + x2) % p_
        cc = t1 * t2 % p_ * fe.D2 % p_
        dd = 2 * z1 * z2 % p_
        e, f, g, h = bb - aa, dd - cc, dd + cc, bb + aa
        return (e * f % p_, g * h % p_, f * g % p_, e * h % p_)

    pts = []
    base = (_BX, _BY, 1, _BX * _BY % p_)
    for _w in range(32):
        acc = (0, 1, 1, 0)
        for _d in range(256):
            pts.append(acc)
            acc = padd(acc, base)
        for _ in range(8):
            base = padd(base, base)
    prefix = []
    run = 1
    for q in pts:
        run = run * q[2] % p_
        prefix.append(run)
    inv = pow(run, p_ - 2, p_)
    zinv = [0] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        zinv[i] = inv * (prefix[i - 1] if i else 1) % p_
        inv = inv * pts[i][2] % p_
    rows = []
    one = fe.int_to_limbs(1)
    for q, zi in zip(pts, zinv):
        x, y = q[0] * zi % p_, q[1] * zi % p_
        rows.append(fe.int_to_limbs(x) + fe.int_to_limbs(y) + one
                    + fe.int_to_limbs(x * y))
    return torch.tensor(rows, dtype=torch.int64).reshape(32, 256, 40)


def base8(device="cpu") -> torch.Tensor:
    return _base8_host().to(device)


def base_mul_w8(s_bytes: torch.Tensor) -> Point:
    """s·B from [32, B] little-endian scalar bytes (all 256 bits)."""
    tbl = base8(s_bytes.device)
    b = s_bytes.shape[-1]
    q = identity(b, s_bytes.device)
    for w in range(32):
        ent = tbl[w][s_bytes[w].to(torch.int64)].T  # [40, B]
        q = add(q, unstack(ent))
    return q


def decompress(b32: torch.Tensor) -> tuple[torch.Tensor, Point]:
    """[32, B] bytes -> (ok[B], Point). Rejects y >= p, a non-square
    x², and x = 0 with the sign bit set (RFC 8032 5.1.3)."""
    b32 = b32.to(torch.int64)
    sign = (b32[31] >> 7) & 1
    y = fe.from_bytes(b32)
    y_ok = ~fe.geq_p(y)
    b = b32.shape[-1]
    one = fe.ones(b, b32.device)
    y2 = fe.sqr(y)
    num = fe.sub(y2, one)
    den = fe.add(fe.mul(y2, fe.const(fe.D, b32.device)), one)
    ok_sqrt, x = fe.sqrt_ratio(num, den)
    x_zero = fe.is_zero(x)
    flip = (sign == 1) & ~x_zero
    x = fe.select(flip, fe.neg(x), x)
    ok = y_ok & ok_sqrt & ~(x_zero & (sign == 1))
    return ok, Point(x, y, one, fe.mul(x, y))


def compress_many(points: list[Point]) -> list[torch.Tensor]:
    """Compress k points sharing ONE inversion (Montgomery's trick);
    -> [32, B] canonical encodings."""
    zs = [p.z for p in points]
    prefix = [zs[0]]
    for z in zs[1:]:
        prefix.append(fe.mul(prefix[-1], z))
    acc = fe.inv(prefix[-1])
    invs: list = [None] * len(zs)
    for i in range(len(zs) - 1, 0, -1):
        invs[i] = fe.mul(acc, prefix[i - 1])
        acc = fe.mul(acc, zs[i])
    invs[0] = acc
    outs = []
    for p, zi in zip(points, invs):
        xb = fe.to_bytes(fe.mul(p.x, zi))
        yb = fe.to_bytes(fe.mul(p.y, zi))
        yb[31] = yb[31] | ((xb[0] & 1) << 7)
        outs.append(yb)
    return outs
