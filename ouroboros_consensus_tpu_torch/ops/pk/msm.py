"""The window aggregate's shared signed-digit bucket machine: the kernel
`msm` (csrc/msm.cu), its wrapper and its plain PyTorch twin.

Port of the JAX package's ops/pk/msm.py `msm_shared` (the engine of
`aggregate_window`), which there is plain XLA (argsorts, segment scans,
fori loops): Σ_i k_i · P_i over several groups of points whose scalars
have different widths, through ONE bucket machine:

* each scalar recodes into balanced signed 12-bit digits
  d ∈ (−2^11, 2^11] (`recode_signed`; ⌈(nbits + 1) / 12⌉ windows: 11 for
  the raw 128-bit Fiat–Shamir coefficients, 22 for mod-L products);
* window w of every point whose group still has digits there lands in
  bucket (w, |d|) with the sign folded into the point; digit 0 has
  weight 0 and is skipped (the aggregate's unused table slots carry
  coefficient 0, so at one pool nearly all of the table entries land
  there);
* each window's weight Σ_d d·B_d as a tree: a range of buckets from a
  keeps W = Σ (d − a + 1)·B_d and N = (its length)·Σ B_d, and two
  adjacent ranges join as W = W_L + W_H + N_H, N = 2·(N_L + N_H): eleven
  levels of two operations deep each from the single buckets
  (`weighted_sums`), where running sums would chain 2^12 additions;
* one Horner chain over the windows (2^12 a step).

The plain twin (`msm_shared`) keeps that shape; its bucket sums are
exact sums in another order than the kernel's (atomics place the entries
of a bucket in any order), so the two agree as points (compressed bytes,
`is_identity`), not as projective limbs. Points are the port's radix
(ops/pk/field.py: [10, N] limbs per coordinate); scalars are byte rows
(ops/pk/scalar.py).
"""

from __future__ import annotations

import math

import torch

from . import curve as pc
from . import field as fe
from . import scalar as sc

SHARED_BITS = 12
HALF = 1 << (SHARED_BITS - 1)
NBUCKETS = HALF + 1  # |d| in 0 .. 2^11
CHUNK = 16  # entries a thread of the kernel's chunk phase sums (csrc/agg.cuh)
SPAN = 8  # chunk pieces a thread of its span phase joins; more take a block
SMALL_BITS = 128  # the raw Fiat–Shamir coefficients
WIDE_BITS = 253  # mod-L products and table sums


def signed_digit_windows(nbits: int, cbits: int = SHARED_BITS) -> int:
    """Windows of the balanced recode: the +1 bit absorbs the final
    carry."""
    return -(-(nbits + 1) // cbits)


def recode_signed(scalars: torch.Tensor, nbits: int, cbits: int = SHARED_BITS) -> torch.Tensor:
    """[32, N] byte scalars (< 2^nbits) -> [W, N] int64 balanced signed
    digits, least significant window first, Σ_w d_w·2^(w·c) = scalar and
    d_w ∈ (−2^(c−1), 2^(c−1)]. Window w reads the three bytes that hold
    its bits, adds the carry of the window below, and gives 2^c back
    when the result passes 2^(c−1) (csrc/agg.cuh: msm_recode, the same
    steps)."""
    w = signed_digit_windows(nbits, cbits)
    half, mask = 1 << (cbits - 1), (1 << cbits) - 1
    b = sc.bytes_to_limbs(scalars, (w * cbits + 7) // 8 + 3)
    carry = torch.zeros_like(b[0])
    digits = []
    for i in range(w):
        k, sh = divmod(i * cbits, 8)
        u = (b[k] | (b[k + 1] << 8) | (b[k + 2] << 16)) >> sh
        d = (u & mask) + carry
        carry = (d > half).to(torch.int64)
        digits.append(d - (carry << cbits))
    return torch.stack(digits)


def is_identity(p: pc.Point) -> torch.Tensor:
    """bool[...]: the projective identity test X = 0 and Y = Z (exact:
    no cofactor multiplication)."""
    return fe.is_zero(p.x) & fe.eq(p.y, p.z)


def _take(p: pc.Point, idx: torch.Tensor) -> pc.Point:
    return pc.Point(*(c[:, idx] for c in p))


def _put(p: pc.Point, idx: torch.Tensor, q: pc.Point) -> pc.Point:
    out = []
    for c, v in zip(p, q):
        c = c.clone()
        c[:, idx] = v
        out.append(c)
    return pc.Point(*out)


def bucket_sums(points: pc.Point, digits: list, nwin: int) -> pc.Point:
    """Bucket sums B[w, d] = Σ_{digit_w(i) = ±d} ±P_i for d >= 1, as a
    Point of [10, nwin * HALF] coordinates (bucket (w, d) at
    w * HALF + d − 1; an empty bucket is the identity). `digits`: one
    [W_g, N] digit array per point (already aligned with `points` along
    N: a point with fewer windows has zeros above them). The entries of
    each bucket, in point order, are added pairwise in rounds (each
    round the entry at an even rank in its bucket takes the next one's)
    until one is left."""
    dev = points.x.device
    dig = torch.cat([torch.cat([d, torch.zeros(nwin - d.shape[0], d.shape[1],
                                               dtype=d.dtype, device=dev)]) for d in digits], 1)
    w_idx, p_idx = torch.nonzero(dig, as_tuple=True)
    d = dig[w_idx, p_idx]
    key = w_idx * HALF + d.abs() - 1
    order = torch.sort(key, stable=True).indices
    key, p_idx, neg = key[order], p_idx[order], d[order] < 0
    acc = pc.identity(nwin * HALF, dev)
    if key.numel() == 0:
        return acc
    vals = _take(points, p_idx)
    vals = pc.Point(fe.select(neg, fe.neg(vals.x), vals.x), vals.y, vals.z,
                    fe.select(neg, fe.neg(vals.t), vals.t))
    while True:
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        if bool(first.all()):
            break
        pos = torch.arange(key.numel(), device=dev)
        rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
        last = torch.ones_like(first)
        last[:-1] = first[1:]
        pair = (rank % 2 == 0) & ~last  # an even rank with a next entry in its bucket
        i = pair.nonzero()[:, 0]
        vals = _put(vals, i, pc.add(_take(vals, i), _take(vals, i + 1)))
        keep = rank % 2 == 0
        key, vals = key[keep], _take(vals, keep.nonzero()[:, 0])
    return _put(acc, key, vals)


def tree_level(w: pc.Point, n: pc.Point):
    """One level of the weighted-sum tree: nodes 2q (the lower range) and
    2q + 1 (the upper, both of the same length) -> node q, W = W_L + W_H
    + N_H and N = 2·(N_L + N_H) (csrc/agg.cuh: msm_wide_node,
    msm_join_node)."""
    wl, wh = _take(w, slice(0, None, 2)), _take(w, slice(1, None, 2))
    nl, nh = _take(n, slice(0, None, 2)), _take(n, slice(1, None, 2))
    return pc.add(pc.add(wl, wh), nh), pc.double(pc.add(nl, nh), True)


def weighted_sums(buckets: pc.Point, nwin: int) -> pc.Point:
    """Σ_{d=1}^{2^11} d·B[w, d] per window -> Point [10, nwin]: each
    window's 2^11 buckets (bucket w · HALF + d − 1) as the tree's leaves
    (W = N = B_d), eleven levels (the device's phases 6 and 7:
    csrc/msm.cu's wide levels, then the join)."""
    w = n = buckets
    for _ in range(SHARED_BITS - 1):
        w, n = tree_level(w, n)
    return w


def horner(sums: pc.Point, cbits: int = SHARED_BITS) -> pc.Point:
    """Σ_w 2^(c·w)·S_w, most significant window first -> Point [10, 1]."""
    nwin = sums.x.shape[-1]
    acc = pc.Point(*(c[:, nwin - 1: nwin] for c in sums))
    for w in range(nwin - 2, -1, -1):
        for k in range(cbits):
            acc = pc.double(acc, k == cbits - 1)
        acc = pc.add(acc, pc.Point(*(c[:, w: w + 1] for c in sums)))
    return acc


def msm_shared(groups) -> pc.Point:
    """Σ k_i·P_i over several groups through one bucket machine: groups =
    [(scalars [32, N_g] bytes, Point [10, N_g], nbits), ...] -> Point
    [10, 1]. A window w holds the points of every group with more than w
    windows (the reference's window segments by group width)."""
    ws = [signed_digit_windows(nbits) for _, _, nbits in groups]
    nwin = max(ws)
    points = pc.Point(*(torch.cat([g[1][k] for g in groups], 1) for k in range(4)))
    digits = [recode_signed(s, nbits) for s, _, nbits in groups]
    buckets = bucket_sums(points, digits, nwin)
    return horner(weighted_sums(buckets, nwin))


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


def msm_plain(points: torch.Tensor, scalars: torch.Tensor, n_small: int,
              base: torch.Tensor):
    """The twin of the `msm` kernel: points [N, 40] int32 (X ‖ Y ‖ Z ‖ T,
    point-major), scalars [N, 32] uint8, the first n_small below 2^128
    and the rest below 2^253, base [32] uint8 ->
    (total [40] int32 = Σ k_i·P_i + base·B, identity [1] int32)."""
    p = pc.unstack(points.T.to(torch.int64))
    s = scalars.T.to(torch.int64)
    groups = [(s[:, :n_small], _take(p, slice(0, n_small)), SMALL_BITS),
              (s[:, n_small:], _take(p, slice(n_small, None)), WIDE_BITS)]
    total = pc.add(msm_shared([g for g in groups if g[0].shape[-1]]),
                   pc.base_mul_w8(base.to(torch.int64).reshape(32, 1)))
    return (pc.stack(total).reshape(40).to(torch.int32),
            is_identity(total).to(torch.int32).reshape(1))


def msm_buffers(n: int, n_small: int, dev) -> dict:
    """The `msm` kernel's scratch and outputs for n points (the first
    n_small 128-bit), by name in pk_msm's order: views of two int32
    allocations, each view on a 16-byte boundary (the point arrays' loads
    and stores are 16 bytes); the first, zero on entry, holds the counts
    (ww · NBUCKETS) and the big list (count first). The tree's levels
    alternate between tree_a and tree_b."""
    ws, ww = signed_digit_windows(SMALL_BITS), signed_digit_windows(WIDE_BITS)
    m = ww * NBUCKETS
    emax = n_small * ws + (n - n_small) * ww
    nch = max(-(-emax // CHUNK), 1)
    maxbig = min(emax // ((SPAN - 1) * CHUNK + 2), m)
    shapes = {
        "digits": (ww, n), "offsets": (m + 1,), "cursor": (m,),
        "ent": (max(emax, 1),), "ekey": (max(emax, 1),),
        "part": (nch, 40), "tailp": (nch, 40), "buckets": (ww * HALF, 40),
        "tree_a": (2 * ww * HALF // 4, 40), "tree_b": (2 * ww * HALF // 8, 40),
        "wsum": (ww, 40), "bterm": (40,), "total": (40,), "ident": (1,),
    }
    sizes = {k: -(-math.prod(v) // 4) * 4 for k, v in shapes.items()}
    flat = torch.empty((sum(sizes.values()),), dtype=torch.int32, device=dev)
    zero = torch.zeros((-(-m // 4) * 4 + maxbig + 1,), dtype=torch.int32, device=dev)
    views, at = {}, 0
    for k, shape in shapes.items():
        views[k] = flat[at: at + math.prod(shape)].view(shape)
        at += sizes[k]
    bufs = {"digits": views["digits"], "counts": zero[:m]}
    bufs.update({k: views[k] for k in ("offsets", "cursor")})
    bufs["big"] = zero[-(-m // 4) * 4:]
    bufs.update({k: views[k] for k in shapes if k not in bufs})
    return bufs


def msm_launch(fn, stream, points, scalars, n_small, base) -> dict:
    """One call of pk_msm (`fn`: the CUDA launcher, or the host build's)
    -> msm_buffers after it."""
    from .kernels import _base8, _p

    dev = points.device
    n = points.shape[0]
    bufs = msm_buffers(n, n_small, dev)
    rc = fn(n, n_small, signed_digit_windows(SMALL_BITS), signed_digit_windows(WIDE_BITS),
            _p(_base8(dev)), _p(points), _p(scalars), _p(base),
            *(_p(t) for t in bufs.values()), stream)
    bufs["rc"] = rc
    return bufs


def msm(points: torch.Tensor, scalars: torch.Tensor, n_small: int, base: torch.Tensor):
    """Σ k_i·P_i + base·B and its exact identity test: points [N, 40]
    int32, scalars [N, 32] uint8 (the first n_small are 128-bit, the
    rest mod-L wide), base [32] uint8 -> (total [40] int32, identity [1]
    int32).

    Replaces the plain-XLA `msm_shared` of
    ouroboros_consensus_tpu/ops/pk/msm.py:381 (and the collected B term's
    fixed-base mul of ops/pk/aggregate.py:304), which the JAX package
    never wrote as a Pallas kernel (argsort and gathers have no Mosaic
    lowering): csrc/msm.cu, ten launches of one source on the current
    stream (nine kernels, the wide tree level's twice) — recode and count per (window, |digit|), an exclusive scan,
    the scatter of point indices into buckets (atomics; no sort), the
    entries' running sums in chunks of CHUNK a thread, the pieces of the
    buckets that cross chunks (a thread a bucket, a block's tree past
    SPAN pieces), the weighted sums as a tree (its three widest levels a
    thread a node, the first two as running sums over four buckets, the
    fixed-base mul of the B term in a block beside them; then a block a
    window, a node a lane of two quads, for the last eight), then one
    warp that runs the Horner chain with a field element over ten lanes
    and tests the identity. Plain version: msm_plain. Bound: operations
    (the bucket additions, 9 field products each); on a replay window
    the Horner chain (252 doublings, 22 additions) is the dependent
    path."""
    from .kernels import LAUNCHES, _check, _raise_on, _route, _stream

    dev = points.device
    n = points.shape[0]
    _check("msm.points", points, (n, 40), dev)
    _check("msm.scalars", scalars, (n, 32), dev, torch.uint8)
    _check("msm.base", base, (32,), dev, torch.uint8)
    if not 0 <= n_small <= n:
        raise ValueError(f"msm: n_small {n_small} outside [0, {n}]")
    if points.data_ptr() % 16:
        raise ValueError("msm: points must start on a 16-byte boundary (the kernel's "
                         "16-byte loads)")
    if _route(dev) == "plain":
        return msm_plain(points, scalars, n_small, base)
    from . import build

    bufs = msm_launch(build.kernel_lib("msm"), _stream(dev), points, scalars, n_small, base)
    _raise_on(bufs["rc"], "msm")
    LAUNCHES["msm"] += 1
    return bufs["total"], bufs["ident"]
