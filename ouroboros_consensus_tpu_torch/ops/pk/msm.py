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
* each window's weight Σ_d d·B_d by summation by parts, over segments of
  SEG buckets at once: a segment's running sums give its Σ run and its
  locally weighted sum, and one more running sum over the segments joins
  them (`weighted_sums`);
* one Horner chain over the windows (2^12 a step).

The plain twin (`msm_shared`) keeps that shape; its bucket sums are
exact sums in another order than the kernel's (atomics place the entries
of a bucket in any order), so the two agree as points (compressed bytes,
`is_identity`), not as projective limbs. Points are the port's radix
(ops/pk/field.py: [10, N] limbs per coordinate); scalars are byte rows
(ops/pk/scalar.py).
"""

from __future__ import annotations

import torch

from . import curve as pc
from . import field as fe
from . import scalar as sc

SHARED_BITS = 12
HALF = 1 << (SHARED_BITS - 1)
NBUCKETS = HALF + 1  # |d| in 0 .. 2^11
SEG = 64  # buckets a segment of the weighted sums
SMALL = 32  # the kernel's bucket of more entries is summed by a block (csrc/agg.cuh)
NSEG = HALF // SEG
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
    each bucket are added in point order, one rank at a time."""
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
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(first, torch.arange(key.numel(), device=dev), 0), 0).values
    rank = torch.arange(key.numel(), device=dev) - start
    pts = _take(points, p_idx)
    pts = pc.Point(fe.select(neg, fe.neg(pts.x), pts.x), pts.y, pts.z,
                   fe.select(neg, fe.neg(pts.t), pts.t))
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        k = key[sel]
        acc = _put(acc, k, pc.add(_take(acc, k), _take(pts, sel.nonzero()[:, 0])))
    return acc


def segment_sums(buckets: pc.Point, nwin: int):
    """Over each segment s of SEG buckets (lo_s = s·SEG + 1), a running
    sum from the top: run_s = Σ B_d and acc_s = Σ (d − lo_s + 1)·B_d, two
    additions a bucket -> (run, acc), Points of [10, nwin * NSEG]
    (segment w * NSEG + s; the device's phase 5, csrc/agg.cuh:
    msm_segment)."""
    segs = pc.Point(*(c.reshape(fe.NL, nwin * NSEG, SEG) for c in buckets))
    dev = buckets.x.device
    run = pc.identity(nwin * NSEG, dev)
    acc = pc.identity(nwin * NSEG, dev)
    for j in range(SEG - 1, -1, -1):
        run = pc.add(run, pc.Point(*(c[:, :, j] for c in segs)))
        acc = pc.add(acc, run)
    return run, acc


def weighted_sums(buckets: pc.Point, nwin: int) -> pc.Point:
    """Σ_{d=1}^{2^11} d·B[w, d] per window -> Point [10, nwin], by
    summation by parts in two levels: `segment_sums`, then over the
    segments of a window Σ_s acc_s + SEG·Σ_s s·run_s (a running sum over
    s, three additions a segment, and log2(SEG) doublings; the device's
    phase 6, csrc/agg.cuh: msm_window)."""
    dev = buckets.x.device
    run, acc = segment_sums(buckets, nwin)
    run = pc.Point(*(c.reshape(fe.NL, nwin, NSEG) for c in run))
    acc = pc.Point(*(c.reshape(fe.NL, nwin, NSEG) for c in acc))
    tot = pc.identity(nwin, dev)
    run2 = pc.identity(nwin, dev)
    acc2 = pc.identity(nwin, dev)
    for s in range(NSEG - 1, -1, -1):
        tot = pc.add(tot, pc.Point(*(c[:, :, s] for c in acc)))
        if s > 0:
            run2 = pc.add(run2, pc.Point(*(c[:, :, s] for c in run)))
            acc2 = pc.add(acc2, run2)
    for _ in range(SEG.bit_length() - 1):
        acc2 = pc.double(acc2)
    return pc.add(tot, acc2)


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


def _msm_launch(fn, stream, points, scalars, n_small, base):
    from .kernels import _base8, _p, _raise_on

    dev = points.device
    n = points.shape[0]
    ws, ww = signed_digit_windows(SMALL_BITS), signed_digit_windows(WIDE_BITS)
    entries = n_small * ws + (n - n_small) * ww
    i32 = dict(dtype=torch.int32, device=dev)
    digits = torch.empty((ww, n), **i32)
    counts = torch.zeros((ww * NBUCKETS + 1,), **i32)
    offsets = torch.empty((ww * NBUCKETS + 1,), **i32)
    cursor = torch.empty((ww * NBUCKETS,), **i32)
    big = torch.zeros((min(entries // (SMALL + 1), ww * NBUCKETS) + 1,), **i32)
    ent = torch.empty((max(entries, 1),), **i32)
    buckets = torch.empty((ww * HALF, 40), **i32)
    segs = torch.empty((2, ww * NSEG, 40), **i32)
    total = torch.empty((40,), **i32)
    ident = torch.empty((1,), **i32)
    rc = fn(n, n_small, ws, ww, _p(_base8(dev)), _p(points), _p(scalars), _p(base),
            _p(digits), _p(counts), _p(offsets), _p(cursor), _p(big), _p(ent), _p(buckets),
            _p(segs), _p(total), _p(ident), stream)
    _raise_on(rc, "msm")
    return total, ident


def msm(points: torch.Tensor, scalars: torch.Tensor, n_small: int, base: torch.Tensor):
    """Σ k_i·P_i + base·B and its exact identity test: points [N, 40]
    int32, scalars [N, 32] uint8 (the first n_small are 128-bit, the
    rest mod-L wide), base [32] uint8 -> (total [40] int32, identity [1]
    int32).

    Replaces the plain-XLA `msm_shared` of
    ouroboros_consensus_tpu/ops/pk/msm.py:381 (and the collected B term's
    fixed-base mul of ops/pk/aggregate.py:304), which the JAX package
    never wrote as a Pallas kernel (argsort and gathers have no Mosaic
    lowering): csrc/msm.cu, six launches of one source on the current
    stream — recode and count per (window, |digit|), an exclusive scan,
    the scatter of point indices into buckets (atomics; no sort), one
    bucket sum a thread, the segments' running sums, then one block that
    joins each window's segments (a thread a window, the fixed-base mul
    of the B term on a thread of its own), runs the Horner chain and
    tests the identity. Plain version: msm_plain.
    Bound: operations (the bucket additions, 9 field products each); on
    a replay window the one-thread Horner chain and the per-window joins
    are the dependent path."""
    from .kernels import LAUNCHES, _check, _route, _stream

    dev = points.device
    n = points.shape[0]
    _check("msm.points", points, (n, 40), dev)
    _check("msm.scalars", scalars, (n, 32), dev, torch.uint8)
    _check("msm.base", base, (32,), dev, torch.uint8)
    if not 0 <= n_small <= n:
        raise ValueError(f"msm: n_small {n_small} outside [0, {n}]")
    if _route(dev) == "plain":
        return msm_plain(points, scalars, n_small, base)
    from . import build

    out = _msm_launch(build.kernel_lib("msm"), _stream(dev), points, scalars, n_small, base)
    LAUNCHES["msm"] += 1
    return out
