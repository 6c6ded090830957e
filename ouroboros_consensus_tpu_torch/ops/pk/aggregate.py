"""The window aggregate of a batch-compatible packed window: one random
linear combination of every lane's four group equations, checked by one
multi-scalar multiplication (port of the JAX package's
ops/pk/aggregate.py `aggregate_window`, the reference's default path for
such windows).

Per lane the reference checks

  ed    s_e·B − h_e·A_e − R_e = 0      kes   s_k·B − h_k·A_l − R_k = 0
  vrf U s_v·B − c·Y − U = 0            vrf V s_v·H − c·Γ − V = 0

and a window verifies Σ_i z1·eq_ed + z2·eq_kes + z3·eq_u + z4·eq_v = 0
with per-lane Fiat–Shamir coefficients z1..z4 (SHA-512 of the lane's own
transcript, each forced odd so that z·T ≠ 0 for every nonzero 8-torsion
T: a single lane cannot cancel its own small-order offset). Three
kernels and a little tensor code, all on the current stream, none of
which reads a value back to the host:

1. `agg_prep` (csrc/agg_prep.cu): every lane's own work — the eight
   decompressions, the two challenge digests and their reductions, the
   KES Merkle walk and period range, H, 8·Γ and their compressions, c and
   β, the leader value and eta, the coefficients and every mod-L product
   the MSM needs, and the cheap-check flags pre_ed, pre_kes, pre_vrf.
2. `dedupe` (csrc/dedupe.cu, `window_tables`): the four repeated-key
   columns (R_e, A_e, A_l, Y) grouped by their exact 32-byte wire
   encodings (comparisons in tiles, merged up a tree; never a hash), the
   coefficient bytes summed per group into at most 256 slots, each
   slot's point its key's lowest lane, the slot sums and the window's B
   coefficient reduced mod L; `ok_cap` says whether the groups fit.
3. `msm` (ops/pk/msm.py, csrc/msm.cu): Σ k_i·P_i over the 128-bit group
   (z2·−R_k, z3·−U, z4·−V) and the wide group (z4·c·−Γ, z4·s_v·H and the
   four tables) plus the B term, and the exact identity test.

agg_ok = identity & every ok_cap, folded into the three signature rows of
the flags as the reference does. A window whose verdicts are not clean
is verified again by the per-lane stage kernels (protocol/batch.py:
`materialize`), which give the exact error of each lane.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import curve as pc
from . import field as fe
from . import hashes as ph
from . import msm as pm
from . import scalar as sc
from . import verify as pv

FS_TAG = tuple(b"octRLC-1")  # the Fiat–Shamir hash's domain prefix
_DEDUPE_CAP = 256  # slots of one deduped-key table
DEDUPE_MAX_LANES = 1 << 22  # lanes the dedupe kernel takes (csrc/agg.cuh: DD_MAXN)
DEDUPE_TILE = 256  # lanes a tile, a block of the dedupe kernel (DD_TILE)
_DD_LEVELS = 8  # the kernel's tree levels, four children a node (DD_LEVELS, DD_FAN)
# the dedupe scratch kept between calls at most (bytes): windows to about
# 30,000 lanes; a wider window's is allocated for its call alone
_SCRATCH_KEEP = 1 << 25

# agg_prep's point columns ([9, B, 40]) and scalar rows ([12, B, 32])
PT_RK, PT_U, PT_V, PT_G, PT_H, PT_RE, PT_AE, PT_AL, PT_Y = range(9)
(SC_Z2, SC_Z3, SC_Z4, SC_Z4C, SC_Z4S, SC_Z1, SC_Z1H, SC_Z2H, SC_Z3C,
 SC_B1, SC_B2, SC_B3) = range(12)
N_PTS, N_SC = 9, 12
N_SMALL_COLS = 3  # the 128-bit group: −R_k, −U, −V
N_LANE_COLS = 5  # and the wide group's per-lane columns: −Γ, H
# the repeated-key columns' key arrays among the 22 inputs (R_e, A_e, A_l,
# Y); their points are PT_RE .. PT_Y, their coefficients SC_Z1 .. SC_Z3C
DEDUPE_KEYS = (1, 0, 9, 13)


class AggregateVerdicts(NamedTuple):
    """One aggregated window's outputs, on the columns' device."""

    flags: torch.Tensor  # [5, B] int32: finish's rows, agg_ok folded into 0-2
    eta: torch.Tensor  # [32, B] int32
    leader_value: torch.Tensor  # [32, B] int32
    agg_ok: torch.Tensor  # [] bool: the combination was the identity, every table fit
    pre_ok: torch.Tensor  # [] bool: every lane passed its cheap checks (read by tests)


def _rows(vals, b: int, device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int64, device=device).reshape(-1, 1).expand(-1, b)


def fs_coefficients(ed_r, ed_s, ed_digest, kes_r, kes_s, kes_digest,
                    gamma, u, v, vrf_s, vrf_pk, alpha, beta_decl):
    """Per-lane Fiat–Shamir coefficients: SHA-512 over the lane's
    transcript (the tag, then the arguments in order, byte rows [n, B])
    -> four [16, B] int64 little-endian 128-bit chunks, each with its low
    bit forced to 1 (odd: coprime to the cofactor)."""
    b = ed_r.shape[-1]
    data = torch.cat([_rows(FS_TAG, b, ed_r.device)]
                     + [x.to(torch.int64) for x in (ed_r, ed_s, ed_digest, kes_r, kes_s,
                                                    kes_digest, gamma, u, v, vrf_s,
                                                    vrf_pk, alpha, beta_decl)])
    z = ph.sha512_fixed(data).clone()
    for k in (0, 16, 32, 48):
        z[k] = z[k] | 1
    return z[0:16], z[16:32], z[32:48], z[48:64]


def _points(*pts) -> torch.Tensor:
    """Points -> [k, B, 40] int32 (point-major, as agg_prep writes)."""
    return torch.stack([pc.stack(p).T for p in pts]).to(torch.int32).contiguous()


def agg_prep_plain(ed_pk, ed_r, ed_s, ed_hb, ed_hnb, kes_vk, kes_per, kes_r, kes_s,
                   kes_leaf, kes_sib, kes_hb, kes_hnb, vrf_pk, vrf_g, vrf_u, vrf_v,
                   vrf_s, vrf_al, beta, tlo, thi, kes_depth: int):
    """The twin of the `agg_prep` kernel over the 22 limb-first arrays ->
    (points [9, B, 40] int32, scalars [12, B, 32] uint8, flags [5, B]
    int32, eta [32, B] int32, leader value [32, B] int32). Flag rows:
    pre_ed, pre_kes, pre_vrf, certain_win, ambiguous."""
    b = ed_pk.shape[-1]
    dev = ed_pk.device
    ok_a, a_pt = pc.decompress(ed_pk)
    ok_re, re_pt = pc.decompress(ed_r)
    ed_dig = ph.sha512_blocks(ed_hb, ed_hnb[0])
    h_ed = fe.reduce512(ed_dig)
    pre_ed = ok_a & ok_re & fe.scalar_lt_l(ed_s)

    ok_al, al_pt = pc.decompress(kes_leaf)
    ok_rk, rk_pt = pc.decompress(kes_r)
    kes_dig = ph.sha512_blocks(kes_hb, kes_hnb[0])
    h_kes = fe.reduce512(kes_dig)
    root_ok = pv.kes_merkle_ok(kes_vk, kes_per[0], kes_leaf, kes_sib, kes_depth)
    period = kes_per[0].to(torch.int64)
    period_ok = (period >= 0) & (period < (1 << kes_depth))
    pre_kes = ok_al & ok_rk & fe.scalar_lt_l(kes_s) & root_ok & period_ok

    ok_y, y_pt = pc.decompress(vrf_pk)
    ok_g, g_pt = pc.decompress(vrf_g)
    ok_u, u_pt = pc.decompress(vrf_u)
    ok_v, v_pt = pc.decompress(vrf_v)
    h_pt = pv.hash_to_curve(vrf_pk, vrf_al)
    (h_enc,) = pc.compress_many([h_pt])
    (g8_enc,) = pc.compress_many([pc.mul_cofactor(g_pt)])
    c16 = ph.sha512_fixed(torch.cat([_rows([pv.SUITE, 0x02], b, dev), h_enc,
                                     *(x.to(torch.int64) for x in (vrf_g, vrf_u, vrf_v))]))[:16]
    beta_p = ph.sha512_fixed(torch.cat([_rows([pv.SUITE, 0x03], b, dev), g8_enc]))
    beta_ok = (beta_p == beta.to(torch.int64)).all(0)
    pre_vrf = ok_y & ok_g & ok_u & ok_v & fe.scalar_lt_l(vrf_s) & beta_ok

    beta_i = beta.to(torch.int64)
    lv = ph.blake2b_fixed(torch.cat([_rows([ord("L")], b, dev), beta_i]), 32)
    eta = ph.blake2b_fixed(ph.blake2b_fixed(torch.cat([_rows([ord("N")], b, dev), beta_i]), 32), 32)
    win = pv._lt_be(lv, tlo.to(torch.int64))
    amb = ~win & pv._lt_be(lv, thi.to(torch.int64))

    z1, z2, z3, z4 = fs_coefficients(ed_r, ed_s, ed_dig, kes_r, kes_s, kes_dig,
                                     vrf_g, vrf_u, vrf_v, vrf_s, vrf_pk, vrf_al, beta)
    rows = [None] * N_SC
    rows[SC_Z1], rows[SC_Z2], rows[SC_Z3], rows[SC_Z4] = (sc.bytes_to_limbs(z) for z in (z1, z2, z3, z4))
    # the eight products mod L in one call, the pairs side by side on the lanes
    pairs = ((SC_Z4C, z4, c16), (SC_Z4S, z4, vrf_s), (SC_Z1H, z1, h_ed), (SC_Z2H, z2, h_kes),
             (SC_Z3C, z3, c16), (SC_B1, z1, ed_s), (SC_B2, z2, kes_s), (SC_B3, z3, vrf_s))
    prod = sc.mul_mod_l(torch.cat([sc.bytes_to_limbs(x) for _r, x, _y in pairs], 1),
                        torch.cat([sc.bytes_to_limbs(y) for _r, _x, y in pairs], 1))
    for k, (r, _x, _y) in enumerate(pairs):
        rows[r] = prod[:, k * b: (k + 1) * b]
    scal = torch.stack([r.T for r in rows]).to(torch.uint8).contiguous()
    pts = _points(pc.neg(rk_pt), pc.neg(u_pt), pc.neg(v_pt), pc.neg(g_pt), h_pt,
                  pc.neg(re_pt), pc.neg(a_pt), pc.neg(al_pt), pc.neg(y_pt))
    flags = torch.stack([pre_ed, pre_kes, pre_vrf, win, amb]).to(torch.int32)
    return pts, scal, flags, eta.to(torch.int32), lv.to(torch.int32)


def _agg_prep_launch(fn, stream, cols, kes_depth):
    from .kernels import _p, _raise_on

    b = cols[0].shape[-1]
    dev = cols[0].device
    pts = torch.empty((N_PTS, b, 40), dtype=torch.int32, device=dev)
    scal = torch.empty((N_SC, b, 32), dtype=torch.uint8, device=dev)
    flags = torch.empty((5, b), dtype=torch.int32, device=dev)
    eta = torch.empty((32, b), dtype=torch.int32, device=dev)
    lv = torch.empty((32, b), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(cols))(*(_p(c) for c in cols))
    rc = fn(b, kes_depth, cols[3].shape[0], cols[11].shape[0], ptrs, _p(pts), _p(scal),
            _p(flags), _p(eta), _p(lv), stream)
    _raise_on(rc, "agg_prep")
    return pts, scal, flags, eta, lv


def agg_prep(*cols, kes_depth: int):
    """The per-lane part of the window aggregate over the 22 limb-first
    arrays of a batch-compatible window (unpack_limb_first's order) ->
    (points [9, B, 40] int32: −R_k, −U, −V, −Γ, H, −R_e, −A_e, −A_l, −Y;
    scalars [12, B, 32] uint8: z2, z3, z4, z4·c, z4·s_v, z1, z1·h_e,
    z2·h_k, z3·c, z1·s_e, z2·s_k, z3·s_v (products mod L); flags [5, B];
    eta [32, B]; leader value [32, B]).

    Replaces the per-lane half of the plain-XLA `aggregate_window`
    (ouroboros_consensus_tpu/ops/pk/aggregate.py:232-326): csrc/
    agg_prep.cu, one launch, 32 lanes a block on ten warps, a role a warp
    (csrc/agg.cuh): eight decompressions (A_e after the OCert digest, R_e,
    V, A_l then the Merkle walk, R_k, Y then the leader value and eta, U,
    Γ then 8·Γ), H (hash to the curve), and the KES digest with the
    Fiat–Shamir transcript beside them. H and 8·Γ are compressed with one
    inversion a block (a product tree over the block's 64 Z coordinates,
    the root inverted on one warp), then c and β'; each mod-L product runs
    on a warp that holds its other factor once z is out. Named barriers
    join only the warps that hand something on. Plain version:
    agg_prep_plain. Bound: operations — nine field exponentiations a lane
    and the block's one inversion, with fifteen or more SHA-512 and ten
    Blake2b compressions; the longest path is one exponentiation, the
    root's inversion on the warp and three compressions."""
    from .kernels import LAUNCHES, _check, _route, _stream

    if len(cols) != 22:
        raise ValueError(f"agg_prep: expected the 22 batch-compatible columns, got {len(cols)}")
    dev = cols[0].device
    b = cols[0].shape[-1]
    rows = (32, 32, 32, None, 1, 32, 1, 32, 32, 32, None, None, 1,
            32, 32, 32, 32, 32, 32, 64, 32, 32)
    names = ("ed_pk", "ed_r", "ed_s", "ed_hb", "ed_hnb", "kes_vk", "kes_per", "kes_r",
             "kes_s", "kes_leaf", "kes_sib", "kes_hb", "kes_hnb", "vrf_pk", "vrf_g",
             "vrf_u", "vrf_v", "vrf_s", "vrf_al", "beta", "thr_lo", "thr_hi")
    shapes = {3: (cols[3].shape[0], 128, b), 10: (kes_depth, 32, b),
              11: (cols[11].shape[0], 128, b)}
    for k, (n, t) in enumerate(zip(names, cols)):
        _check(f"agg_prep.{n}", t, shapes.get(k, (rows[k], b)), dev)
    if _route(dev) == "plain":
        return agg_prep_plain(*cols, kes_depth=kes_depth)
    from . import build

    out = _agg_prep_launch(build.kernel_lib("agg_prep"), _stream(dev), cols, kes_depth)
    LAUNCHES["agg_prep"] += 1
    return out


def _key_words(key: torch.Tensor) -> torch.Tensor:
    """[..., 32, B] key bytes -> [..., 4, B] int64 words whose signed
    order is the bytes' lexicographic order (byte 0 most significant; the
    first byte of a word offset by −128 so that the word fits int64)."""
    k = key.to(torch.int64).reshape(*key.shape[:-2], 4, 8, key.shape[-1])
    w = (k[..., 0, :] - 128) * (1 << 56)
    for j in range(1, 8):
        w = w + k[..., j, :] * (1 << (56 - 8 * j))
    return w


def dedupe_columns_plain(keys: torch.Tensor, coeffs: torch.Tensor, pts: torch.Tensor,
                         cap: int = _DEDUPE_CAP):
    """The twin of the `dedupe` kernel's columns: k repeated-key columns
    collapsed, each into per-distinct-key slots: keys [k, 32, B] bytes,
    coeffs [k, B, 32] uint8 (mod-L bytes), pts [k, B, 40] int32 -> (raw
    slot sums [k * cap, 32] int64 (un-carried byte rows; column c's slots
    at c * cap), slot points [k * cap, 40] int32, ok_cap [k] bool).

    The grouping is exact: each column's keys sort lexicographically
    (four stable sorts over their int64 words, the least significant
    first), a new group starts where a key differs from the one before,
    group ids are contiguous in sorted order. Each slot's point is its
    first sorted lane's; unused slots keep lane perm[0]'s point with
    coefficient 0. A column with more groups than `cap` overflows into its
    last slot and reports ok_cap false. torch.sort, cumsum and index_add_
    on the columns' device, the k columns in each call at once."""
    k, _, b = keys.shape
    dev = keys.device
    words = _key_words(keys)  # [k, 4, b]: each column's own bytes
    perm = torch.arange(b, device=dev).expand(k, b)
    for w in range(3, -1, -1):
        perm = perm.gather(1, torch.sort(words[:, w].gather(1, perm), dim=1, stable=True).indices)
    sk = words.gather(2, perm[:, None].expand(k, 4, b))
    newgrp = torch.ones((k, b), dtype=torch.bool, device=dev)
    newgrp[:, 1:] = (sk[:, :, 1:] != sk[:, :, :-1]).any(1)
    gid = torch.cumsum(newgrp.to(torch.int64), 1) - 1
    ok_cap = gid[:, -1] < cap
    slot = (gid.clamp(max=cap - 1)
            + cap * torch.arange(k, device=dev).reshape(k, 1)).reshape(-1)
    raw = torch.zeros((k * cap, 32), dtype=torch.int64, device=dev).index_add_(
        0, slot, coeffs.gather(1, perm[..., None].expand(k, b, 32)).reshape(k * b, 32)
        .to(torch.int64))
    iota = torch.arange(b, device=dev).expand(k, b)
    starts = torch.zeros(k * cap, dtype=torch.int64, device=dev).index_add_(
        0, slot, torch.where(newgrp, iota, 0).reshape(-1)).clamp(max=b - 1)
    rep = perm.gather(1, starts.reshape(k, cap))
    return raw, pts.gather(1, rep[..., None].expand(k, cap, 40)).reshape(k * cap, 40), ok_cap


def dedupe_column(key: torch.Tensor, coeff: torch.Tensor, pts: torch.Tensor,
                  cap: int = _DEDUPE_CAP):
    """`dedupe_columns_plain` of one column: key [32, B], coeff [B, 32],
    pts [B, 40] -> (raw [cap, 32], slot points [cap, 40], ok_cap []
    bool)."""
    raw, tp, ok = dedupe_columns_plain(key[None], coeff[None], pts[None], cap)
    return raw, tp, ok[0]


def _dedupe_shape(b: int) -> tuple[int, int, int]:
    """The dedupe launch at `b` lanes -> (blocks, scratch bytes, tickets):
    a block a tile of DEDUPE_TILE lanes of each column; the lists in three
    buffers (32 key and 16 meta bytes an entry: the tiles', then the merge
    levels' by turns), the tiles' groups' sums (128 bytes), a flag word a
    lane, the B row's tile sums, each node's list length; a ticket a node
    and one for the B row (csrc/agg.cuh: dd_scratch_bytes,
    dd_ticket_count)."""
    t = -(-b // DEDUPE_TILE)
    ne = t * DEDUPE_TILE
    return (4 * t, ne * (3 * 4 * (32 + 16) + 4 * (128 + 4)) + t * (3 * 128 + 4 * _DD_LEVELS * 4),
            4 * _DD_LEVELS * t + 1)


_WORKSPACE: dict = {}


def _workspace(dev, stream, scratch_bytes: int, n_tickets: int):
    """The dedupe's scratch (at least `scratch_bytes`, any contents) and
    zero int32 tickets (at least `n_tickets`) for launches on `stream` of
    `dev`. Kept between calls: the tickets (4 bytes a node: 2 MB at
    DEDUPE_MAX_LANES) and a scratch of at most _SCRATCH_KEEP bytes
    (launches on one stream do not overlap, the scratch is spent within a
    launch, and each launch leaves its tickets zero: the last arrival at a
    ticket resets it). A wider window's scratch is its call's own, handed
    back to torch's allocator when the call returns."""
    key = (str(dev), stream)
    kept, tickets = _WORKSPACE.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    if scratch_bytes > _SCRATCH_KEEP:
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    elif kept is None or kept.numel() < scratch_bytes:
        scratch = kept = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    else:
        scratch = kept
    _WORKSPACE[key] = (kept, tickets)
    return scratch, tickets


def _dedupe_launch(fn, stream, keys, coeffs: int, pts: int, brows: int, cap: int):
    """One call of pk_dedupe (`fn`: the CUDA launcher, or the host build's)
    over the four key columns `keys` ([32, B] int32 each) and the addresses
    of coeffs [4, B, 32] uint8, pts [4, B, 40] int32 and the B row's rows
    brows [3, B, 32] uint8 (contiguous) -> (red [4 * cap + 1, 32] uint8,
    slot points [4 * cap, 40], ok_cap [4], rc). The scratch and the
    tickets are the stream's own (`_workspace`)."""
    from .kernels import _p

    b = keys[0].shape[-1]
    dev = keys[0].device
    _blocks, scratch_bytes, n_tickets = _dedupe_shape(b)
    red = torch.empty((4 * cap + 1, 32), dtype=torch.uint8, device=dev)
    tpts = torch.empty((4 * cap, 40), dtype=torch.int32, device=dev)
    ok = torch.empty(4, dtype=torch.bool, device=dev)
    scratch, tickets = _workspace(dev, stream, scratch_bytes, n_tickets)
    rc = fn(b, cap, _p(keys[0]), _p(keys[1]), _p(keys[2]), _p(keys[3]), coeffs, pts,
            brows, _p(scratch), scratch_bytes, _p(tickets), _p(red), _p(tpts), _p(ok), stream)
    return red, tpts, ok, rc


def window_tables_plain(cols, pts: torch.Tensor, scal: torch.Tensor, cap: int):
    """The twin of `window_tables` (the `dedupe` kernel with its B row)."""
    traw, tpts, ok_cap = dedupe_columns_plain(torch.stack([cols[k] for k in DEDUPE_KEYS]),
                                              scal[SC_Z1:SC_Z3C + 1], pts[PT_RE:PT_Y + 1],
                                              cap)
    braw = scal[SC_B1:SC_B3 + 1].to(torch.int64).sum((0, 1))[None]
    return torch.cat([traw, braw]), tpts, ok_cap


def window_tables_reduced_plain(cols, pts: torch.Tensor, scal: torch.Tensor, cap: int):
    """The twin of `window_tables`: window_tables_plain's rows reduced mod L
    (agg_tables_plain), its slot points and ok_cap."""
    raw, tpts, ok_cap = window_tables_plain(cols, pts, scal, cap)
    return agg_tables_plain(raw), tpts, ok_cap


def window_tables(cols, pts: torch.Tensor, scal: torch.Tensor):
    """The dedupe of a window's four repeated-key columns (agg_prep's
    points and scalars) into _DEDUPE_CAP slots each (read at the call),
    the slot sums and the lane sums of its B coefficient reduced mod L ->
    (red [4 * cap + 1, 32] uint8, each row below L: the slots, then the B
    coefficient; slot points [4 * cap, 40]; ok_cap [4]).

    Replaces the plain-XLA `_dedupe_column` ×4, `reduce_raw_sums` of its
    tables and the window-wide `sum_mod_l` of the B coefficient
    (ouroboros_consensus_tpu/ops/pk/aggregate.py:153, :189, :295;
    ops/pk/limbs.py:489, :502; a lax.sort over the 32 key bytes and the
    lane index, cumsum, scatter-adds; never a hash): csrc/dedupe.cu, one
    launch, one path for every width — a block of 256 threads a tile of
    256 lanes of a column (each lane's key compared with the tile's, the
    tile's distinct keys ranked and their coefficient bytes summed, the
    tiles of columns 0-2 also sum a B row), the tiles' sorted lists of
    keys merged up a tree of atomic tickets (four children a node,
    equal keys joined, the lowest lane kept), and the block that
    completes a column's root ranks every tile group in it, adds its sums
    to its slot's and reduces the slots mod L, a thread a slot; the last
    tile of columns 0-2 the B row. Plain version:
    window_tables_reduced_plain.
    Bound: bytes (keys, coefficients and B rows read once, the slots
    written once)."""
    from . import build
    from .kernels import LAUNCHES, _raise_on, _route, _stream

    dev = pts.device
    keys = [cols[k] for k in DEDUPE_KEYS]
    b = keys[0].shape[-1]
    # one pass of cheap tests; the named checks only to word a failure
    if not (pts.dtype == torch.int32 and pts.shape == (N_PTS, b, 40) and pts.is_contiguous()
            and scal.dtype == torch.uint8 and scal.shape == (N_SC, b, 32)
            and scal.is_contiguous() and scal.device == dev
            and all(k.dtype == torch.int32 and k.shape == (32, b) and k.is_contiguous()
                    and k.device == dev for k in keys)):
        from .kernels import _check
        for c, key in enumerate(keys):
            _check(f"dedupe.keys[{c}]", key, (32, b), dev)
        _check("dedupe.pts", pts, (N_PTS, b, 40), dev)
        _check("dedupe.scal", scal, (N_SC, b, 32), dev, torch.uint8)
    if _route(dev) == "plain":
        return window_tables_reduced_plain(cols, pts, scal, _DEDUPE_CAP)
    if b > DEDUPE_MAX_LANES:
        raise ValueError(f"dedupe: {b} lanes, the kernel takes at most {DEDUPE_MAX_LANES}")
    # the rows' addresses (no slices: a tensor view costs microseconds)
    sp = scal.data_ptr()
    red, tpts, ok, rc = _dedupe_launch(build.kernel_lib("dedupe"), _stream(dev), keys,
                                       sp + SC_Z1 * b * 32, pts.data_ptr() + PT_RE * b * 160,
                                       sp + SC_B1 * b * 32, _DEDUPE_CAP)
    _raise_on(rc, "dedupe")
    LAUNCHES["dedupe"] += 1
    return red, tpts, ok


def msm_inputs(pts: torch.Tensor, scal: torch.Tensor, tpts: torch.Tensor,
               red: torch.Tensor):
    """msm's arguments for a window: the 128-bit group's columns, the wide
    group's per-lane columns and the tables' slots (window_tables' reduced
    rows `red`, the B coefficient last) -> (points, scalars, n_small,
    base)."""
    b = pts.shape[1]
    points = torch.cat([pts[:N_LANE_COLS].reshape(N_LANE_COLS * b, 40), tpts])
    scalars = torch.cat([scal[:N_LANE_COLS].reshape(N_LANE_COLS * b, 32), red[:-1]])
    return points, scalars, N_SMALL_COLS * b, red[-1].contiguous()


def agg_tables_plain(raw: torch.Tensor) -> torch.Tensor:
    """The mod-L reductions of window_tables_plain's rows: [R, 32] int64
    un-carried byte rows -> [R, 32] uint8 of each value mod L (the
    reference's reduce_raw_sums of the tables and sum_mod_l of the B
    coefficient; the dedupe kernel's agg_table_row)."""
    return sc.reduce_raw_sums(raw.T).T.to(torch.uint8).contiguous()


def aggregate_window(*cols, kes_depth: int) -> AggregateVerdicts:
    """Aggregated verification of one batch-compatible window over the 22
    limb-first arrays (unpack_limb_first's order: ed, kes, vrf_pk, Γ, U,
    V, s, alpha, beta, thr_lo, thr_hi)."""
    pts, scal, flags, eta, lv = agg_prep(*cols, kes_depth=kes_depth)
    red, tpts, ok_cap = window_tables(cols, pts, scal)
    _total, ident = pm.msm(*msm_inputs(pts, scal, tpts, red))
    agg_ok = (ident[0] != 0) & ok_cap.all()
    pre_ok = (flags[:3] != 0).all()
    flags = torch.cat([flags[:3] * agg_ok.to(torch.int32), flags[3:]])
    return AggregateVerdicts(flags, eta, lv, agg_ok, pre_ok)
