"""Batched Praos header validation over the per-lane stage kernels.

A within-epoch window of header views is validated as one batch: the
cheap non-crypto checks run on the host (`host_prechecks`), the window
stages into the packed wire format (`stage_packed` — the KES-signed body
is the single copy of every field it embeds, verified lane for lane),
the `unpack` kernel writes the stage kernels' limb-first columns from it
(field slices, SHA-512 padding, the VRF alpha), five stage kernels
return per-lane verdict bits (ed, kes, the VRF prep of the window's
proof format — `vrf_prep` for 80-byte draft-03 proofs, `vrf_bc_prep`
for 128-byte batch-compatible ones — the VRF ladders and finish), while
the `nonce_fold` kernel folds the window's nonces from the declared VRF
outputs on a side stream beside them; `verdict_reduce` packs the verdict
bits into u32 words and joins the fold. The fold's carry goes from each
packed window to the next on the card; the host reads the mask words
and the 66 carry bytes. The sequential epilogue finds
the first failing header and rebuilds the exact `PraosValidationError`
the reference fold would raise, in its order (Praos.hs:441-606: KES
checks before VRF checks).

A window comes as a HeaderView list or as `ViewColumns` (the reader's
columnar windows). A ViewColumns window runs the columnar twin of each
host stage: `host_prechecks_columns` (whole-column KES window checks,
one pool lookup per unique (cold key, VRF key) pair), then
`stage_packed_columns` (the body column is the window's signed-bytes
matrix; six whole-matrix field compares) and `_epilogue_columns_fast`
(counters checked per unique pool over column slices); no HeaderView is
built unless a gate trips, and then the exact per-header path runs.

A window the packed staging declines for one of GENERIC_REASONS (bodies
that do not embed the fields, integers past int32, bodies of several
widths) goes through the generic staging instead (`stage_any`: per-lane
columns padded on the host) and the same five stage kernels; the reason
is recorded in `DECLINES`. Such a window ships its eta column and folds
on the host, which breaks the carry chain: the next packed window seeds
it again from the host state.

The leader threshold is a bracketed device compare; the measure-zero
band between the brackets takes the exact host check.

`validate_chain` segments a run of headers at epoch boundaries, at
`max_batch` and where the proof format changes (a window stages one
proof column; segmentation never changes a verdict), threading the
PraosState and the nonce carry between windows. On the device it runs
them as a pipeline (the reference's `_device_loop`): a window's host half
(`prepare_window`: prechecks, staging and padding into a staging buffer,
pinned on the card) runs on a staging thread up to `pipeline_depth`
windows ahead, its device half (`dispatch_prepared`: the uploads, kernels
and the copies of the results back, none of which waits for the card) on
the calling thread in window order with up to `pipeline_depth` windows in
flight, and each window retires in order with its epilogue once its
results are on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from fractions import Fraction
from functools import cached_property, lru_cache
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..testing import chaos
from ..ops import stage_np
from ..ops.pk import hashes as ph
from ..ops.pk import kernels as pk_kernels
from . import leader, nonces, praos
from .praos import PraosParams, PraosState, TickedPraosState
from .views import HeaderView, LedgerView, ViewColumns, hash_key, hash_vrf_vk

# ---------------------------------------------------------------------------
# Host prechecks and leader thresholds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HostChecks:
    """Per-lane results of the non-crypto checks: None = pass, else the
    error the reference raises, split KES-side / VRF-side because the
    reference interleaves them with the crypto verdicts (Praos.hs:441-466)."""

    kes_window_errors: list  # KESBeforeStart / KESAfterEnd (Praos.hs:560-574)
    vrf_lookup_errors: list  # VRFKeyUnknown / WrongVRFKey (Praos.hs:530-540)
    kes_evolution: np.ndarray  # [B] int64 — t = kes_period - c0 (0 on error)

    def any_errors(self) -> bool:
        return (any(e is not None for e in self.kes_window_errors)
                or any(e is not None for e in self.vrf_lookup_errors))


@dataclass(frozen=True)
class ColumnChecks(HostChecks):
    """HostChecks of a ViewColumns window, with its pool dedup, so that
    the threshold tables, the counter checks and the native leader
    compare look each pool up once."""

    uniq_inv: np.ndarray  # [B] int32: lane -> unique (cold key, VRF key) pair
    uniq_hk: tuple  # KeyHash of each unique pair
    uniq_entry: tuple  # IndividualPoolStake (or None) of each unique pair
    clean: bool = False  # no precheck error in any lane

    def any_errors(self) -> bool:
        return not self.clean


def host_prechecks(params: PraosParams, ledger_view: LedgerView,
                   hvs: "Sequence[HeaderView] | ViewColumns") -> HostChecks:
    """The non-crypto checks of validateKESSignature (the KES window,
    Praos.hs:558-574) and validateVRFSignature (the pool lookups,
    :528-540) over a window; a ViewColumns window takes
    host_prechecks_columns."""
    if isinstance(hvs, ViewColumns):
        return host_prechecks_columns(params, ledger_view, hvs)
    kes_errors: list = [None] * len(hvs)
    vrf_errors: list = [None] * len(hvs)
    evol = np.zeros((len(hvs),), np.int64)
    for i, hv in enumerate(hvs):
        c0 = hv.ocert.kes_period
        kp = params.kes_period_of(hv.slot)
        if not c0 <= kp:
            kes_errors[i] = praos.KESBeforeStartOCERT(c0, kp)
        elif not kp < c0 + params.max_kes_evolutions:
            kes_errors[i] = praos.KESAfterEndOCERT(kp, c0, params.max_kes_evolutions)
        else:
            evol[i] = kp - c0
        hk = hash_key(hv.vk_cold)
        entry = ledger_view.pool_distr.get(hk)
        if entry is None:
            vrf_errors[i] = praos.VRFKeyUnknown(hk)
        else:
            header_vrf_hash = hash_vrf_vk(hv.vrf_vk)
            if entry.vrf_key_hash != header_vrf_hash:
                vrf_errors[i] = praos.VRFKeyWrongVRFKey(
                    hk, entry.vrf_key_hash, header_vrf_hash
                )
    return HostChecks(kes_errors, vrf_errors, evol)


def _dedup_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(unique rows [k, w], inverse [n]) of a [n, w] uint8 matrix, as
    np.unique(axis=0) groups them but without its byte-wise sort: rows
    are grouped by a 64-bit Horner fingerprint of their u64 words, and
    the grouping is verified by one exact gather-compare (a fingerprint
    collision falls back to np.unique). The unique rows come in
    fingerprint order."""
    n, w = rows.shape
    if n == 0:
        return rows.copy(), np.zeros(0, np.int64)
    padded = np.zeros((n, w + (-w) % 8), np.uint8)
    padded[:, :w] = rows
    words = padded.view(np.uint64)
    h = np.zeros(n, np.uint64)
    mult = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        for c in range(words.shape[1]):
            h = h * mult + words[:, c]
    uh, inv = np.unique(h, return_inverse=True)
    first = np.full(uh.shape[0], -1, np.int64)
    first[inv[::-1]] = np.arange(n - 1, -1, -1)  # each group's lowest lane
    uniq = rows[first]
    if not np.array_equal(uniq[inv], rows):
        return np.unique(rows, axis=0, return_inverse=True)
    return uniq, inv


def host_prechecks_columns(params: PraosParams, ledger_view: LedgerView,
                           vc: ViewColumns) -> ColumnChecks:
    """host_prechecks of a ViewColumns window: the same verdicts and
    error objects (the KES-window errors built before the pool lookups),
    the window arithmetic over whole columns and the pool lookups once
    per unique (cold key, VRF key) pair."""
    n = len(vc)
    c0 = vc.ocert_kes_period
    kp = vc.slot // params.slots_per_kes_period
    before = c0 > kp
    after = ~before & (kp >= c0 + params.max_kes_evolutions)
    bad_window = before | after
    evol = np.where(bad_window, 0, kp - c0).astype(np.int64)
    kes_errors: list = [None] * n
    for i in np.flatnonzero(before).tolist():
        kes_errors[i] = praos.KESBeforeStartOCERT(int(c0[i]), int(kp[i]))
    for i in np.flatnonzero(after).tolist():
        kes_errors[i] = praos.KESAfterEndOCERT(int(kp[i]), int(c0[i]),
                                               params.max_kes_evolutions)
    uniq, inv = _dedup_rows(np.concatenate([vc.vk_cold, vc.vrf_vk], axis=1))
    hks, entries, uerrs = [], [], []
    for row in uniq:
        hk = hash_key(row[:32].tobytes())
        entry = ledger_view.pool_distr.get(hk)
        hks.append(hk)
        entries.append(entry)
        if entry is None:
            uerrs.append(praos.VRFKeyUnknown(hk))
            continue
        header_vrf_hash = hash_vrf_vk(row[32:].tobytes())
        uerrs.append(None if entry.vrf_key_hash == header_vrf_hash else
                     praos.VRFKeyWrongVRFKey(hk, entry.vrf_key_hash, header_vrf_hash))
    lookups_clean = all(e is None for e in uerrs)
    vrf_errors = [None] * n if lookups_clean else [uerrs[j] for j in inv.tolist()]
    return ColumnChecks(kes_errors, vrf_errors, evol, inv.astype(np.int32),
                        tuple(hks), tuple(entries),
                        not bad_window.any() and lookups_clean)


@lru_cache(maxsize=4096)
def threshold_rows(sigma: Fraction, f: Fraction) -> tuple[bytes, bytes]:
    """Big-endian 32-byte (lo, hi) leader brackets, clamped to the
    256-bit compare domain."""
    lo, hi = leader.threshold_bracket(sigma, f)
    top = (1 << 256) - 1
    return min(lo, top).to_bytes(32, "big"), min(hi, top).to_bytes(32, "big")


def _sigma(ledger_view: LedgerView, hv: HeaderView) -> Fraction:
    entry = ledger_view.pool_distr.get(hash_key(hv.vk_cold))
    return entry.stake if entry is not None else Fraction(0)


def _uniq_threshold_rows(params: PraosParams, pre: ColumnChecks) -> np.ndarray:
    """[k, 64] thr_lo ‖ thr_hi of each unique pool of the precheck dedup
    (an unknown pool has stake 0)."""
    f = Fraction(params.active_slot_coeff)
    rows = [b"".join(threshold_rows(e.stake if e is not None else Fraction(0), f))
            for e in pre.uniq_entry]
    return np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), 64).copy()


def _uniq_threshold_tables(params: PraosParams,
                           pre: ColumnChecks) -> tuple[np.ndarray, np.ndarray]:
    """(thr_lo [B, 32], thr_hi [B, 32]): the unique rows gathered per lane."""
    t = _uniq_threshold_rows(params, pre)[pre.uniq_inv]
    return np.ascontiguousarray(t[:, :32]), np.ascontiguousarray(t[:, 32:])


# ---------------------------------------------------------------------------
# Packed staging (host) and unpack (device)
# ---------------------------------------------------------------------------


class PackedLayout(NamedTuple):
    """Per-window descriptor: offsets INTO the KES-signed body of each
    field the device extracts (verified lane for lane by stage_packed)."""

    body_len: int
    o_issuer: int  # vk_cold (32)
    o_vrf_vk: int  # vrf_vk (32)
    o_vrf_out: int  # declared beta (64)
    o_vrf_proof: int  # gamma ‖ c ‖ s (80) or gamma ‖ u ‖ v ‖ s (128)
    o_vk_hot: int  # OCert KES root vk (32)
    o_sigma: int  # OCert cold-key signature R ‖ s (64)
    kes_depth: int
    slots_per_kes: int
    has_nonce: bool  # False = neutral epoch nonce
    vrf_proof_len: int  # 80 = draft-03, 128 = batch-compatible


class Packed(NamedTuple):
    """Packed window columns: numpy on the host (`stage_packed`), torch
    tensors of the same dtypes on the card (`upload_packed`)."""

    body: np.ndarray  # [B, body_len] uint8
    kes_rs: np.ndarray  # [B, 64] uint8 — KES leaf signature R ‖ s
    kes_tail_idx: np.ndarray  # [B] int32 into kes_tail_tab
    kes_tail_tab: np.ndarray  # [Kt, 32 + 32 depth] uint8 — leaf vk ‖ siblings
    slot: np.ndarray  # [B] int32
    counter: np.ndarray  # [B] int32 — OCert issue number
    c0: np.ndarray  # [B] int32 — OCert start KES period
    thr_idx: np.ndarray  # [B] int32 into thr_tab
    thr_tab: np.ndarray  # [Kr, 64] uint8 — thr_lo ‖ thr_hi per stake
    nonce: np.ndarray  # [32] uint8 — epoch nonce bytes (zeros if neutral)
    within: np.ndarray  # [B] uint8 — slot inside the stability window


class NotStagedError(NotImplementedError):
    """A window the packed staging does not take; `reason` names the gate.
    `dispatch_window` stages the GENERIC_REASONS windows generically (a
    list window whose bodies differ in width among them: `validate_chain`
    does not cut at a width change) and raises on the others.
    `validate_chain` never hands over a `proof-format` window (it cuts at
    a format change), but it does hand over a `kes-sig-len` one (a KES
    signature whose length does not match the parameters' depth), so a
    chain with such a header raises, as the reference's device path
    does."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# the packed-staging declines that the generic staging takes
GENERIC_REASONS = frozenset({"field-offsets", "field-mismatch", "int32-range",
                             "body-width-mixed"})


def stage_packed(params: PraosParams, ledger_view: LedgerView,
                 epoch_nonce: nonces.Nonce,
                 hvs: Sequence[HeaderView]) -> tuple[PackedLayout, Packed]:
    """Columnarize a window into the packed format. Qualification is
    verified, not assumed: one body width, one proof length (80 or 128
    bytes), every extracted field equal to the parsed view field in every
    lane at the lane-0 offsets, int32 integers. Raises NotStagedError
    otherwise."""
    b = len(hvs)
    h0 = hvs[0]
    body0 = h0.signed_bytes
    lb = len(body0)
    if any(len(hv.signed_bytes) != lb for hv in hvs):
        raise NotStagedError("body-width-mixed")
    depth = params.kes_depth
    sig_len = 64 + 32 + 32 * depth
    if any(len(hv.kes_sig) != sig_len for hv in hvs):
        raise NotStagedError("kes-sig-len")
    plen = len(h0.vrf_proof)
    if plen not in (80, 128) or any(len(hv.vrf_proof) != plen for hv in hvs):
        raise NotStagedError("proof-format")
    fields0 = (h0.vk_cold, h0.vrf_vk, h0.vrf_output, h0.vrf_proof,
               h0.ocert.vk_hot, h0.ocert.sigma)
    offs = tuple(body0.find(f) for f in fields0)
    if min(offs) < 0:
        raise NotStagedError("field-offsets")
    body = np.frombuffer(b"".join(hv.signed_bytes for hv in hvs),
                         np.uint8).reshape(b, lb)

    def col(parts, n):
        return np.frombuffer(b"".join(parts), np.uint8).reshape(b, n)

    refs = (
        (offs[0], col([hv.vk_cold for hv in hvs], 32)),
        (offs[1], col([hv.vrf_vk for hv in hvs], 32)),
        (offs[2], col([hv.vrf_output for hv in hvs], 64)),
        (offs[3], col([hv.vrf_proof for hv in hvs], plen)),
        (offs[4], col([hv.ocert.vk_hot for hv in hvs], 32)),
        (offs[5], col([hv.ocert.sigma for hv in hvs], 64)),
    )
    for o, ref in refs:
        if not np.array_equal(body[:, o: o + ref.shape[1]], ref):
            raise NotStagedError("field-mismatch")
    slot = np.fromiter((hv.slot for hv in hvs), np.int64, b)
    counter = np.fromiter((hv.ocert.counter for hv in hvs), np.int64, b)
    c0 = np.fromiter((hv.ocert.kes_period for hv in hvs), np.int64, b)
    for a in (slot, counter, c0):
        if a.min() < 0 or a.max() >= 2**31:
            raise NotStagedError("int32-range")
    sigs = col([hv.kes_sig for hv in hvs], sig_len)
    tails: dict[bytes, int] = {}
    kt_idx = np.empty(b, np.int32)
    for i, hv in enumerate(hvs):
        kt_idx[i] = tails.setdefault(hv.kes_sig[64:], len(tails))
    kt_tab = np.stack([np.frombuffer(t, np.uint8) for t in tails])
    f = Fraction(params.active_slot_coeff)
    rows: dict = {}
    thr_idx = np.empty(b, np.int32)
    for i, hv in enumerate(hvs):
        lo, hi = threshold_rows(_sigma(ledger_view, hv), f)
        thr_idx[i] = rows.setdefault(lo + hi, len(rows))
    thr_tab = np.stack([np.frombuffer(r, np.uint8) for r in rows])
    first_next = (slot // params.epoch_length + 1) * params.epoch_length
    layout = PackedLayout(lb, *offs, depth, params.slots_per_kes_period,
                          epoch_nonce is not None, plen)
    packed = Packed(
        body=body.copy(), kes_rs=np.ascontiguousarray(sigs[:, :64]),
        kes_tail_idx=kt_idx, kes_tail_tab=kt_tab, slot=slot.astype(np.int32),
        counter=counter.astype(np.int32), c0=c0.astype(np.int32),
        thr_idx=thr_idx, thr_tab=thr_tab,
        nonce=np.frombuffer(epoch_nonce or bytes(32), np.uint8).copy(),
        within=(slot + params.stability_window < first_next).astype(np.uint8),
    )
    return layout, packed


def _owned(a: np.ndarray) -> np.ndarray:
    """`a` as a C-contiguous, writable array (a copy of a strided or
    read-only view into a chunk's bytes), so that the upload takes it
    as it is."""
    return a if a.flags.c_contiguous and a.flags.writeable else np.array(a)


def _be8_np(a: np.ndarray) -> np.ndarray:
    """[n] non-negative int64 -> [n, 8] uint8 big-endian rows."""
    return np.ascontiguousarray(a).astype(">u8").view(np.uint8).reshape(-1, 8)


def stage_packed_columns(params: PraosParams, ledger_view: LedgerView,
                         epoch_nonce: nonces.Nonce, vc: ViewColumns,
                         pre: ColumnChecks) -> tuple[PackedLayout, Packed]:
    """stage_packed of a ViewColumns window, on the same gates and with
    the same reasons: the body column is the window's signed-bytes
    matrix, the field check six whole-matrix compares, the KES-tail table
    one `_dedup_rows` and the threshold table the precheck's pool dedup.
    The lanes equal stage_packed's; the tables may be in another order
    (each lane's index points at the same row)."""
    body = vc.signed_bytes
    depth = params.kes_depth
    sig_len = 64 + 32 + 32 * depth
    if vc.kes_sig.shape[1] != sig_len:
        raise NotStagedError("kes-sig-len")
    plen = int(vc.vrf_proof_len[0])
    if plen not in (80, 128) or not (vc.vrf_proof_len == plen).all():
        raise NotStagedError("proof-format")
    refs = (vc.vk_cold, vc.vrf_vk, vc.vrf_output, vc.vrf_proof[:, :plen],
            vc.ocert_vk_hot, vc.ocert_sigma)
    body0 = body[0].tobytes()
    offs = tuple(body0.find(r[0].tobytes()) for r in refs)
    if min(offs) < 0:
        raise NotStagedError("field-offsets")
    for o, ref in zip(offs, refs):
        if not np.array_equal(body[:, o: o + ref.shape[1]], ref):
            raise NotStagedError("field-mismatch")
    slot, counter, c0 = vc.slot, vc.ocert_counter, vc.ocert_kes_period
    for a in (slot, counter, c0):
        if a.min() < 0 or a.max() >= 2**31:
            raise NotStagedError("int32-range")
    kt_tab, kt_idx = _dedup_rows(vc.kes_sig[:, 64:])
    first_next = (slot // params.epoch_length + 1) * params.epoch_length
    layout = PackedLayout(int(body.shape[1]), *offs, depth, params.slots_per_kes_period,
                          epoch_nonce is not None, plen)
    packed = Packed(
        body=_owned(body), kes_rs=_owned(vc.kes_sig[:, :64]),
        kes_tail_idx=kt_idx.astype(np.int32), kes_tail_tab=kt_tab,
        slot=slot.astype(np.int32), counter=counter.astype(np.int32),
        c0=c0.astype(np.int32), thr_idx=pre.uniq_inv.astype(np.int32),
        thr_tab=_uniq_threshold_rows(params, pre),
        nonce=np.frombuffer(epoch_nonce or bytes(32), np.uint8).copy(),
        within=(slot + params.stability_window < first_next).astype(np.uint8),
    )
    return layout, packed


def bucket_size(b: int, minimum: int = 8) -> int:
    """Lane bucket: next power of two up to 2048, then the next multiple
    of 2048 (bounds tail padding at under 2048 lanes)."""
    n = minimum
    while n < b and n < 2048:
        n *= 2
    if b <= n:
        return n
    return ((b + 2047) // 2048) * 2048


# the packed columns that have one row a lane (padded to the bucket)
LANE_COLUMNS = ("body", "kes_rs", "kes_tail_idx", "slot", "counter", "c0", "thr_idx",
                "within")
_ALIGN = 16  # each column's offset in a staging buffer


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _padded_shape(name: str, x: np.ndarray, size: int) -> tuple:
    return (size, *x.shape[1:]) if name in LANE_COLUMNS else x.shape


def packed_bytes_bound(b: int, body_len: int, kes_depth: int) -> int:
    """Bytes enough for the padded packed columns of a b-header window
    of `body_len`-byte bodies in one buffer (`pad_packed_into`): the
    lane columns at the bucket's width, each table at one row a header
    at most, every column aligned."""
    lanes = bucket_size(b)
    row_bytes = {"body": body_len, "kes_rs": 64, "kes_tail_tab": 32 + 32 * kes_depth,
                 "thr_tab": 64, "nonce": 32, "within": 1}  # the others: one int32

    def rows(name):
        return lanes if name in LANE_COLUMNS else 1 if name == "nonce" else b

    return sum(_aligned(rows(f) * row_bytes.get(f, 4)) for f in Packed._fields)


def pad_packed_into(packed: Packed, size: int, buf: np.ndarray) -> Packed:
    """Pad the LANE_COLUMNS to `size` lanes by replicating lane 0 (tables
    and the nonce are shared), written into `buf` (a uint8 staging
    buffer: `staging_buffer`'s, pinned on the card), each column at an
    aligned offset. Padding lanes are computed and ignored: every
    consumer slices to the real lanes. -> the columns as views of
    `buf`."""
    b = packed.body.shape[0]
    out = []
    off = 0
    for name, x in zip(Packed._fields, packed):
        shape = _padded_shape(name, x, size)
        n = int(np.prod(shape)) * x.itemsize
        if off + n > buf.nbytes:
            raise ValueError(f"staging buffer of {buf.nbytes} bytes is too small")
        view = buf[off: off + n].view(x.dtype).reshape(shape)
        view[: len(x)] = x
        if name in LANE_COLUMNS and size > b:
            view[b:] = x[:1]
        out.append(view)
        off += _aligned(n)
    return Packed(*out)


def pad_packed_to(packed: Packed, size: int) -> Packed:
    """pad_packed_into a new host buffer of the bytes the padded columns
    take."""
    n = sum(_aligned(int(np.prod(_padded_shape(name, x, size))) * x.itemsize)
            for name, x in zip(Packed._fields, packed))
    return pad_packed_into(packed, size, np.empty(n, np.uint8))


def staging_buffer(params: PraosParams, hvs, device: torch.device) -> torch.Tensor:
    """The host buffer a window's packed columns are staged into
    (`pad_packed_into`): pinned on the card, so that their upload need
    not wait for it, plain host memory otherwise. Allocated by the
    thread that launches (the staging thread touches host memory
    only)."""
    if isinstance(hvs, ViewColumns):
        body_len = hvs.signed_bytes.shape[1]
    else:
        body_len = max(len(hv.signed_bytes) for hv in hvs)
    n = packed_bytes_bound(len(hvs), body_len, params.kes_depth)
    return torch.empty(n, dtype=torch.uint8, pin_memory=device.type == "cuda")


_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}


def upload_staged(packed: Packed, buf: torch.Tensor, device) -> Packed:
    """Packed columns that are views of the staging buffer `buf` -> the
    same columns on `device`, views of one buffer there filled by one
    copy (from pinned memory on the card: a copy that does not wait for
    it)."""
    base = buf.data_ptr()
    offs = [a.ctypes.data - base for a in packed]
    used = max(o + a.nbytes for o, a in zip(offs, packed))
    dev = torch.empty(used, dtype=torch.uint8, device=device)
    dev.copy_(buf[:used], non_blocking=True)
    return Packed(*(dev[o: o + a.nbytes].view(_TORCH_DTYPE[a.dtype]).view(a.shape)
                    for o, a in zip(offs, packed)))


def upload_packed(packed: Packed, device) -> Packed:
    """The packed columns on `device`, dtypes as they are (uint8 bytes,
    int32 integers); columns already there are not copied."""
    return Packed(*(torch.as_tensor(a, device=device) for a in packed))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to the card through pinned memory, by a
    copy that does not wait for the card."""
    t = torch.from_numpy(_owned(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A tensor's copy on the host: from the card into pinned memory, by
    a copy that does not wait (read it after an event recorded behind
    it); a host tensor as it is."""
    if t.device.type != "cuda":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def _be8(x: torch.Tensor) -> torch.Tensor:
    """[B] int64 in [0, 2^31) -> [B, 8] big-endian bytes."""
    sh = torch.tensor([56, 48, 40, 32, 24, 16, 8, 0], device=x.device)
    return (x.unsqueeze(1) >> sh) & 0xFF


def _pad_blocks(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, n] messages of one length -> ([B, NB, 128] padded blocks,
    [B] block counts)."""
    blocks, nb = ph.pad_sha512(data.T)
    b = data.shape[0]
    return (blocks.permute(2, 0, 1).contiguous(),
            torch.full((b,), nb, dtype=torch.int64, device=data.device))


def alpha_from_slots(slot: torch.Tensor, nonce: torch.Tensor | None) -> torch.Tensor:
    """mkInputVRF on the device: Blake2b-256(slot_be8 ‖ nonce bytes);
    the neutral nonce contributes no bytes. -> [B, 32]."""
    data = _be8(slot)
    if nonce is not None:
        data = torch.cat([data, nonce.to(torch.int64).unsqueeze(0).expand(slot.shape[0], 32)], 1)
    return ph.blake2b_fixed(data.T, 32).T


def unpack_packed(layout: PackedLayout, packed: Packed, device) -> tuple:
    """Packed columns (numpy, or tensors) -> the batch-first staged
    columns on `device`: the 21 of kernels.staged_to_limb_first for an
    80-byte draft-03 proof (gamma ‖ c ‖ s split at 32 / 48), the 22 of
    staged_to_limb_first_bc for a 128-byte one (gamma ‖ u ‖ v ‖ s). Field
    slices of the body, the Ed25519 and KES SHA-512 inputs padded into
    blocks, the VRF alpha, the KES evolution t = kes_period_of(slot) - c0
    and the per-lane threshold rows. The plain version of the `unpack`
    kernel (with kernels._limb_first; kernels.unpack_limb_first)."""

    def dev(a):
        return torch.as_tensor(a, device=device).to(torch.int64)

    body = dev(packed.body)

    def sl(o, n):
        return body[:, o: o + n]

    issuer = sl(layout.o_issuer, 32)
    vrf_vk = sl(layout.o_vrf_vk, 32)
    beta = sl(layout.o_vrf_out, 64)
    proof = sl(layout.o_vrf_proof, layout.vrf_proof_len)
    if layout.vrf_proof_len == 128:
        vrf_cols = (proof[:, :32], proof[:, 32:64], proof[:, 64:96], proof[:, 96:])
    else:
        vrf_cols = (proof[:, :32], proof[:, 32:48], proof[:, 48:])
    vk_hot = sl(layout.o_vk_hot, 32)
    sigma = sl(layout.o_sigma, 64)
    ed_r, ed_s = sigma[:, :32], sigma[:, 32:]
    kes_rs = dev(packed.kes_rs)
    kes_r, kes_s = kes_rs[:, :32], kes_rs[:, 32:]
    tail = dev(packed.kes_tail_tab)[dev(packed.kes_tail_idx)]
    vk_leaf = tail[:, :32]
    siblings = tail[:, 32:].reshape(-1, layout.kes_depth, 32)
    thr = dev(packed.thr_tab)[dev(packed.thr_idx)]
    slot, counter, c0 = dev(packed.slot), dev(packed.counter), dev(packed.c0)
    # OCert DSIGN message: R ‖ A ‖ (vk_hot ‖ counter_be8 ‖ period_be8)
    ed_hb, ed_hnb = _pad_blocks(
        torch.cat([ed_r, issuer, vk_hot, _be8(counter), _be8(c0)], 1))
    kes_hb, kes_hnb = _pad_blocks(torch.cat([kes_r, vk_leaf, body], 1))
    alpha = alpha_from_slots(slot, dev(packed.nonce) if layout.has_nonce else None)
    # window-check-failing lanes get an out-of-range t (their precheck
    # error precedes the KES verdict in the reference's order)
    period = slot // layout.slots_per_kes - c0
    return (
        issuer, ed_r, ed_s, ed_hb, ed_hnb,
        vk_hot, period, kes_r, kes_s, vk_leaf, siblings, kes_hb, kes_hnb,
        vrf_vk, *vrf_cols, alpha,
        beta, thr[:, :32], thr[:, 32:],
    )


def verdict_reduce(flags: torch.Tensor, eta: torch.Tensor, n_real: int,
                   fold=None):
    """The device-side reduction of a window: pack the five verdict rows
    [5, B] into u32 words (lane i -> word i // 32, bit i % 32), then with
    `fold` (the window's nonce fold, launched before the stages by
    kernels.nonce_fold_beside) join it, so that the host reads one nonce
    pair, else cut the eta column to bytes for the host fold.
    -> (masks [5, W] int64 holding u32 values, carry-out [66] uint8) with
    `fold`, else (masks, eta_u8 [n_real, 32] uint8)."""
    b = flags.shape[-1]
    w = -(-b // 32)
    bits = (flags != 0).to(torch.int64)
    if w * 32 > b:
        bits = torch.cat([bits, torch.zeros(5, w * 32 - b, dtype=torch.int64,
                                            device=flags.device)], 1)
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    masks = (bits.reshape(5, w, 32) << shifts).sum(-1)
    if fold is not None:
        return masks, pk_kernels.join_fold(fold)
    return masks, eta[:, :n_real].T.to(torch.uint8)


def state_carry(state: PraosState) -> np.ndarray:
    """The nonce-fold carry that seeds a chain from a host state:
    [66] uint8 (nonces.pack_carry)."""
    return nonces.pack_carry(state.evolving_nonce, state.candidate_nonce)


# ---------------------------------------------------------------------------
# Generic staging (host): the windows the packed staging declines
# ---------------------------------------------------------------------------


class PraosBatch(NamedTuple):
    """A window's batch-first host columns (numpy), check by check."""

    ed: stage_np.Ed25519Batch  # OCert cold-key signature
    kes: stage_np.KesBatch  # header-body KES signature
    vrf: "stage_np.EcvrfBatch | stage_np.EcvrfBcBatch"  # by proof length
    beta: np.ndarray  # [B, 64] uint8 — declared VRF output
    thr_lo: np.ndarray  # [B, 32] uint8 — big-endian leader bound (win)
    thr_hi: np.ndarray  # [B, 32] uint8 — big-endian leader bound (loss)


def stage(params: PraosParams, ledger_view: LedgerView,
          epoch_nonce: nonces.Nonce, hvs: Sequence[HeaderView],
          evolution: np.ndarray) -> PraosBatch:
    """Columnarize a window from the parsed views alone: any body width
    per lane (per-lane SHA-512 block counts), the KES period t =
    `evolution` (0 on lanes whose precheck failed), the mkInputVRF alphas
    and the leader threshold rows; proofs split by their length."""
    b = len(hvs)
    ed = stage_np.stage_ed([hv.vk_cold for hv in hvs],
                           [hv.ocert.sigma for hv in hvs],
                           [hv.ocert.signable() for hv in hvs])
    kes = stage_np.stage_kes([hv.ocert.vk_hot for hv in hvs],
                             [int(t) for t in evolution],
                             [hv.signed_bytes for hv in hvs],
                             [hv.kes_sig for hv in hvs], params.kes_depth)
    vrf = stage_np.stage_vrf([hv.vrf_vk for hv in hvs],
                             [hv.vrf_proof for hv in hvs],
                             [nonces.mk_input_vrf(hv.slot, epoch_nonce) for hv in hvs])
    beta = stage_np.byte_rows([hv.vrf_output for hv in hvs], 64)
    f = Fraction(params.active_slot_coeff)
    thr = np.zeros((b, 64), np.uint8)
    for i, hv in enumerate(hvs):
        lo, hi = threshold_rows(_sigma(ledger_view, hv), f)
        thr[i] = np.frombuffer(lo + hi, np.uint8)
    return PraosBatch(ed, kes, vrf, beta, thr[:, :32].copy(), thr[:, 32:].copy())


def _alpha_column(vc: ViewColumns, epoch_nonce: nonces.Nonce) -> np.ndarray:
    """[B, 32] mkInputVRF of each lane's slot (a Blake2b a header; the
    packed path computes them on the card instead)."""
    return np.frombuffer(
        b"".join(nonces.mk_input_vrf(s, epoch_nonce) for s in vc.slot.tolist()),
        np.uint8).reshape(len(vc), 32).copy()


def stage_columns(params: PraosParams, ledger_view: LedgerView,
                  epoch_nonce: nonces.Nonce, vc: ViewColumns,
                  evolution: np.ndarray, pre: ColumnChecks) -> PraosBatch:
    """`stage` of a ViewColumns window, byte for byte: whole-matrix
    slices and one SHA-512 padding a hash family, the thresholds from
    the precheck's pool dedup."""
    b = len(vc)
    sigma = vc.ocert_sigma
    ed_r, ed_s = np.ascontiguousarray(sigma[:, :32]), np.ascontiguousarray(sigma[:, 32:])
    # the OCert signature's challenge input R ‖ A ‖ vk_hot ‖ n_be8 ‖ c0_be8
    ed_hb, ed_hnb = stage_np.pad_matrix_np(np.concatenate(
        [ed_r, vc.vk_cold, vc.ocert_vk_hot, _be8_np(vc.ocert_counter),
         _be8_np(vc.ocert_kes_period)], axis=1))
    ed = stage_np.Ed25519Batch(np.ascontiguousarray(vc.vk_cold), ed_r, ed_s, ed_hb, ed_hnb)
    ks = vc.kes_sig
    kes_r, kes_s, vk_leaf = (np.ascontiguousarray(ks[:, k: k + 32]) for k in (0, 32, 64))
    kes_hb, kes_hnb = stage_np.pad_matrix_np(
        np.concatenate([kes_r, vk_leaf, vc.signed_bytes], axis=1))
    kes = stage_np.KesBatch(
        np.ascontiguousarray(vc.ocert_vk_hot), np.asarray(evolution, np.int32),
        kes_r, kes_s, vk_leaf,
        np.ascontiguousarray(ks[:, 96:]).reshape(b, params.kes_depth, 32),
        kes_hb, kes_hnb)
    plen = int(vc.vrf_proof_len[0])
    proof = vc.vrf_proof
    cuts = (0, 32, 64, 96, 128) if plen == 128 else (0, 32, 48, 80)
    parts = [np.ascontiguousarray(proof[:, lo:hi]) for lo, hi in zip(cuts[:-1], cuts[1:])]
    vrf_type = stage_np.EcvrfBcBatch if plen == 128 else stage_np.EcvrfBatch
    vrf = vrf_type(np.ascontiguousarray(vc.vrf_vk), *parts, _alpha_column(vc, epoch_nonce))
    thr_lo, thr_hi = _uniq_threshold_tables(params, pre)
    return PraosBatch(ed, kes, vrf, np.ascontiguousarray(vc.vrf_output), thr_lo, thr_hi)


def stage_any(params: PraosParams, ledger_view: LedgerView, epoch_nonce: nonces.Nonce,
              hvs: "Sequence[HeaderView] | ViewColumns", pre: HostChecks) -> PraosBatch:
    """The generic staging of either window form: stage_columns for a
    ViewColumns window, stage for a list."""
    if isinstance(hvs, ViewColumns):
        return stage_columns(params, ledger_view, epoch_nonce, hvs, pre.kes_evolution, pre)
    return stage(params, ledger_view, epoch_nonce, hvs, pre.kes_evolution)


def pad_batch_to(batch: PraosBatch, size: int) -> PraosBatch:
    """Pad every column to `size` lanes by replicating lane 0."""
    b = batch.beta.shape[0]
    if b == size:
        return batch

    def pad(x):
        return np.concatenate([x, np.repeat(x[:1], size - b, axis=0)], axis=0)

    def pad_all(t):
        return type(t)(*(pad(c) for c in t))

    return PraosBatch(pad_all(batch.ed), pad_all(batch.kes), pad_all(batch.vrf),
                      pad(batch.beta), pad(batch.thr_lo), pad(batch.thr_hi))


def batch_columns(batch: PraosBatch, device) -> tuple:
    """The staged columns on `device`, in the order of
    kernels.staged_to_limb_first (21, draft-03) or _bc (22)."""
    return tuple(to_device(a, device)
                 for a in (*batch.ed, *batch.kes, *batch.vrf, batch.beta,
                           batch.thr_lo, batch.thr_hi))


# ---------------------------------------------------------------------------
# Verdicts and the sequential epilogue
# ---------------------------------------------------------------------------


class Verdicts(NamedTuple):
    ok_ocert_sig: np.ndarray  # [b] bool
    ok_kes_sig: np.ndarray
    ok_vrf: np.ndarray
    ok_leader: np.ndarray
    leader_ambiguous: np.ndarray
    eta: np.ndarray  # [b, 32] uint8
    leader_value: np.ndarray  # [b, 32] uint8 (big-endian value)


class PackedVerdicts:
    """A dispatched window's result: u32 verdict words, and either the
    window's nonce carry-out (`carried`: the device tensor that seeds the
    next window, and its two nonces) or the eta bytes (a generically
    staged window). The words, the nonces and the eta bytes are copied to
    the host behind the window's work without waiting; they are read
    after the event recorded behind those copies (`masks`, `nonces`,
    `eta_bytes()`), so that later windows can be launched meanwhile. The
    per-lane flags, eta and leader values stay on the device until
    `full()` (only a failing or ambiguous window needs them). An
    aggregated window (`agg`: its layout and the unpacked limb-first
    device columns, which its per-lane re-dispatch reads; `materialize`)
    holds the aggregate's verdicts until it retires."""

    def __init__(self, masks, b, handles, *, carry=None, eta_u8=None, agg=None):
        self.b = b
        self.agg = agg  # (layout, limb-first columns) of an aggregated window
        self._handles = handles  # (flags [5, B], eta [32, B], lv [32, B])
        self.carry = carry  # [66] uint8 on the device, or None
        self.carried = carry is not None
        self._masks = to_host(masks)
        self._carry = to_host(carry) if self.carried else None
        self._eta = to_host(eta_u8) if eta_u8 is not None else None
        self._ready = None
        self.meta = None  # the window's WindowStaged meta (`_win_meta`), when traced
        if masks.device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(masks.device))
        self._full = None

    def _wait(self) -> None:
        if self._ready is not None:
            self._ready.synchronize()
            self._ready = None

    @cached_property
    def masks(self) -> np.ndarray:
        """[5, W] uint32 verdict words (lane i -> word i // 32, bit i % 32)."""
        self._wait()
        return self._masks.numpy().astype(np.uint32)

    @cached_property
    def nonces(self):
        """(evolving, candidate) after the window's last lane; None for a
        window without a carry."""
        if not self.carried:
            return None
        self._wait()
        return nonces.unpack_carry(self._carry.numpy())

    def _row(self, r: int) -> np.ndarray:
        bits = np.unpackbits(
            np.ascontiguousarray(self.masks[r]).view(np.uint8), bitorder="little")
        return bits[: self.b].astype(bool)

    def clean(self) -> bool:
        """Every real lane passed every check outright."""
        return all(self._row(r).all() for r in range(4)) and not self._row(4).any()

    def eta_bytes(self) -> np.ndarray | None:
        """The [b, 32] uint8 eta column a window without a carry shipped;
        None for a carried window (its column stays on the device for
        `full()`)."""
        if self._eta is None:
            return None
        self._wait()
        return self._eta.numpy()

    def d2h_bytes(self) -> int:
        """The bytes the window's dispatch copies back to the host."""
        return self._masks.nbytes + (self._carry.nbytes if self.carried else 0) + (
            self._eta.nbytes if self._eta is not None else 0)

    def full(self) -> Verdicts:
        if self._full is None:
            flags, eta, lv = (x.cpu().numpy() for x in self._handles)
            b = self.b
            self._full = Verdicts(
                flags[0, :b] != 0, flags[1, :b] != 0, flags[2, :b] != 0,
                flags[3, :b] != 0, flags[4, :b] != 0,
                np.ascontiguousarray(eta[:, :b].T.astype(np.uint8)),
                np.ascontiguousarray(lv[:, :b].T.astype(np.uint8)),
            )
        return self._full


@dataclass
class BatchResult:
    state: PraosState  # state after the last VALID header
    n_valid: int  # length of the valid prefix
    error: praos.PraosValidationError | None  # error at position n_valid
    states: list | None = None  # the state after each valid header (collect_states)
    # the device nonce carry after a valid packed window (None: the next
    # packed window seeds the fold from `state`)
    carry: torch.Tensor | None = None


def _counter_m(hk, counters, pool_distr):
    """Last seen counter, else 0 for a pool with stake, else None."""
    m = counters.get(hk)
    if m is None and hk in pool_distr:
        m = 0
    return m


def _counter_ok(m, n) -> bool:
    """Praos.hs:585-590: m <= n <= m + 1."""
    return m is not None and m <= n <= m + 1


def lane_error(params: PraosParams, ledger_view: LedgerView,
               epoch_nonce: nonces.Nonce, hv: HeaderView, pre: HostChecks,
               v: Verdicts, i: int, counters: Mapping[bytes, int]):
    """The exact error the sequential reference fold raises at lane i, in
    its order: all of validateKESSignature (window, OCert sig, KES sig,
    counters) before validateVRFSignature (lookup, proof, leader)."""
    if pre.kes_window_errors[i] is not None:
        return pre.kes_window_errors[i]
    if not v.ok_ocert_sig[i]:
        return praos.InvalidSignatureOCERT(hv.ocert.counter, hv.ocert.kes_period)
    if not v.ok_kes_sig[i]:
        kp = params.kes_period_of(hv.slot)
        c0 = hv.ocert.kes_period
        return praos.InvalidKesSignatureOCERT(kp, c0, kp - c0)
    hk = hash_key(hv.vk_cold)
    m = _counter_m(hk, counters, ledger_view.pool_distr)
    if m is None:
        return praos.NoCounterForKeyHashOCERT(hk)
    n = hv.ocert.counter
    if not m <= n:
        return praos.CounterTooSmallOCERT(m, n)
    if not n <= m + 1:
        return praos.CounterOverIncrementedOCERT(m, n)
    if pre.vrf_lookup_errors[i] is not None:
        return pre.vrf_lookup_errors[i]
    if not v.ok_vrf[i]:
        return praos.VRFKeyBadProof(hv.slot, epoch_nonce)
    if not v.leader_ambiguous[i] and v.ok_leader[i]:
        return None
    sigma = _sigma(ledger_view, hv)
    lv_val = int.from_bytes(bytes(v.leader_value[i].astype(np.uint8)), "big")
    if v.leader_ambiguous[i] and leader.check_leader_value(
        lv_val, sigma, params.active_slot_coeff
    ):
        return None
    return praos.VRFLeaderValueTooBig(lv_val, sigma, params.active_slot_coeff)


def _epilogue_packed_fast(params, ticked, hvs, pre, v: PackedVerdicts):
    """All-clean fast path: no precheck error, every verdict bit set and
    the counters monotone -> the final state with the nonces of the
    window's device fold (or, for a window without one, a host fold of
    its eta bytes), no per-lane error reconstruction. None when any gate
    trips (the exact slow path then runs)."""
    if not v.clean() or pre.any_errors():
        return None
    st = ticked.state
    counters = dict(st.ocert_counters)
    for hv in hvs:
        hk = hash_key(hv.vk_cold)
        if not _counter_ok(_counter_m(hk, counters, ticked.ledger_view.pool_distr),
                           hv.ocert.counter):
            return None
        counters[hk] = hv.ocert.counter
    if v.carried:
        evolving, candidate = v.nonces
    else:
        evolving, candidate = st.evolving_nonce, st.candidate_nonce
        etas = v.eta_bytes()
        for i, hv in enumerate(hvs):
            evolving = nonces.combine(evolving, etas[i].tobytes())
            if hv.slot + params.stability_window < params.first_slot_of(
                    params.epoch_of(hv.slot) + 1):
                candidate = evolving
    state = PraosState(
        last_slot=hvs[-1].slot, ocert_counters=counters,
        evolving_nonce=evolving, candidate_nonce=candidate,
        epoch_nonce=st.epoch_nonce,
        lab_nonce=nonces.prev_hash_to_nonce(hvs[-1].prev_hash),
        last_epoch_block_nonce=st.last_epoch_block_nonce,
    )
    return BatchResult(state, len(hvs), None)


def _verdicts_clean(v) -> bool:
    """Every real lane passed every check outright."""
    if isinstance(v, PackedVerdicts):
        return v.clean()
    return bool(v.ok_ocert_sig.all() and v.ok_kes_sig.all() and v.ok_vrf.all()
                and v.ok_leader.all() and not v.leader_ambiguous.any())


def _epilogue_columns_fast(params, ticked, vc: ViewColumns, pre: ColumnChecks, v):
    """The all-clean epilogue of a ViewColumns window, with no
    HeaderView built: the counters checked per unique pool over column
    slices, the candidate gate one window compare, the nonces from the
    window's device fold (or a host fold of its eta bytes). None when
    any gate trips (the exact per-header path then runs)."""
    if pre.any_errors() or not _verdicts_clean(v):
        return None
    st = ticked.state
    counters = dict(st.ocert_counters)
    cnt = vc.ocert_counter
    for j, hk in enumerate(pre.uniq_hk):
        m = _counter_m(hk, counters, ticked.ledger_view.pool_distr)
        if m is None:
            return None
        cs = cnt[pre.uniq_inv == j]
        d = np.diff(cs)
        if not (m <= cs[0] <= m + 1 and (d >= 0).all() and (d <= 1).all()):
            return None
        counters[hk] = int(cs[-1])
    b = len(vc)
    if isinstance(v, PackedVerdicts) and v.carried:
        evolving, candidate = v.nonces
    else:
        etas = (v.eta_bytes() if isinstance(v, PackedVerdicts)
                else np.ascontiguousarray(np.asarray(v.eta).astype(np.uint8))).tobytes()
        first_next = (vc.slot // params.epoch_length + 1) * params.epoch_length
        w_idx = np.flatnonzero(vc.slot + params.stability_window < first_next)
        k = int(w_idx[-1]) if w_idx.size else -1  # the last lane that sets candidate
        evolving, candidate = st.evolving_nonce, st.candidate_nonce
        for i in range(b):
            evolving = nonces.combine(evolving, etas[32 * i: 32 * i + 32])
            if i == k:
                candidate = evolving
    last = b - 1
    state = PraosState(
        last_slot=int(vc.slot[last]), ocert_counters=counters,
        evolving_nonce=evolving, candidate_nonce=candidate,
        epoch_nonce=st.epoch_nonce,
        lab_nonce=nonces.prev_hash_to_nonce(
            vc.prev_hash[last].tobytes() if vc.has_prev[last] else None),
        last_epoch_block_nonce=st.last_epoch_block_nonce,
    )
    return BatchResult(state, b, None)


def epilogue(params: PraosParams, ticked: TickedPraosState,
             hvs: "Sequence[HeaderView] | ViewColumns", pre: HostChecks,
             v, lane_error_fn=None, collect_states: bool = False) -> BatchResult:
    """Sequential epilogue: counters + nonce fold, stop at the first
    failure with the reference's error. A ViewColumns window first tries
    the columnar fast path; when that declines, the window's HeaderViews
    take the exact per-header fold (the packed fast path, which checks
    the same gates, is skipped). `lane_error_fn`: the per-lane error rule
    in place of `lane_error` (TPraos's genesis-delegate counter default).
    `collect_states`: the exact fold always runs (neither fast path, so a
    carried window's nonces come from its eta column, not its carry) and
    `states` holds the state after each valid header (the LedgerDB's
    per-header checkpoints)."""
    err_of = lane_error if lane_error_fn is None else lane_error_fn
    columns_declined = isinstance(hvs, ViewColumns)
    if columns_declined:
        if not collect_states:
            res = _epilogue_columns_fast(params, ticked, hvs, pre, v)
            if res is not None:
                return res
        hvs = hvs.views()
    if isinstance(v, PackedVerdicts):
        if not columns_declined and not collect_states:
            res = _epilogue_packed_fast(params, ticked, hvs, pre, v)
            if res is not None:
                return res
        v = v.full()
    lview = ticked.ledger_view
    st = ticked.state
    eta0 = st.epoch_nonce
    counters = dict(st.ocert_counters)
    evolving, candidate = st.evolving_nonce, st.candidate_nonce
    lab, last_slot = st.lab_nonce, st.last_slot
    states = [] if collect_states else None
    etas = np.ascontiguousarray(np.asarray(v.eta).astype(np.uint8))
    for i, hv in enumerate(hvs):
        err = err_of(params, lview, eta0, hv, pre, v, i, counters)
        if err is not None:
            state = PraosState(
                last_slot=last_slot, ocert_counters=counters,
                evolving_nonce=evolving, candidate_nonce=candidate,
                epoch_nonce=st.epoch_nonce, lab_nonce=lab,
                last_epoch_block_nonce=st.last_epoch_block_nonce,
            )
            return BatchResult(state, i, err, states)
        evolving = nonces.combine(evolving, etas[i].tobytes())
        if hv.slot + params.stability_window < params.first_slot_of(
                params.epoch_of(hv.slot) + 1):
            candidate = evolving
        lab = nonces.prev_hash_to_nonce(hv.prev_hash)
        counters[hash_key(hv.vk_cold)] = hv.ocert.counter
        last_slot = hv.slot
        if states is not None:
            states.append(PraosState(
                last_slot=last_slot, ocert_counters=dict(counters),
                evolving_nonce=evolving, candidate_nonce=candidate,
                epoch_nonce=st.epoch_nonce, lab_nonce=lab,
                last_epoch_block_nonce=st.last_epoch_block_nonce,
            ))
    state = PraosState(
        last_slot=last_slot, ocert_counters=counters,
        evolving_nonce=evolving, candidate_nonce=candidate,
        epoch_nonce=st.epoch_nonce, lab_nonce=lab,
        last_epoch_block_nonce=st.last_epoch_block_nonce,
    )
    return BatchResult(state, len(hvs), None, states)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


def _lt_be_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise big-endian a < b of two [n, 32] uint8 matrices."""
    ne = a != b
    first = ne.argmax(axis=1)
    rows = np.arange(a.shape[0])
    return ne.any(axis=1) & (a[rows, first] < b[rows, first])


def _native_columns(params: PraosParams, epoch_nonce, vc: ViewColumns,
                    pre: ColumnChecks) -> Verdicts:
    """run_batch_native of a ViewColumns window: the matrices passed as
    they are, the leader bracket one byte compare against the unique
    pools' threshold rows."""
    n = len(vc)
    sig_len = 96 + 32 * params.kes_depth
    if vc.kes_sig.shape[1] != sig_len:
        raise ValueError(f"KES signatures of {vc.kes_sig.shape[1]} bytes, not {sig_len}")
    lb = vc.signed_bytes.shape[1]
    plen = int(vc.vrf_proof_len[0])
    rc, kind, lv, eta = native.validate_praos(
        vc.vk_cold, vc.ocert_sigma,
        np.concatenate([vc.ocert_vk_hot, _be8_np(vc.ocert_counter),
                        _be8_np(vc.ocert_kes_period)], axis=1),
        vc.ocert_vk_hot, pre.kes_evolution, vc.kes_sig, params.kes_depth,
        np.ascontiguousarray(vc.signed_bytes).tobytes(),
        np.arange(n + 1, dtype=np.int64) * lb, vc.vrf_vk, vc.vrf_proof[:, :plen],
        _alpha_column(vc, epoch_nonce), vc.vrf_output,
    )
    ok = [np.ones(n, bool) for _ in range(3)]
    if rc >= 0:
        ok[kind - 1][rc] = False
    live = np.arange(n) < (n if rc < 0 else rc)
    thr_lo, thr_hi = _uniq_threshold_tables(params, pre)
    win = _lt_be_rows(lv, thr_lo)
    return Verdicts(ok[0], ok[1], ok[2], win & live,
                    ~win & _lt_be_rows(lv, thr_hi) & live, eta, lv)


def run_batch_native(params: PraosParams, ledger_view: LedgerView,
                     epoch_nonce, hvs: "Sequence[HeaderView] | ViewColumns",
                     pre: HostChecks) -> Verdicts:
    """The C++ verifier (native/hostcrypto.cpp) over a window, in the
    same Verdicts shape. It stops at the first failing lane; lanes past
    it carry don't-care verdicts the epilogue never reads."""
    if isinstance(hvs, ViewColumns):
        return _native_columns(params, epoch_nonce, hvs, pre)
    n = len(hvs)

    def rows(get, w):
        return np.frombuffer(b"".join(get(hv) for hv in hvs), np.uint8).reshape(n, w)

    body = b"".join(hv.signed_bytes for hv in hvs)
    body_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(hv.signed_bytes) for hv in hvs], out=body_off[1:])
    plen = len(hvs[0].vrf_proof)
    rc, kind, lv, eta = native.validate_praos(
        rows(lambda h: h.vk_cold, 32), rows(lambda h: h.ocert.sigma, 64),
        rows(lambda h: h.ocert.signable(), 48), rows(lambda h: h.ocert.vk_hot, 32),
        pre.kes_evolution, rows(lambda h: h.kes_sig, 96 + 32 * params.kes_depth),
        params.kes_depth, body, body_off, rows(lambda h: h.vrf_vk, 32),
        rows(lambda h: h.vrf_proof, plen),
        rows(lambda h: nonces.mk_input_vrf(h.slot, epoch_nonce), 32),
        rows(lambda h: h.vrf_output, 64),
    )
    ok = [np.ones(n, bool) for _ in range(3)]
    if rc >= 0:
        ok[kind - 1][rc] = False
    stop = n if rc < 0 else rc
    ok_leader = np.zeros(n, bool)
    ambiguous = np.zeros(n, bool)
    f = Fraction(params.active_slot_coeff)
    for i in range(stop):
        lo, hi = threshold_rows(_sigma(ledger_view, hvs[i]), f)
        lvb = lv[i].tobytes()
        ok_leader[i] = lvb < lo  # big-endian bytes: lexicographic = numeric
        ambiguous[i] = not ok_leader[i] and lvb < hi
    return Verdicts(ok[0], ok[1], ok[2], ok_leader, ambiguous, eta, lv)


# packed-staging declines by reason, over the process (the reference's
# `_LAST_DECLINE` gate, which its window telemetry records)
DECLINES: dict[str, int] = {}
# aggregated windows whose verdicts were not clean, verified again by the
# per-lane stage kernels (`materialize`), over the process
AGG_REDISPATCH = 0


# ---------------------------------------------------------------------------
# The batch tracer seam (the reference's protocol/batch.py:1915-2020)
# ---------------------------------------------------------------------------

# Enclose brackets around the window loop's phases ("stage": a window's
# host half; "dispatch": its uploads and launches, queued; "materialize":
# the wait for its verdicts, with a dirty aggregated window's re-dispatch;
# "epilogue": the sequential fold), byte accounting (TransferEvent) and
# the per-window spans (WindowStaged at dispatch, WindowSpan at retire),
# emitted through BATCH_TRACER. None (the default) costs one None check
# a site. Events come from the staging thread ("stage") and the
# launching thread (the rest). obs.install chains the flight recorder
# in; revalidate(collect_phases=True) chains its phase collector.
BATCH_TRACER = None


def set_batch_tracer(tracer) -> None:
    global BATCH_TRACER
    BATCH_TRACER = tracer


class _NullEnclose:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_ENCLOSE = _NullEnclose()


def _enclose(label: str):
    tracer = BATCH_TRACER
    if tracer is None:
        return _NULL_ENCLOSE
    from ..utils.trace import Enclose

    return Enclose(tracer, label)


def _emit_transfer(phase: str, **kw) -> None:
    tracer = BATCH_TRACER
    if tracer is not None:
        from ..utils.trace import TransferEvent

        tracer(TransferEvent(phase=phase, **kw))


# the process-wide window dispatch sequence (WindowStaged/WindowSpan
# `index`), advanced only while a tracer is installed, on the launching
# thread
_WIN_SEQ = 0


def _win_meta(outcome: str, gate: str | None, b: int, lanes: int,
              t0: float, t1: float) -> tuple | None:
    """Emit a dispatched window's WindowStaged and return the meta its
    WindowSpan needs; None when no tracer is set."""
    global _WIN_SEQ
    tracer = BATCH_TRACER
    if tracer is None:
        return None
    from ..utils.trace import WindowStaged

    idx = _WIN_SEQ
    _WIN_SEQ += 1
    t2 = time.monotonic()
    tracer(WindowStaged(idx, b, lanes, outcome, gate, t1 - t0, t2 - t1))
    return (idx, outcome, gate, t1 - t0, t2 - t1, lanes, t2)


def _emit_window_span(meta, lanes: int, n_valid: int, failed: bool, t_m0: float,
                      t_m1: float, t_e0: float, t_done: float) -> None:
    """Emit a retired window's WindowSpan (its dispatch's meta and the
    materialize and epilogue walls of the retire)."""
    tracer = BATCH_TRACER
    if tracer is None or meta is None:
        return
    from ..utils.trace import WindowSpan

    idx, outcome, gate, stage_s, dispatch_s, _lanes_padded, t_disp = meta
    tracer(WindowSpan(
        index=idx, lanes=lanes, outcome=outcome, gate=gate, stage_s=stage_s,
        dispatch_s=dispatch_s, materialize_s=t_m1 - t_m0, epilogue_s=t_done - t_e0,
        t_dispatch=t_disp, t_materialized=t_m1, t_done=t_done, n_valid=n_valid,
        failed=failed))


def _nbytes(x) -> int:
    """The bytes of the numpy arrays in a (nested) tuple of columns."""
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, tuple):
        return sum(_nbytes(y) for y in x)
    return 0


def _retire(params: PraosParams, ticked: TickedPraosState, hvs, pre, v: "PackedVerdicts",
            collect_states: bool = False):
    """A dispatched window's verdicts, waited for (a dirty aggregated
    window re-dispatched, `materialize`), then its epilogue
    (`collect_states`: epilogue's), and its WindowSpan."""
    traced = BATCH_TRACER is not None
    t_m0 = time.monotonic() if traced else 0.0
    with _enclose("materialize"):
        v = materialize(v)
        v.masks  # the wait for the copies back
    t_m1 = time.monotonic() if traced else 0.0
    with _enclose("epilogue"):
        res = epilogue(params, ticked, hvs, pre, v, collect_states=collect_states)
    if traced:
        _emit_window_span(v.meta, len(hvs), res.n_valid, res.error is not None, t_m0, t_m1,
                          t_m1, time.monotonic())
    return res


class StagedWindow(NamedTuple):
    """prepare_window's output: a window's host half, all that
    dispatch_prepared needs, so that it can be staged on another thread
    ahead of the launch."""

    hvs: "Sequence[HeaderView] | ViewColumns"
    pre: HostChecks
    b: int  # the window's headers
    layout: PackedLayout | None  # None: a generically staged window
    packed: Packed | None  # the padded packed columns, views of `buf`
    buf: torch.Tensor  # the staging buffer (`staging_buffer`)
    batch: PraosBatch | None  # a generic window's padded columns
    # a batch-compatible packed window takes the window aggregate
    # (dispatch_prepared; validate_chain's `aggregate`)
    aggregate: bool = True
    gate: str | None = None  # why the packed staging declined (a generic window)
    t0: float = 0.0  # monotonic at the staging's start and end, when traced
    t1: float = 0.0


def prepare_window(params: PraosParams, lview: LedgerView, eta0,
                   hvs: "Sequence[HeaderView] | ViewColumns", buf: torch.Tensor,
                   pre: HostChecks | None = None) -> StagedWindow:
    """The host half of a window (the reference's prepare_window): the
    prechecks (unless `pre` is given), the packed staging or, for a
    window it declines for one of GENERIC_REASONS, the generic one (any
    other decline raises), and the bucket padding, into the staging
    buffer `buf` (`staging_buffer`). It does
    not depend on the nonce fold, only on the epoch nonce `eta0` and the
    ledger view, and touches host memory only: the window pipeline runs
    it on its staging thread."""
    chaos.fire("stage")  # staging-thread-death@window:N
    traced = BATCH_TRACER is not None
    t0 = time.monotonic() if traced else 0.0
    with _enclose("stage"):
        if pre is None:
            pre = host_prechecks(params, lview, hvs)
        b = len(hvs)
        try:
            if isinstance(hvs, ViewColumns):
                layout, packed = stage_packed_columns(params, lview, eta0, hvs, pre)
            else:
                layout, packed = stage_packed(params, lview, eta0, hvs)
        except NotStagedError as e:
            if e.reason not in GENERIC_REASONS:
                raise
            DECLINES[e.reason] = DECLINES.get(e.reason, 0) + 1
            batch = pad_batch_to(stage_any(params, lview, eta0, hvs, pre), bucket_size(b))
            return StagedWindow(hvs, pre, b, None, None, buf, batch, gate=e.reason, t0=t0,
                                t1=time.monotonic() if traced else 0.0)
        packed = pad_packed_into(packed, bucket_size(b), buf.numpy())
    return StagedWindow(hvs, pre, b, layout, packed, buf, None, t0=t0,
                        t1=time.monotonic() if traced else 0.0)


def dispatch_prepared(sw: StagedWindow, device: torch.device, carry=None) -> PackedVerdicts:
    """The device half of a window (the reference's dispatch_prepared),
    on the launching thread and in window order: H2D of the staged
    columns (from pinned memory on the card) -> unpack -> the five stage
    kernels of the window's proof format, the nonce fold beside them on
    the side stream -> the reduce, then the copies of the mask words and the carry back
    to the host, none of which waits for the card. With `sw.aggregate`, a
    batch-compatible packed window (128-byte proofs) takes the window
    aggregate (ops/pk/aggregate.py) in place of the five stage kernels,
    and `materialize` verifies it again lane by lane when it retires
    dirty (the reference's default, OCT_VRF_AGG=1). `carry` is the fold's
    carry-in: the previous packed window's device carry-out, or a host
    seed (`state_carry`); None is the neutral one. A generic window runs
    the five stage kernels and ships its eta bytes (no fold, no carry).
    Traced, it emits the window's H2D TransferEvent and its WindowStaged
    inside the "dispatch" bracket (the reference's order)."""
    chaos.fire("dispatch")  # device-error@dispatch:N, compile-stall@window:N
    with _enclose("dispatch"):
        traced = BATCH_TRACER is not None
        if traced:
            t_d = time.monotonic()
            t0, t1 = (sw.t0, sw.t1) if sw.t1 else (t_d, t_d)  # a window staged untraced
            _emit_transfer("dispatch", lanes=bucket_size(sw.b), packed=sw.layout is not None,
                           h2d_bytes=_nbytes(sw.packed if sw.layout is not None else sw.batch))
        v, outcome = _dispatch(sw, device, carry)
        if traced:
            v.meta = _win_meta(outcome, sw.gate, sw.b, bucket_size(sw.b), t0, t1)
    return v


def _dispatch(sw: StagedWindow, device: torch.device, carry) -> tuple:
    """dispatch_prepared's launches -> (PackedVerdicts, the window's
    outcome: "generic", "packed-agg" or "packed")."""
    b = sw.b
    if sw.layout is None:
        cols = batch_columns(sw.batch, device)
        (masks, eta_u8), flags, eta, lv = pk_kernels.verify_staged(
            cols, isinstance(sw.batch.vrf, stage_np.EcvrfBcBatch),
            sw.batch.kes.siblings.shape[1], b)
        return PackedVerdicts(masks, b, (flags, eta, lv), eta_u8=eta_u8), "generic"
    packed = upload_staged(sw.packed, sw.buf, device)
    if carry is None:
        carry = nonces.pack_carry(None, None)
    if not isinstance(carry, torch.Tensor):
        carry = to_device(carry, device)
    if sw.aggregate and sw.layout.vrf_proof_len == 128:
        (masks, carry_out), av, limb = pk_kernels.verify_praos_packed_agg(
            sw.layout, packed, b, device, carry)
        return PackedVerdicts(masks, b, (av.flags, av.eta, av.leader_value),
                              carry=carry_out, agg=(sw.layout, limb)), "packed-agg"
    (masks, carry_out), flags, eta, lv = pk_kernels.verify_praos_packed_split(
        sw.layout, packed, b, device, carry)
    return PackedVerdicts(masks, b, (flags, eta, lv), carry=carry_out), "packed"


def materialize(v: PackedVerdicts) -> PackedVerdicts:
    """A retiring window's verdicts (the reference's materialize_verdicts):
    an aggregated window that is not clean (a lane failed a cheap check,
    the combination was not the identity, a dedupe table overflowed, or a
    leader lane is not a certain win) runs the five per-lane stage
    kernels on its own device columns and the verdict reduce; their
    verdicts replace the aggregate's. The fold is not run again: it read
    unpack's β rows, so the window's carry-out stays valid, and later
    windows, already in flight on it, are not touched. Counts
    AGG_REDISPATCH. Traced, it emits a D2H TransferEvent for each set of
    words read back, and AggRedispatch before the re-dispatch (the
    reference's materialize_verdicts)."""
    global AGG_REDISPATCH
    traced = BATCH_TRACER is not None
    if v.agg is None or v.clean():
        if traced:
            _emit_transfer("materialize", lanes=v.b, d2h_bytes=v.d2h_bytes(),
                           packed=v.agg is not None or v.carried)
        return v
    AGG_REDISPATCH += 1
    if traced:
        from ..utils.trace import AggRedispatch

        _emit_transfer("materialize", lanes=v.b, d2h_bytes=v.d2h_bytes(), packed=True)
        BATCH_TRACER(AggRedispatch(v.b))
    layout, limb = v.agg
    flags, eta, lv = pk_kernels._tiles(limb, True, layout.kes_depth)
    masks, _ = verdict_reduce(flags, eta, v.b)
    out = PackedVerdicts(masks, v.b, (flags, eta, lv), carry=v.carry)
    out.meta = v.meta
    if traced:
        _emit_transfer("materialize", lanes=v.b, d2h_bytes=out.d2h_bytes(), packed=True)
    return out


def dispatch_window(params: PraosParams, lview: LedgerView, eta0,
                    hvs: "Sequence[HeaderView] | ViewColumns", pre: HostChecks,
                    device: torch.device, carry=None, aggregate: bool = True) -> PackedVerdicts:
    """prepare_window then dispatch_prepared, inline: one window's
    staging (with its prechecks `pre`), kernels, reduce and the copies of
    its results back (the serial loop's step)."""
    device = torch.device(device)
    sw = prepare_window(params, lview, eta0, hvs, staging_buffer(params, hvs, device), pre)
    return dispatch_prepared(sw._replace(aggregate=aggregate), device, carry)


def validate_batch(params: PraosParams, ticked: TickedPraosState,
                   hvs: "Sequence[HeaderView] | ViewColumns", backend: str,
                   device: torch.device | None, carry=None,
                   aggregate: bool = True, collect_states: bool = False) -> BatchResult:
    """One within-epoch window of one proof format.
    `carry`: the device nonce carry of the previous packed window, None
    to seed the fold from the ticked state (tick only rotates the epoch
    nonce, so a carry stays valid across an epoch boundary). `aggregate`:
    dispatch_prepared's. `collect_states`: epilogue's (the state after
    each valid header in `states`)."""
    lview = ticked.ledger_view
    eta0 = ticked.state.epoch_nonce
    pre = host_prechecks(params, lview, hvs)
    if backend == "native":
        v = run_batch_native(params, lview, eta0, hvs, pre)
        res = epilogue(params, ticked, hvs, pre, v, collect_states=collect_states)
    elif backend == "device":
        seed = state_carry(ticked.state) if carry is None else carry
        v = dispatch_window(params, lview, eta0, hvs, pre, device, seed, aggregate)
        res = _retire(params, ticked, hvs, pre, v, collect_states)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if isinstance(v, PackedVerdicts) and v.carried and res.error is None:
        res.carry = v.carry
    return res


def _epoch_segments_idx(params: PraosParams, hvs) -> list[tuple[int, int, int]]:
    """[(epoch, start, end)]: the run cut at epoch boundaries (one
    vectorized pass over a ViewColumns window's slots)."""
    n = len(hvs)
    if n == 0:
        return []
    if isinstance(hvs, ViewColumns):
        epochs = hvs.slot // params.epoch_length
        bounds = [0, *(np.flatnonzero(np.diff(epochs)) + 1).tolist(), n]
        return [(int(epochs[lo]), lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
    segments = []
    i = 0
    while i < n:
        epoch = params.epoch_of(hvs[i].slot)
        j = i
        while j < n and params.epoch_of(hvs[j].slot) == epoch:
            j += 1
        segments.append((epoch, i, j))
        i = j
    return segments


def _proof_break(hvs, w: int, j: int) -> int:
    """The first index in (w, j) where the VRF proof format changes, else
    j (a window stages one proof column)."""
    if isinstance(hvs, ViewColumns):
        diff = np.flatnonzero(hvs.vrf_proof_len[w + 1: j] != hvs.vrf_proof_len[w])
        return w + 1 + int(diff[0]) if diff.size else j
    plen = len(hvs[w].vrf_proof)
    return next((k for k in range(w + 1, j) if len(hvs[k].vrf_proof) != plen), j)


def _slot_at(hvs, i: int) -> int:
    return int(hvs.slot[i]) if isinstance(hvs, ViewColumns) else hvs[i].slot


def _windows(params: PraosParams, hvs, max_batch: int) -> list[tuple[int, int, int]]:
    """[(epoch, start, end)]: the run's windows, cut at epoch boundaries,
    at `max_batch` within an epoch and where the proof format changes."""
    out = []
    for epoch, i, end in _epoch_segments_idx(params, hvs):
        while i < end:
            j = _proof_break(hvs, i, min(i + max_batch, end))
            out.append((epoch, i, j))
            i = j
    return out


def validate_chain(params: PraosParams, ledger_view_for_epoch, state: PraosState,
                   hvs: "Sequence[HeaderView] | ViewColumns", max_batch: int = 8192,
                   backend: str = "device", device=None,
                   pipeline_depth: int = 3, aggregate: bool = True,
                   supervisor=None) -> BatchResult:
    """Validate a run of headers (a HeaderView list or ViewColumns):
    windows cut at epoch boundaries, at `max_batch` within an epoch and
    where the proof format changes; the state threads through `tick`
    between windows, and the device nonce carry from each packed window
    to the next (a generically staged window breaks it; the next packed
    window seeds it from the state). Equivalent to folding the
    reference's `update` over `hvs` (same final state, same first
    error). backend="device" runs on `device` (None -> CUDA, raising when
    it is absent), with up to `pipeline_depth` windows staged ahead on a
    staging thread and as many in flight on the card (`_pipeline`; 1 is
    the serial loop: stage, launch, wait and fold one window at a time);
    backend="native" runs the C++ verifier, serially. `aggregate` (the
    device backend): batch-compatible packed windows take the window
    aggregate, and a dirty one the per-lane stages again (the
    reference's default); False runs the per-lane stages on every
    window. The device loops emit the window events of the tracer seam
    (BATCH_TRACER). `supervisor`: the
    obs/recovery.RecoverySupervisor that a window whose validation
    raises a RECOVER-class error goes to, in retire order (None: a
    default one). As each window retires, the checkpoint seam
    (`recovery.note_window`) and then the chaos ``retire`` seam run."""
    from ..obs import recovery

    dev = resolve(device) if backend == "device" else None
    sup = supervisor if supervisor is not None else recovery.RecoverySupervisor()
    windows = _windows(params, hvs, max_batch)
    lviews: dict = {}

    def lview_of(epoch):
        if epoch not in lviews:
            lviews[epoch] = ledger_view_for_epoch(epoch)
        return lviews[epoch]

    if backend == "device" and pipeline_depth > 1:
        return _pipeline(params, lview_of, state, hvs, windows, dev, pipeline_depth,
                         aggregate, sup)
    carry = None
    total = 0
    for k, (epoch, i, j) in enumerate(windows):
        ticked = praos.tick(params, lview_of(epoch), _slot_at(hvs, i), state)
        try:
            res = validate_batch(params, ticked, hvs[i:j], backend, dev, carry, aggregate)
        except Exception as e:  # noqa: BLE001 — the supervisor decides
            res = sup.recover_window(params, ticked, hvs[i:j], e, backend, dev, aggregate, k)
            res.carry = None  # the next packed window seeds from the state
        state, carry = res.state, res.carry
        total += res.n_valid
        if res.error is not None:
            return BatchResult(state, total, res.error)
        _retired(state, res.n_valid)
    return BatchResult(state, total, None)


def _retired(state: PraosState, n_valid: int) -> None:
    """A window retired: its progress record, then the kill seam (a
    chaos kill lands after the checkpoint, at the window boundary)."""
    from ..obs import recovery

    recovery.note_window(state, n_valid)
    chaos.fire("retire")


class _FailedWindow(NamedTuple):
    """An in-flight slot for a window whose staging or dispatch raised a
    RECOVER-class error: raised again where the window retires, where
    the supervisor has the exact fold state (the reference's
    _FailedDispatch)."""

    exc: BaseException


def _done(value=None, exc: BaseException | None = None):
    """A finished future holding `value` (or raising `exc`)."""
    from concurrent.futures import Future

    f: Future = Future()
    if exc is not None:
        f.set_exception(exc)
    else:
        f.set_result(value)
    return f


def _pipeline(params: PraosParams, lview_of, state: PraosState, hvs, windows: list,
              dev: torch.device, depth: int, aggregate: bool = True,
              sup=None) -> BatchResult:
    """The device loop of validate_chain (the reference's _device_loop):
    at most `depth` windows staged ahead (`prepare_window` on one staging
    thread, into staging buffers allocated here) and at most `depth` in
    flight (`dispatch_prepared` here, in window order, every CUDA call on
    this thread); windows retire in order, each with its epilogue here
    (an aggregated window that is not clean first runs its per-lane
    stages, `materialize`, behind the windows already in flight).
    A window's epoch nonce is known once every window before its epoch
    has retired, so the pipeline drains at an epoch boundary. After a
    generic window (no carry) the next packed window waits until it has
    retired and seeds its carry from the host state. On the first error
    the windows after it are discarded and their staging cancelled.

    A window whose staging or dispatch raises a RECOVER-class error
    takes a `_FailedWindow` slot; a fault that shows only when the
    window's results are read (a kernel's error surfaces at the next
    synchronisation) raises where it retires. Either way the supervisor
    validates the window again at its retire slot. The windows in
    flight behind it were dispatched with a carry that chained through
    it, so their device results are dropped: they go back to the head of
    the staging queue, as staged (their buffers are their own), and are
    dispatched again behind a carry seeded from the recovered state."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..obs import recovery

    sup = sup if sup is not None else recovery.RecoverySupervisor()
    staged: deque = deque()  # (window index, staging future)
    inflight: deque = deque()  # (window index, StagedWindow | None, PackedVerdicts | _FailedWindow)
    eta: dict = {}  # epoch -> the epoch nonce its windows stage with
    carry = state_carry(state)  # a host seed, or the last packed window's device carry
    carry_ok = True
    k_stage = 0  # the next window to stage
    retired = 0
    total = 0
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="validate-stage")

    def stage_ahead() -> None:
        nonlocal k_stage
        while k_stage < len(windows) and len(staged) < depth:
            epoch, i, j = windows[k_stage]
            if epoch not in eta:
                if retired < k_stage:
                    return  # the epoch nonce needs every window before it retired
                eta[epoch] = praos.tick(params, lview_of(epoch), _slot_at(hvs, i),
                                        state).state.epoch_nonce
            whvs = hvs[i:j]
            staged.append((k_stage, pool.submit(
                prepare_window, params, lview_of(epoch), eta[epoch], whvs,
                staging_buffer(params, whvs, dev))))
            k_stage += 1

    def failed(e: BaseException) -> bool:
        return sup.enabled and recovery.recoverable(e)

    def dispatch_ready() -> None:
        nonlocal carry, carry_ok
        while staged and len(inflight) < depth:
            k, fut = staged[0]
            if inflight and not fut.done():
                return  # retire a window while the staging thread works
            try:
                sw = fut.result()._replace(aggregate=aggregate)
            except Exception as e:  # noqa: BLE001 — the staging thread's death
                if not failed(e):
                    raise
                staged.popleft()
                carry_ok = False
                inflight.append((k, None, _FailedWindow(e)))
                continue
            if sw.layout is not None and not carry_ok:
                if inflight:
                    return  # the window that broke the chain retires first
                carry, carry_ok = state_carry(state), True
            staged.popleft()
            try:
                v = dispatch_prepared(sw, dev, carry if sw.layout is not None else None)
            except Exception as e:  # noqa: BLE001 — recovered where it retires
                if not failed(e):
                    raise
                carry_ok = False
                inflight.append((k, sw, _FailedWindow(e)))
                continue
            if v.carried:
                carry = v.carry
            else:
                carry_ok = False
            inflight.append((k, sw, v))

    try:
        while retired < len(windows):
            stage_ahead()
            dispatch_ready()
            stage_ahead()  # refill what the launches freed before waiting below
            k, sw, v = inflight.popleft()
            epoch, i, j = windows[k]
            ticked = praos.tick(params, lview_of(epoch), _slot_at(hvs, i), state)
            if ticked.state.epoch_nonce != eta[epoch]:
                raise AssertionError(f"window {k} was staged with another epoch nonce")
            try:
                if isinstance(v, _FailedWindow):
                    raise v.exc
                res = _retire(params, ticked, sw.hvs, sw.pre, v)
            except Exception as e:  # noqa: BLE001 — the supervisor decides
                if not failed(e):
                    raise
                res = sup.recover_window(params, ticked, hvs[i:j], e, "device", dev,
                                         aggregate, k)
                # what is in flight behind it chained its carry: stage it again
                staged.extendleft(reversed([
                    (k2, _done(exc=v2.exc) if sw2 is None else _done(sw2))
                    for k2, sw2, v2 in inflight]))
                inflight.clear()
                carry_ok = False
            state = res.state
            total += res.n_valid
            if res.error is not None:
                return BatchResult(state, total, res.error)
            retired += 1
            _retired(state, res.n_valid)
        return BatchResult(state, total, None)
    finally:
        for _k, fut in staged:
            fut.cancel()
        pool.shutdown(wait=True, cancel_futures=True)
