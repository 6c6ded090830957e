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

A window the packed staging declines because its bodies do not embed
the fields or its integers pass int32 (`field-offsets`,
`field-mismatch`, `int32-range`) goes through the generic staging
instead (`stage`: per-lane columns padded on the host) and the same
five stage kernels; the reason is recorded in `DECLINES`. Such a window
ships its eta column and folds on the host, which breaks the carry
chain: the next packed window seeds it again from the host state.

The leader threshold is a bracketed device compare; the measure-zero
band between the brackets takes the exact host check.

`validate_chain` segments a run of headers at epoch boundaries, at
`max_batch`, and where the signed-body width or the proof format
changes (a packed window has one of each; segmentation never changes a
verdict), threading the PraosState and the nonce carry between windows.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..ops import stage_np
from ..ops.pk import hashes as ph
from ..ops.pk import kernels as pk_kernels
from . import leader, nonces, praos
from .praos import PraosParams, PraosState, TickedPraosState
from .views import HeaderView, LedgerView, hash_key, hash_vrf_vk

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


def host_prechecks(params: PraosParams, ledger_view: LedgerView,
                   hvs: Sequence[HeaderView]) -> HostChecks:
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
    `dispatch_window` stages the GENERIC_REASONS windows generically and
    raises on the others. `validate_chain` never hands over a
    `body-width-mixed` or `proof-format` window (it cuts at both), but it
    does hand over a `kes-sig-len` one (a KES signature whose length does
    not match the parameters' depth), so a chain with such a header
    raises, as the reference's device path does."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# the packed-staging declines that the generic staging takes
GENERIC_REASONS = frozenset({"field-offsets", "field-mismatch", "int32-range"})


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


def bucket_size(b: int, minimum: int = 8) -> int:
    """Lane bucket: next power of two up to 2048, then the next multiple
    of 2048 (bounds tail padding at under 2048 lanes)."""
    n = minimum
    while n < b and n < 2048:
        n *= 2
    if b <= n:
        return n
    return ((b + 2047) // 2048) * 2048


def pad_packed_to(packed: Packed, size: int) -> Packed:
    """Pad the per-lane columns to `size` by replicating lane 0 (tables
    and the nonce are shared). Padding lanes are computed and ignored:
    every consumer slices to the real lanes."""
    b = packed.body.shape[0]
    if b == size:
        return packed

    def pad(x):
        return np.concatenate([x, np.repeat(x[:1], size - b, axis=0)], axis=0)

    return packed._replace(
        body=pad(packed.body), kes_rs=pad(packed.kes_rs),
        kes_tail_idx=pad(packed.kes_tail_idx), slot=pad(packed.slot),
        counter=pad(packed.counter), c0=pad(packed.c0),
        thr_idx=pad(packed.thr_idx), within=pad(packed.within),
    )


def upload_packed(packed: Packed, device) -> Packed:
    """The packed columns on `device`, dtypes as they are (uint8 bytes,
    int32 integers); columns already there are not copied."""
    return Packed(*(torch.as_tensor(a, device=device) for a in packed))


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
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
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
    """A dispatched window's result: u32 verdict words on the host, and
    either the window's nonce carry-out (`carried`: the device tensor
    that seeds the next window, and its two nonces read back) or the eta
    bytes (a generically staged window). The per-lane flags, eta and
    leader values stay on the device until `full()` (only a failing or
    ambiguous window needs them)."""

    def __init__(self, masks, b, handles, *, carry=None, eta_u8=None):
        self.masks = masks.astype(np.uint32)
        self.b = b
        self._handles = handles  # (flags [5, B], eta [32, B], lv [32, B])
        self.carry = carry  # [66] uint8 on the device, or None
        self.carried = carry is not None
        # (evolving, candidate) after the window's last lane
        self.nonces = nonces.unpack_carry(carry.cpu().numpy()) if self.carried else None
        self.eta_u8 = eta_u8  # [b, 32] uint8, or None (left on the device)
        self._full = None

    def _row(self, r: int) -> np.ndarray:
        bits = np.unpackbits(
            np.ascontiguousarray(self.masks[r]).view(np.uint8), bitorder="little")
        return bits[: self.b].astype(bool)

    def clean(self) -> bool:
        """Every real lane passed every check outright."""
        return all(self._row(r).all() for r in range(4)) and not self._row(4).any()

    def eta_bytes(self) -> np.ndarray:
        """The [b, 32] uint8 eta column a window without a carry shipped;
        None for a carried window (its column stays on the device for
        `full()`)."""
        return self.eta_u8

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
    if not v.clean():
        return None
    if any(e is not None for e in pre.kes_window_errors):
        return None
    if any(e is not None for e in pre.vrf_lookup_errors):
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


def epilogue(params: PraosParams, ticked: TickedPraosState,
             hvs: Sequence[HeaderView], pre: HostChecks, v) -> BatchResult:
    """Sequential epilogue: counters + nonce fold, stop at the first
    failure with the reference's error."""
    if isinstance(v, PackedVerdicts):
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
    etas = np.ascontiguousarray(np.asarray(v.eta).astype(np.uint8))
    for i, hv in enumerate(hvs):
        err = lane_error(params, lview, eta0, hv, pre, v, i, counters)
        if err is not None:
            state = PraosState(
                last_slot=last_slot, ocert_counters=counters,
                evolving_nonce=evolving, candidate_nonce=candidate,
                epoch_nonce=st.epoch_nonce, lab_nonce=lab,
                last_epoch_block_nonce=st.last_epoch_block_nonce,
            )
            return BatchResult(state, i, err)
        evolving = nonces.combine(evolving, etas[i].tobytes())
        if hv.slot + params.stability_window < params.first_slot_of(
                params.epoch_of(hv.slot) + 1):
            candidate = evolving
        lab = nonces.prev_hash_to_nonce(hv.prev_hash)
        counters[hash_key(hv.vk_cold)] = hv.ocert.counter
        last_slot = hv.slot
    state = PraosState(
        last_slot=last_slot, ocert_counters=counters,
        evolving_nonce=evolving, candidate_nonce=candidate,
        epoch_nonce=st.epoch_nonce, lab_nonce=lab,
        last_epoch_block_nonce=st.last_epoch_block_nonce,
    )
    return BatchResult(state, len(hvs), None)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


def run_batch_native(params: PraosParams, ledger_view: LedgerView,
                     epoch_nonce, hvs: Sequence[HeaderView],
                     pre: HostChecks) -> Verdicts:
    """The C++ verifier (native/hostcrypto.cpp) over a window, in the
    same Verdicts shape. It stops at the first failing lane; lanes past
    it carry don't-care verdicts the epilogue never reads."""
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


def dispatch_window(params: PraosParams, lview: LedgerView, eta0,
                    hvs: Sequence[HeaderView], pre: HostChecks,
                    device: torch.device, carry=None) -> PackedVerdicts:
    """Stage -> H2D -> unpack -> the five stage kernels of the window's
    proof format -> reduce with the nonce fold -> D2H of the mask words
    and the carry. `carry` is the fold's carry-in: the previous packed
    window's device carry-out, or a host seed (`state_carry`); None is
    the neutral one. A window the packed staging declines for one of
    GENERIC_REASONS is staged generically, runs the same kernels and
    ships its eta bytes (no fold, no carry); any other decline raises."""
    b = len(hvs)
    try:
        layout, packed = stage_packed(params, lview, eta0, hvs)
    except NotStagedError as e:
        if e.reason not in GENERIC_REASONS:
            raise
        DECLINES[e.reason] = DECLINES.get(e.reason, 0) + 1
        batch = stage(params, lview, eta0, hvs, pre.kes_evolution)
        cols = batch_columns(pad_batch_to(batch, bucket_size(b)), device)
        (masks, eta_u8), flags, eta, lv = pk_kernels.verify_staged(
            cols, isinstance(batch.vrf, stage_np.EcvrfBcBatch), params.kes_depth, b)
        return PackedVerdicts(masks.cpu().numpy(), b, (flags, eta, lv),
                              eta_u8=eta_u8.cpu().numpy())
    packed = pad_packed_to(packed, bucket_size(b))
    if carry is None:
        carry = nonces.pack_carry(None, None)
    (masks, carry_out), flags, eta, lv = pk_kernels.verify_praos_packed_split(
        layout, packed, b, device, torch.as_tensor(carry, device=device))
    return PackedVerdicts(masks.cpu().numpy(), b, (flags, eta, lv), carry=carry_out)


def validate_batch(params: PraosParams, ticked: TickedPraosState,
                   hvs: Sequence[HeaderView], backend: str,
                   device: torch.device | None, carry=None) -> BatchResult:
    """One within-epoch window of one body width and proof format.
    `carry`: the device nonce carry of the previous packed window, None
    to seed the fold from the ticked state (tick only rotates the epoch
    nonce, so a carry stays valid across an epoch boundary)."""
    lview = ticked.ledger_view
    eta0 = ticked.state.epoch_nonce
    pre = host_prechecks(params, lview, hvs)
    if backend == "native":
        v = run_batch_native(params, lview, eta0, hvs, pre)
    elif backend == "device":
        seed = state_carry(ticked.state) if carry is None else carry
        v = dispatch_window(params, lview, eta0, hvs, pre, device, seed)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    res = epilogue(params, ticked, hvs, pre, v)
    if isinstance(v, PackedVerdicts) and v.carried and res.error is None:
        res.carry = v.carry
    return res


def _shape_key(hv: HeaderView):
    return (len(hv.signed_bytes), len(hv.vrf_proof))


def validate_chain(params: PraosParams, ledger_view_for_epoch, state: PraosState,
                   hvs: Sequence[HeaderView], max_batch: int = 8192,
                   backend: str = "device", device=None) -> BatchResult:
    """Validate a run of headers: windows cut at epoch boundaries, at
    `max_batch`, and where the body width or proof format changes; the
    state threads through `tick` between windows, and the device nonce
    carry from each packed window to the next (a generically staged
    window breaks it; the next packed window seeds it from the state).
    Equivalent to folding the reference's `update` over `hvs` (same
    final state, same first error). backend="device" runs on `device`
    (None -> CUDA, raising when it is absent); backend="native" runs the
    C++ verifier."""
    dev = resolve(device) if backend == "device" else None
    carry = None
    total = 0
    n = len(hvs)
    i = 0
    while i < n:
        epoch = params.epoch_of(hvs[i].slot)
        j = i + 1
        key = _shape_key(hvs[i])
        while (j < n and j - i < max_batch and params.epoch_of(hvs[j].slot) == epoch
               and _shape_key(hvs[j]) == key):
            j += 1
        lview = ledger_view_for_epoch(epoch)
        ticked = praos.tick(params, lview, hvs[i].slot, state)
        res = validate_batch(params, ticked, hvs[i:j], backend, dev, carry)
        state, carry = res.state, res.carry
        total += res.n_valid
        if res.error is not None:
            return BatchResult(state, total, res.error)
        i = j
    return BatchResult(state, total, None)
