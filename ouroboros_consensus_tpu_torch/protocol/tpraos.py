"""TPraos: Transitional Praos — the Shelley-era protocol with the BFT
overlay schedule; the port's copy of the reference's protocol/tpraos.py.

Reference: `Protocol/TPraos.hs` (ConsensusProtocol instance :304-392),
whose header rules are the ledger's PRTCL/OVERLAY rules. The crypto is
Praos's (OCert Ed25519, CompactSum KES, ECVRF — Praos.hs:543,580,582);
only the leader rule changes:

  * a fraction `d` (decentralization) of each epoch's slots form the
    OVERLAY schedule: position j of slot i advances when ceil((i+1)·d)
    crosses ceil(i·d);
  * every ascInv = ceil(1/f)-th overlay position is ACTIVE and assigned
    round-robin to a genesis delegate, who must issue the block, with
    full VRF/KES/OCert checks but NO stake threshold;
  * other overlay positions are inactive: any block there is invalid;
  * non-overlay slots follow the ordinary Praos lottery.

`TPraosProtocol.validate_batch` with the device backend runs the
reference's device batch (its `_device_batch`): the generic staging of
the window (batch.stage, any body width, the genesis delegates' lanes
with stake 0), the five stage kernels of the window's proof format on the
card (kernels.verify_staged), the overlay lanes' leader verdict overridden
on the host (their rule was settled by `host_prechecks`), then the
sequential epilogue with the genesis-delegate counter default. A delegate
is not in the pool distribution, so the packed staging's per-pool
threshold rows and the window aggregate do not take these windows. A
failed device batch raises: there is no host fold to fall back on.

`translate_state` is the TPraos→Praos ChainDepState translation at the
era boundary (Protocol/Praos/Translate.hs): nonces and OCert counters
carry over unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from fractions import Fraction
from typing import Sequence

import numpy as np

from .. import native
from ..device import resolve
from . import batch as pbatch
from . import nonces, praos, select
from .instances import PraosIsLeader, check_is_leader as praos_check_is_leader
from .praos import PraosParams, PraosState, PraosValidationError
from .views import LedgerView, hash_key, hash_vrf_vk

# ---------------------------------------------------------------------------
# Parameters / state / views
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GenDeleg:
    """One genesis delegate (SL.GenDelegPair): the operational cold key
    and registered VRF key hash the overlay check matches against."""

    vk_cold: bytes
    vrf_key_hash: bytes


@dataclass(frozen=True)
class TPraosParams:
    """PraosParams + decentralization (TPraos.hs TPraosParams)."""

    praos: PraosParams
    decentralization: Fraction  # d in [0, 1]; 0 = fully decentralized

    def __getattr__(self, name):
        return getattr(self.praos, name)


@dataclass(frozen=True)
class TPraosLedgerView(LedgerView):
    """LedgerView + the ordered genesis delegation map (SL.LedgerView
    lvGenDelegs)."""

    gen_delegs: Sequence[GenDeleg] = ()


@dataclass(frozen=True)
class TPraosState(PraosState):
    """ChainDepState (TPraos c): Praos's nonce and counter content
    (TPraos.hs:219, SL.ChainDepState)."""


@dataclass(frozen=True)
class TickedTPraosState:
    state: TPraosState
    ledger_view: TPraosLedgerView


# ---------------------------------------------------------------------------
# Overlay schedule (Shelley overlaySchedule / lookupInOverlaySchedule)
# ---------------------------------------------------------------------------


def _asc_inv(f: Fraction) -> int:
    return max(1, math.ceil(1 / f))


def overlay_position(params: TPraosParams, slot: int) -> int | None:
    """None if `slot` is not an overlay slot, else its overlay position
    within the epoch (the ceil(i*d) step advances exactly on overlay
    slots)."""
    d = params.decentralization
    if d == 0:
        return None
    i = slot - params.praos.first_slot_of(params.praos.epoch_of(slot))
    lo = math.ceil(i * d)
    hi = math.ceil((i + 1) * d)
    return lo if hi > lo else None


def overlay_slot_assignment(params: TPraosParams, n_delegs: int,
                            slot: int) -> tuple[bool, int | None] | None:
    """None = not an overlay slot; (False, None) = inactive overlay slot
    (must be empty); (True, j) = active, assigned to delegate j."""
    pos = overlay_position(params, slot)
    if pos is None:
        return None
    ai = _asc_inv(params.praos.active_slot_coeff)
    if pos % ai != 0 or n_delegs == 0:
        return (False, None)  # no delegate can lead it
    return (True, (pos // ai) % n_delegs)


# ---------------------------------------------------------------------------
# Errors beyond the shared Praos taxonomy
# ---------------------------------------------------------------------------


@dataclass
class WrongGenesisDelegate(PraosValidationError):
    """An overlay block issued by someone other than the scheduled
    genesis delegate."""

    slot: int
    expected: bytes
    got: bytes


@dataclass
class NonActiveSlot(PraosValidationError):
    """A block in an inactive overlay slot (NonActiveSlotOVERLAY)."""

    slot: int


@dataclass
class WrongGenesisVRFKey(PraosValidationError):
    slot: int
    expected: bytes
    got: bytes


# ---------------------------------------------------------------------------
# tick / reupdate (host semantics)
# ---------------------------------------------------------------------------


def tick(params: TPraosParams, lview: TPraosLedgerView, slot: int,
         state: TPraosState) -> TickedTPraosState:
    inner = praos.tick(params.praos, lview, slot, state)
    return TickedTPraosState(TPraosState(**vars(inner.state)), inner.ledger_view)


def _overlay_error(params: TPraosParams, lview: TPraosLedgerView, hv):
    """The overlay's replacement of the Praos pool lookup + threshold:
    None for a non-overlay slot (the Praos rules apply), False for an
    active overlay slot whose delegate checks pass, else the error."""
    assign = overlay_slot_assignment(params, len(lview.gen_delegs), hv.slot)
    if assign is None:
        return None
    active, j = assign
    if not active:
        return NonActiveSlot(hv.slot)
    deleg = lview.gen_delegs[j]
    if hv.vk_cold != deleg.vk_cold:
        return WrongGenesisDelegate(hv.slot, deleg.vk_cold, hv.vk_cold)
    got_hash = hash_vrf_vk(hv.vrf_vk)
    if got_hash != deleg.vrf_key_hash:
        return WrongGenesisVRFKey(hv.slot, deleg.vrf_key_hash, got_hash)
    return False


def _counters_known(lview: TPraosLedgerView, hk: bytes) -> bool:
    if hk in lview.pool_distr:
        return True
    return any(hash_key(d.vk_cold) == hk for d in lview.gen_delegs)


def reupdate(params: TPraosParams, hv, slot: int, ticked: TickedTPraosState) -> TPraosState:
    inner = praos.reupdate(params.praos, hv, slot,
                           praos.TickedPraosState(ticked.state, ticked.ledger_view))
    return TPraosState(**vars(inner))


def translate_state(state: TPraosState) -> PraosState:
    """TPraos → Praos ChainDepState translation at the era boundary
    (Protocol/Praos/Translate.hs): nonces and OCert counters carry over."""
    return PraosState(**vars(state))


# ---------------------------------------------------------------------------
# Forging (checkIsLeader, TPraos.hs:304-355)
# ---------------------------------------------------------------------------


def check_is_leader(params: TPraosParams, can_be_leader, slot: int,
                    ticked: TickedTPraosState,
                    deleg_index: int | None = None) -> PraosIsLeader | None:
    """Overlay slots: lead iff we are the scheduled delegate (the VRF is
    still evaluated — a draft-03 proof, as the reference's host prover
    gives); non-overlay: the Praos lottery."""
    lview = ticked.ledger_view
    assign = overlay_slot_assignment(params, len(lview.gen_delegs), slot)
    if assign is not None:
        active, j = assign
        if not active or deleg_index is None or j != deleg_index:
            return None
        alpha = nonces.mk_input_vrf(slot, ticked.state.epoch_nonce)
        proof = native.ecvrf_prove(can_be_leader.vrf_sign_seed, alpha)
        return PraosIsLeader(native.proof_to_hash(proof), proof)
    return praos_check_is_leader(params.praos, can_be_leader, slot,
                                 praos.TickedPraosState(ticked.state, lview))


# ---------------------------------------------------------------------------
# Batched validation
# ---------------------------------------------------------------------------


def host_prechecks(params: TPraosParams, lview: TPraosLedgerView, hvs) -> pbatch.HostChecks:
    """batch.host_prechecks with the overlay slots' VRF-side check the
    delegate assignment instead of the pool lookup (the reference's
    tpraos.host_prechecks, :314)."""
    base = pbatch.host_prechecks(params.praos, lview, hvs)
    vrf_errors = list(base.vrf_lookup_errors)
    for i, hv in enumerate(hvs):
        err = _overlay_error(params, lview, hv)
        if err is None:
            continue  # non-overlay: keep the pool-lookup result
        vrf_errors[i] = err if err else None
    return pbatch.HostChecks(base.kes_window_errors, vrf_errors, base.kes_evolution)


def override_overlay_leader(v: pbatch.Verdicts, overlay_lanes) -> pbatch.Verdicts:
    """The overlay lanes' leader verdict set to a certain win (their
    leader rule was settled by host_prechecks): exact, not probabilistic."""
    ok_leader = np.array(v.ok_leader, copy=True)
    ambiguous = np.array(v.leader_ambiguous, copy=True)
    for i, is_overlay in enumerate(overlay_lanes):
        if is_overlay:
            ok_leader[i] = True
            ambiguous[i] = False
    return v._replace(ok_leader=ok_leader, leader_ambiguous=ambiguous)


class TPraosProtocol:
    """ConsensusProtocol (TPraos c) instance-as-object (TPraos.hs:304).
    `device` (None: the card, raising without CUDA at the first device
    batch; "cpu": the plain twins) is where backend "device" runs."""

    def __init__(self, params: TPraosParams, device=None):
        self.params = params
        self.security_param = params.praos.security_param
        self.device = device

    def initial_state(self) -> TPraosState:
        return TPraosState()

    def tick(self, ledger_view, slot, state) -> TickedTPraosState:
        return tick(self.params, ledger_view, slot, state)

    def update(self, view, slot, ticked) -> TPraosState:
        """updateChainDepState (TPraos.hs:380 → PRTCL): one header through
        the C++ verifier; raises the reference's error."""
        res = self.validate_batch(ticked, [view], backend="native")
        if res.error is not None:
            raise res.error
        return res.state

    def reupdate(self, view, slot, ticked) -> TPraosState:
        return reupdate(self.params, view, slot, ticked)

    def check_is_leader(self, can_be_leader, slot, ticked, deleg_index=None):
        return check_is_leader(self.params, can_be_leader, slot, ticked, deleg_index)

    def select_view(self, header) -> select.PraosSelectView:
        return select.PraosSelectView.from_header(header)  # Praos/Common.hs order

    def compare_candidates(self, ours, theirs) -> int:
        return select.compare_select_views(ours, theirs)

    def validate_batch(self, ticked, hvs, backend: str = "device") -> pbatch.BatchResult:
        """The fold of `update` over a within-epoch run of views as one
        batch, the overlay lanes' leader verdicts set on the host: the
        stage kernels ("device") or the C++ verifier ("native"). The
        reference's "sharded" route waits for the multi-card port
        (ROADMAP A.9)."""
        if backend == "sharded":
            raise ValueError("the sharded TPraos route is not ported yet (ROADMAP A.9)")
        if backend not in ("device", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if not hvs:
            return pbatch.BatchResult(ticked.state, 0, None)
        params, lview = self.params, ticked.ledger_view
        eta0 = ticked.state.epoch_nonce
        pre = host_prechecks(params, lview, hvs)
        overlay = [overlay_position(params, hv.slot) is not None for hv in hvs]
        if backend == "native":
            v = pbatch.run_batch_native(params.praos, lview, eta0, hvs, pre)
        else:
            v = self._device_verdicts(lview, eta0, hvs, pre)
        v = override_overlay_leader(v, overlay)
        inner = praos.TickedPraosState(PraosState(**vars(ticked.state)), lview)
        res = pbatch.epilogue(params.praos, inner, hvs, pre, v, lane_error_fn=self._lane_error)
        return replace(res, state=TPraosState(**vars(res.state)))

    def _device_verdicts(self, lview, eta0, hvs, pre) -> pbatch.Verdicts:
        """The reference's device batch: the generic staging, padded to the
        bucket, through batch.dispatch_prepared (the five stage kernels of
        the proof format on the card, its `dispatch` chaos seam), and the
        per-lane verdicts copied back."""
        b = len(hvs)
        batch = pbatch.stage(self.params.praos, lview, eta0, hvs, pre.kes_evolution)
        sw = pbatch.StagedWindow(hvs, pre, b, None, None, None,
                                 pbatch.pad_batch_to(batch, pbatch.bucket_size(b)))
        return pbatch.dispatch_prepared(sw, resolve(self.device)).full()

    def _lane_error(self, params, lview, eta0, hv, pre, v, i, counters):
        """batch.lane_error with the genesis-delegate counter default (a
        delegate with no prior counter starts at m = 0, like pools)."""
        err = pbatch.lane_error(params, lview, eta0, hv, pre, v, i, counters)
        if isinstance(err, praos.NoCounterForKeyHashOCERT):
            hk = hash_key(hv.vk_cold)
            if _counters_known(lview, hk):
                return pbatch.lane_error(params, lview, eta0, hv, pre, v, i,
                                         {**counters, hk: 0})
        return err
