"""The Praos chain-dependent state machine (host), trimmed to replay.

Semantics mirror the reference `ConsensusProtocol (Praos c)` instance
(Protocol/Praos.hs:364-606):

  * `tick`     = tickChainDepState (Praos.hs:407-432): epoch-boundary
                 nonce rotation.
  * `reupdate` = reupdateChainDepState (Praos.hs:468-502): nonce and
                 ocert-counter bookkeeping, no crypto.

The crypto of updateChainDepState runs batched (protocol/batch.py); the
error taxonomy below follows `PraosValidationErr` (Praos.hs:319-356)
constructor by constructor, with the same fields as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from fractions import Fraction
from functools import cached_property
from typing import Mapping

from . import nonces
from .nonces import Nonce
from .views import HeaderView, LedgerView, hash_key


@dataclass(frozen=True)
class PraosParams:
    """Node-independent Praos parameters (Praos.hs:184-209)."""

    slots_per_kes_period: int = 129600
    max_kes_evolutions: int = 62
    security_param: int = 2160  # k
    active_slot_coeff: Fraction = Fraction(1, 20)  # f
    epoch_length: int = 432000  # fixed EpochInfo (slots per epoch)
    kes_depth: int = 6  # CompactSum tree depth

    @cached_property
    def stability_window(self) -> int:
        """3k/f rounded up (cardano-ledger computeStabilityWindow)."""
        w = 3 * self.security_param / self.active_slot_coeff
        return int(-(-w // 1))

    def epoch_of(self, slot: int) -> int:
        return slot // self.epoch_length

    def first_slot_of(self, epoch: int) -> int:
        return epoch * self.epoch_length

    def kes_period_of(self, slot: int) -> int:
        return slot // self.slots_per_kes_period

    def is_new_epoch(self, last_slot: int | None, slot: int) -> bool:
        """isNewEpoch (Protocol/Ledger/Util.hs:18-40); Origin -> epoch 0."""
        old_epoch = 0 if last_slot is None else self.epoch_of(last_slot)
        first = self.first_slot_of(old_epoch)
        epochs_after = max(0, slot - first) // self.epoch_length
        return old_epoch + epochs_after > old_epoch


@dataclass(frozen=True)
class PraosState:
    """PraosState (Praos.hs:248-264): last slot, ocert counters, 5 nonces."""

    last_slot: int | None = None
    ocert_counters: Mapping[bytes, int] = field(default_factory=dict)
    evolving_nonce: Nonce = None
    candidate_nonce: Nonce = None
    epoch_nonce: Nonce = None
    lab_nonce: Nonce = None  # nonce from last applied block's prev-hash
    last_epoch_block_nonce: Nonce = None


@dataclass(frozen=True)
class TickedPraosState:
    state: PraosState
    ledger_view: LedgerView


class PraosValidationError(Exception):
    """Base of the Praos validation error taxonomy."""


@dataclass
class VRFKeyUnknown(PraosValidationError):
    pool_key_hash: bytes


@dataclass
class VRFKeyWrongVRFKey(PraosValidationError):
    pool_key_hash: bytes
    registered_vrf_hash: bytes
    header_vrf_hash: bytes


@dataclass
class VRFKeyBadProof(PraosValidationError):
    slot: int
    epoch_nonce: Nonce


@dataclass
class VRFLeaderValueTooBig(PraosValidationError):
    leader_value: int
    sigma: Fraction
    active_slot_coeff: Fraction


@dataclass
class KESBeforeStartOCERT(PraosValidationError):
    ocert_start_period: int
    current_period: int


@dataclass
class KESAfterEndOCERT(PraosValidationError):
    current_period: int
    ocert_start_period: int
    max_kes_evolutions: int


@dataclass
class CounterTooSmallOCERT(PraosValidationError):
    last_counter: int
    current_counter: int


@dataclass
class CounterOverIncrementedOCERT(PraosValidationError):
    last_counter: int
    current_counter: int


@dataclass
class InvalidSignatureOCERT(PraosValidationError):
    counter: int
    kes_period: int


@dataclass
class InvalidKesSignatureOCERT(PraosValidationError):
    current_period: int
    start_period: int
    expected_evolutions: int


@dataclass
class NoCounterForKeyHashOCERT(PraosValidationError):
    pool_key_hash: bytes


def tick(
    params: PraosParams, ledger_view: LedgerView, slot: int, state: PraosState
) -> TickedPraosState:
    """tickChainDepState (Praos.hs:407-432): on epoch change, rotate the
    epoch nonce (candidate ⭒ last-epoch-block nonce) and latch the LAB
    nonce as the new last-epoch-block nonce."""
    if params.is_new_epoch(state.last_slot, slot):
        state = replace(
            state,
            epoch_nonce=nonces.combine(
                state.candidate_nonce, state.last_epoch_block_nonce
            ),
            last_epoch_block_nonce=state.lab_nonce,
        )
    return TickedPraosState(state, ledger_view)


def reupdate(
    params: PraosParams, hv: HeaderView, slot: int, ticked: TickedPraosState
) -> PraosState:
    """reupdateChainDepState (Praos.hs:468-502): bookkeeping, no crypto."""
    cs = ticked.state
    eta = nonces.vrf_nonce_value(hv.vrf_output)
    new_evolving = nonces.combine(cs.evolving_nonce, eta)
    first_slot_next_epoch = params.first_slot_of(params.epoch_of(slot) + 1)
    within_stability = slot + params.stability_window < first_slot_next_epoch
    counters = dict(cs.ocert_counters)
    counters[hash_key(hv.vk_cold)] = hv.ocert.counter
    return replace(
        cs,
        last_slot=slot,
        lab_nonce=nonces.prev_hash_to_nonce(hv.prev_hash),
        evolving_nonce=new_evolving,
        candidate_nonce=new_evolving if within_stability else cs.candidate_nonce,
        ocert_counters=counters,
    )
