"""Concrete ConsensusProtocol instances, the port's copy of the
reference's protocol/instances.py.

* `PraosProtocol` — host semantics from protocol/praos.py, the crypto of
  `update` batched through protocol/batch.py: the stage kernels on the
  card ("device") or the C++ verifier ("native") (reference instance:
  Praos.hs:364).
* `BftProtocol` — round-robin BFT for tests (Protocol/BFT.hs): slot s must
  be signed by node (s mod n); one Ed25519 verify, no state.
* `PBftProtocol` — permissive BFT (Protocol/PBFT.hs), Byron's protocol:
  delegate-signed headers under a signing-window threshold.
* `LeaderScheduleProtocol` — scripted leadership (Protocol/LeaderSchedule.hs).

Single signatures verify on the host through the C++ verifier
(native.ed25519_verify); a Byron segment's signatures verify as one batch
(hardfork/composite.py, ops/ed25519_batch.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Mapping, Sequence

from .. import native
from ..device import resolve
from . import batch as pbatch
from . import nonces, praos, select
from .abstract import ConsensusError
from .leader import check_leader_value
from .praos import PraosParams, PraosState, TickedPraosState
from .views import OCert, hash_key

# ---------------------------------------------------------------------------
# Praos
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PraosCanBeLeader:
    """Forging credentials (Praos/Common.hs:83-93)."""

    ocert: OCert
    vk_cold: bytes
    vrf_sign_seed: bytes  # VRF signing key seed


@dataclass(frozen=True)
class PraosIsLeader:
    """Proof of leadership: the certified VRF result (Praos.hs:212-216)."""

    vrf_output: bytes  # 64
    vrf_proof: bytes  # 80 (draft-03) or 128 (batch-compatible)


def check_is_leader(params: PraosParams, can_be_leader: PraosCanBeLeader, slot: int,
                    ticked: TickedPraosState) -> PraosIsLeader | None:
    """checkIsLeader (Praos.hs:375-397): the VRF at InputVRF(slot, eta0),
    proved batch-compatible (the reference forge's default format), and
    the leader threshold test."""
    alpha = nonces.mk_input_vrf(slot, ticked.state.epoch_nonce)
    proof = native.ecvrf_prove_bc(can_be_leader.vrf_sign_seed, alpha)
    output = native.proof_to_hash(proof)
    entry = ticked.ledger_view.pool_distr.get(hash_key(can_be_leader.vk_cold))
    sigma = entry.stake if entry is not None else Fraction(0)
    if check_leader_value(nonces.vrf_leader_value(output), sigma, params.active_slot_coeff):
        return PraosIsLeader(output, proof)
    return None


def _split_by_proof(params: PraosParams, ticked: TickedPraosState, hvs, run,
                    collect_states: bool = False):
    """The reference validate_batch's cut at proof-format changes (a
    batch stages one proof column; the cut changes no verdict): `run`
    over each run of one format, the state ticked between them; with
    `collect_states`, the runs' per-header states concatenated."""
    total = 0
    states = [] if collect_states else None
    i = 0
    while True:
        j = pbatch._proof_break(hvs, i, len(hvs))
        res = run(ticked, hvs[i:j])
        total += res.n_valid
        if states is not None:
            states.extend(res.states or [])
        if res.error is not None or j == len(hvs):
            return pbatch.BatchResult(res.state, total, res.error, states, res.carry)
        i = j
        ticked = praos.tick(params, ticked.ledger_view, pbatch._slot_at(hvs, i), res.state)


class PraosProtocol:
    """ConsensusProtocol (Praos c) — instance-as-object over praos.py.
    `device` (None: the card, raising without CUDA at the first device
    batch; "cpu": the plain twins) is where backend "device" runs. A
    device batch is one packed window through the five per-lane stage
    kernels (no window aggregate), as the reference instance's batch
    verifies lane by lane. `use_device_batch` (the reference's): True
    sends the LedgerDB's runs of more than one fresh block to
    `validate_batch` on the card; False folds them block by block through
    `update` (the C++ verifier)."""

    def __init__(self, params: PraosParams, device=None, use_device_batch: bool = True):
        self.params = params
        self.security_param = params.security_param
        self.device = device
        self.use_device_batch = use_device_batch

    def initial_state(self) -> PraosState:
        return PraosState()

    def tick(self, ledger_view, slot, state) -> TickedPraosState:
        return praos.tick(self.params, ledger_view, slot, state)

    def update(self, view, slot, ticked) -> PraosState:
        """updateChainDepState (Praos.hs:441-466): one header through the
        C++ verifier; raises the reference's error."""
        res = self.validate_batch(ticked, [view], backend="native")
        if res.error is not None:
            raise res.error
        return res.state

    def reupdate(self, view, slot, ticked) -> PraosState:
        return praos.reupdate(self.params, view, slot, ticked)

    def check_is_leader(self, can_be_leader, slot, ticked):
        return check_is_leader(self.params, can_be_leader, slot, ticked)

    def select_view(self, header) -> select.PraosSelectView:
        return select.PraosSelectView.from_header(header)

    def compare_candidates(self, ours, theirs) -> int:
        return select.compare_select_views(ours, theirs)

    def validate_batch(self, ticked, views: Sequence, collect_states: bool = False,
                       backend: str = "device") -> pbatch.BatchResult:
        """The fold of `update` over a within-epoch run of views as one
        batch: the stage kernels ("device") or the C++ verifier
        ("native"); cut where the proof format changes. A device window is
        seeded from the ticked state. `collect_states`: the state after
        each valid header in `states`."""
        if backend not in ("device", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if not len(views):
            return pbatch.BatchResult(ticked.state, 0, None, [] if collect_states else None)
        dev = resolve(self.device) if backend == "device" else None
        return _split_by_proof(self.params, ticked, views, lambda t, hvs: pbatch.validate_batch(
            self.params, t, hvs, backend, dev, aggregate=False,
            collect_states=collect_states), collect_states)


# ---------------------------------------------------------------------------
# BFT (Protocol/BFT.hs): round-robin signing for tests
# ---------------------------------------------------------------------------


@dataclass
class BftInvalidSignature(ConsensusError):
    slot: int


@dataclass
class BftWrongLeader(ConsensusError):
    slot: int
    expected_node: int


@dataclass(frozen=True)
class BftState:
    """BFT has no interesting chain-dep state (reference: ())."""

    last_slot: int | None = None


@dataclass(frozen=True)
class TickedBftState:
    state: BftState


@dataclass(frozen=True)
class BftView:
    """ValidateView: the signed bytes + signature + claimed node id."""

    node_id: int
    signed_bytes: bytes
    signature: bytes


class BftProtocol:
    """Round-robin: slot s is led by node (s mod num_nodes)."""

    def __init__(self, num_nodes: int, verification_keys: Sequence[bytes],
                 security_param: int = 2160):
        self.num_nodes = num_nodes
        self.vks = list(verification_keys)
        self.security_param = security_param

    def initial_state(self) -> BftState:
        return BftState()

    def tick(self, ledger_view, slot, state) -> TickedBftState:
        return TickedBftState(state)

    def update(self, view: BftView, slot, ticked) -> BftState:
        expected = slot % self.num_nodes
        if view.node_id != expected:
            raise BftWrongLeader(slot, expected)
        if not native.ed25519_verify(self.vks[expected], view.signature, view.signed_bytes):
            raise BftInvalidSignature(slot)
        return BftState(slot)

    def reupdate(self, view, slot, ticked) -> BftState:
        return BftState(slot)

    def check_is_leader(self, node_id: int, slot, ticked):
        return node_id if slot % self.num_nodes == node_id else None

    def select_view(self, header):
        return header.block_no

    def compare_candidates(self, ours, theirs) -> int:
        o = -1 if ours is None else ours
        t = -1 if theirs is None else theirs
        return (t > o) - (t < o)


# ---------------------------------------------------------------------------
# PBFT (Protocol/PBFT.hs): permissive BFT — the issuer must be a delegate
# of a genesis key per the CURRENT ledger view's delegation map
# (PBftLedgerView, PBFT.hs:190), and no genesis key may have signed more
# than floor(threshold·window) of the last `window` signed blocks
# (PBftState tracks (slot, genesis-key) pairs, PBFT/State.hs:82).
# ---------------------------------------------------------------------------


@dataclass
class PBftNotGenesisDelegate(ConsensusError):
    slot: int
    issuer_vk: bytes


@dataclass
class PBftInvalidSignature(ConsensusError):
    slot: int


@dataclass
class PBftInvalidSlot(ConsensusError):
    """Slot before the last signed slot (PBFT.hs PBftInvalidSlot; the
    inequality is non-strict because EBBs share their epoch's first
    slot)."""

    slot: int
    last_signed: int


@dataclass
class PBftExceededSignThreshold(ConsensusError):
    slot: int
    genesis_key: int
    signed: int
    allowed: int


@dataclass(frozen=True)
class PBftParams:
    """PBftParams (Protocol/PBFT.hs:222-240): threshold is the fraction
    of the window one genesis key may sign; window = k signed blocks
    (pbftWindowSize = pbftSecurityParam)."""

    num_genesis_keys: int
    threshold: Fraction
    window: int  # number of recent signed blocks retained (k)
    security_param: int = 2160


@dataclass(frozen=True)
class PBftLedgerView:
    """The delegation map (PBFT.hs:190 PBftLedgerView): issuer vk ->
    genesis key index; the identity view maps each genesis key to itself."""

    delegates: Mapping[bytes, int]

    @classmethod
    def identity(cls, genesis_keys: Sequence[bytes]) -> "PBftLedgerView":
        return cls({vk: i for i, vk in enumerate(genesis_keys)})


def _count(signers) -> dict:
    counts: dict = {}
    for _s, g in signers:
        counts[g] = counts.get(g, 0) + 1
    return counts


@dataclass(frozen=True)
class PBftState:
    """Last `window` signed blocks as (slot, genesis key index), oldest
    first (PBftState, PBFT/State.hs:82). `counts` keeps each genesis key's
    count of `signers` beside the window (the window's append updates it
    in O(1)); it is derived from `signers`, so it takes no part in
    equality, and a state built without it counts by a walk."""

    signers: tuple[tuple[int, int], ...] = ()
    counts: Mapping[int, int] | None = field(default=None, compare=False, repr=False)

    @property
    def last_signed_slot(self) -> int | None:
        return self.signers[-1][0] if self.signers else None

    def count_signed_by(self, gk: int) -> int:
        """countSignedBy (State.hs:178)."""
        if self.counts is None:
            return sum(1 for (_s, g) in self.signers if g == gk)
        return self.counts.get(gk, 0)


@dataclass(frozen=True)
class TickedPBftState:
    """Carries the TICKED ledger view (delegation map) alongside the
    chain-dep state (PBFT.hs TickedPBftState)."""

    state: PBftState
    dlg: Mapping[bytes, int]


@dataclass(frozen=True)
class PBftView:
    """ValidateView: issuer key + signature over the header body."""

    issuer_vk: bytes
    signed_bytes: bytes
    signature: bytes


class _PBftBoundaryView:
    """PBftValidateBoundary (PBFT.hs:312): an EBB carries no signature;
    validation passes it through with NO state change (:326)."""

    def __repr__(self):
        return "PBftValidateBoundary"


PBFT_BOUNDARY_VIEW = _PBftBoundaryView()


class PBftProtocol:
    """ConsensusProtocol (PBft c) (Protocol/PBFT.hs:284)."""

    def __init__(self, params: PBftParams, genesis_keys: Sequence[bytes]):
        if len(genesis_keys) != params.num_genesis_keys:
            raise ValueError("genesis_keys must hold num_genesis_keys keys")
        self.params = params
        self.genesis_keys = list(genesis_keys)
        self._identity_dlg = PBftLedgerView.identity(genesis_keys).delegates
        self.security_param = params.security_param

    @property
    def _threshold_count(self) -> int:
        # pbftWindowParams (PBFT.hs:393-396): floor(ratio * winSize)
        return int(self.params.threshold * self.params.window)

    def initial_state(self) -> PBftState:
        return PBftState()

    def tick(self, ledger_view, slot, state) -> TickedPBftState:
        dlg = (ledger_view.delegates if isinstance(ledger_view, PBftLedgerView)
               else self._identity_dlg)
        return TickedPBftState(state, dlg)

    def _append_signer(self, st: PBftState, slot: int, gk: int) -> PBftState:
        """(signers + (slot, gk))[-window:], its counts updated by the
        append and by what the cut drops."""
        grown = st.signers + ((slot, gk),)
        signers = grown[-self.params.window:]
        counts = dict(st.counts) if st.counts is not None else _count(st.signers)
        counts[gk] = counts.get(gk, 0) + 1
        for _s, g in grown[:len(grown) - len(signers)]:
            counts[g] -= 1
        return PBftState(signers, counts)

    def apply_checked_sig(self, st: PBftState, slot: int, issuer_vk: bytes, sig_ok: bool,
                          dlg: Mapping[bytes, int] | None = None) -> PBftState:
        """The non-crypto PBft rules given a signature verdict, in the
        reference's order (PBFT.hs:320-352): signature, slot
        monotonicity, delegation lookup, then the window threshold on
        the APPENDED state — shared by the sequential `update` and the
        batched Byron path (hardfork/composite.py)."""
        if not sig_ok:
            raise PBftInvalidSignature(slot)
        last = st.last_signed_slot
        if last is not None and slot < last:
            raise PBftInvalidSlot(slot, last)
        dlg = self._identity_dlg if dlg is None else dlg
        gk = dlg.get(issuer_vk)
        if gk is None:
            raise PBftNotGenesisDelegate(slot, issuer_vk)
        new = self._append_signer(st, slot, gk)
        signed = new.count_signed_by(gk)
        if signed > self._threshold_count:
            raise PBftExceededSignThreshold(slot, gk, signed, self._threshold_count)
        return new

    def update(self, view, slot, ticked: TickedPBftState) -> PBftState:
        if view is PBFT_BOUNDARY_VIEW:
            return ticked.state  # EBB: no checks, no state change
        sig_ok = native.ed25519_verify(view.issuer_vk, view.signature, view.signed_bytes)
        return self.apply_checked_sig(ticked.state, slot, view.issuer_vk, sig_ok, ticked.dlg)

    def reupdate(self, view, slot, ticked: TickedPBftState) -> PBftState:
        """reupdateChainDepState (PBFT.hs:356-372): no signature check;
        delegation + window append still run."""
        if view is PBFT_BOUNDARY_VIEW:
            return ticked.state
        gk = ticked.dlg[view.issuer_vk]
        return self._append_signer(ticked.state, slot, gk)

    def check_is_leader(self, node_id: int, slot, ticked):
        """PBFT leadership is round-robin among delegates (Byron)."""
        return node_id if slot % self.params.num_genesis_keys == node_id else None

    def select_view(self, header):
        return header.block_no

    def compare_candidates(self, ours, theirs) -> int:
        o = -1 if ours is None else ours
        t = -1 if theirs is None else theirs
        return (t > o) - (t < o)


# ---------------------------------------------------------------------------
# LeaderSchedule (Protocol/LeaderSchedule.hs): scripted leadership for
# tests — no crypto, the schedule IS the protocol
# ---------------------------------------------------------------------------


@dataclass
class NotScheduledLeader(ConsensusError):
    slot: int
    node_id: int


@dataclass(frozen=True)
class LeaderScheduleState:
    last_slot: int | None = None


@dataclass(frozen=True)
class TickedLeaderScheduleState:
    state: LeaderScheduleState


class LeaderScheduleProtocol:
    """WithLeaderSchedule: slot -> set of leader node ids."""

    def __init__(self, schedule: Mapping[int, Sequence[int]], security_param: int = 2160):
        self.schedule = {s: tuple(ns) for s, ns in schedule.items()}
        self.security_param = security_param

    def initial_state(self) -> LeaderScheduleState:
        return LeaderScheduleState()

    def tick(self, ledger_view, slot, state) -> TickedLeaderScheduleState:
        return TickedLeaderScheduleState(state)

    def update(self, node_id: int, slot, ticked) -> LeaderScheduleState:
        if node_id not in self.schedule.get(slot, ()):
            raise NotScheduledLeader(slot, node_id)
        return LeaderScheduleState(slot)

    def reupdate(self, node_id, slot, ticked) -> LeaderScheduleState:
        return LeaderScheduleState(slot)

    def check_is_leader(self, node_id: int, slot, ticked):
        return node_id if node_id in self.schedule.get(slot, ()) else None

    def select_view(self, header):
        return header.block_no

    def compare_candidates(self, ours, theirs) -> int:
        o = -1 if ours is None else ours
        t = -1 if theirs is None else theirs
        return (t > o) - (t < o)
