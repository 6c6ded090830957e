"""Mock UTxO ledger — the test and benchmark ledger (the port's copy of
the JAX package's ledger/mock.py; txids hash with the port's hashes).

Reference: the `mock-block` library's `SimpleBlock` ledger
(ouroboros-consensus/src/mock-block/.../Mock/Ledger/*): a minimal UTxO
ledger sufficient to drive ThreadNet tests, the mempool, and the
db-synthesizer/db-analyser benchmark pipeline, while keeping tx-level
Shelley fidelity out of the hot path (SURVEY.md §7.2 step 11).

Tx wire format (deterministic CBOR):
    [[ [txid, ix], ... ],  [ [addr, amount], ... ]]
txid = Blake2b-256 of the tx bytes. Genesis UTxO enters as outputs of the
zero txid. The pool stake distribution is either static configuration
(the Praos LedgerView, like the reference's mock ledger fixing stake at
genesis — Mock/Ledger/Stake.hs) or DERIVED from the UTxO with
epoch-boundary snapshots (StakeConfig: the mark/set/go-shaped rule real
eras use; Ledger/SupportsProtocol.hs ledgerViewForecastAt).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from fractions import Fraction
from typing import Mapping

from ..protocol.views import IndividualPoolStake, LedgerView
from ..utils import cbor
from ..utils.hashes import blake2b_256
from .abstract import Forecast, LedgerError


class InvalidTx(LedgerError):
    pass


@dataclass
class MissingInput(InvalidTx):
    txin: tuple[bytes, int]


@dataclass
class ValueNotConserved(InvalidTx):
    consumed: int
    produced: int


def tx_id(tx_bytes: bytes) -> bytes:
    return blake2b_256(tx_bytes)


def decode_tx(tx_bytes: bytes):
    ins, outs = cbor.decode(tx_bytes)
    return (
        [(bytes(i[0]), i[1]) for i in ins],
        [(bytes(o[0]), o[1]) for o in outs],
    )


def encode_tx(ins, outs) -> bytes:
    return cbor.encode([[list(i) for i in ins], [list(o) for o in outs]])


@dataclass(frozen=True)
class StakeConfig:
    """Epoch-varying stake derivation (Ledger/SupportsProtocol.hs
    ledgerViewForecastAt; stake snapshots via the rules reached from
    shelley/.../Shelley/Ledger/Ledger.hs:584):

    pool stake is DERIVED from the UTxO — each address delegates to a
    pool (`delegations`), a pool's stake is the delegated value share —
    and the distribution used for epoch E's leader election is the
    SNAPSHOT taken at the end of epoch E-2 (the "set" snapshot of
    Cardano's mark/set/go rotation: stake decided two boundaries back,
    so forgers and validators agree before the epoch starts)."""

    delegations: Mapping[bytes, bytes]  # addr -> pool_id
    pool_vrf_hashes: Mapping[bytes, bytes]  # pool_id -> Blake2b-256(vrf vk)
    epoch_length: int


@dataclass(frozen=True)
class MockConfig:
    ledger_view: LedgerView  # static pool distribution (mock stake)
    stability_window: int  # forecast horizon (3k/f for Praos)
    check_value_conservation: bool = True
    # None = static stake (ledger_view used for every epoch)
    stake: StakeConfig | None = None


@dataclass(frozen=True)
class MockState:
    """UTxO map + tip slot. Immutable; apply returns a new state.

    `snapshots` (stake config only): most recent end-of-epoch stake
    distributions, newest last, each (lo_label, hi_label, ((pool_id,
    num, den), ...)) — the entry covers every sealed epoch label in
    [lo, hi] (a RANGE because several block-free boundaries can be
    crossed at once, all sharing the tip's distribution); genesis seeds
    (-2, -1, genesis_distr), covering epochs 0 and 1."""

    utxo: Mapping[tuple[bytes, int], tuple[bytes, int]]
    tip_slot_: int | None = None
    snapshots: tuple = ()


@dataclass(frozen=True)
class TickedMockState:
    state: MockState
    slot: int


class MockLedger:
    """Ledger instance (ledger/abstract.py) for the mock UTxO rules."""

    def __init__(self, config: MockConfig):
        self.config = config

    def genesis_state(self, initial_outputs) -> MockState:
        """initial_outputs: list of (addr, amount) spendable as
        (zero-txid, index)."""
        utxo = {
            (bytes(32), ix): (addr, amt)
            for ix, (addr, amt) in enumerate(initial_outputs)
        }
        snaps = ()
        if self.config.stake is not None:
            # labels -2..-1: the genesis distribution is the sealed
            # snapshot for BOTH epoch 0 (wants label -2) and epoch 1
            # (wants -1)
            snaps = ((-2, -1, self._stake_distr(utxo)),)
        return MockState(utxo, snapshots=snaps)

    # -- epoch-varying stake (StakeConfig) --------------------------------

    def _stake_distr(self, utxo) -> tuple:
        """Delegated value share per pool, as ((pool_id, num, den), ...)."""
        cfg = self.config.stake
        per: dict[bytes, int] = {}
        total = 0
        for addr, amt in utxo.values():
            pid = cfg.delegations.get(addr)
            if pid is not None:
                per[pid] = per.get(pid, 0) + amt
                total += amt
        if total == 0:
            return ()
        return tuple(
            (pid, amt, total) for pid, amt in sorted(per.items())
        )

    def _advance_snapshots(self, state: MockState, slot: int) -> MockState:
        """Seal end-of-epoch snapshots for every boundary crossed between
        the state's tip and `slot`. No blocks ran in between, so every
        newly sealed label shares the tip's distribution — recorded as
        ONE range entry [last_sealed+1, e_now-1] (collapsing to a single
        newest label would make a later epoch's lookup skip past the
        range and fall back to a stale older snapshot)."""
        cfg = self.config.stake
        e_now = slot // cfg.epoch_length
        last_sealed = state.snapshots[-1][1] if state.snapshots else -1
        newest_sealed = e_now - 1
        if newest_sealed <= last_sealed:
            return state
        snaps = state.snapshots + (
            (last_sealed + 1, newest_sealed, self._stake_distr(state.utxo)),
        )
        return replace(state, snapshots=snaps[-3:])

    def view_for_epoch(self, state: MockState, epoch: int) -> LedgerView:
        """The LedgerView for `epoch`'s leader election: the snapshot
        range containing label epoch-2 (exact — see _advance_snapshots)."""
        cfg = self.config.stake
        if cfg is None:
            return self.config.ledger_view
        want = epoch - 2
        chosen = None
        for lo, hi, distr in state.snapshots:
            if lo <= want <= hi:
                chosen = distr
                break
        if chosen is None:
            raise ValueError(
                f"no stake snapshot for epoch {epoch} "
                f"(ranges {[(lo, hi) for lo, hi, _ in state.snapshots]})"
            )
        return LedgerView(
            pool_distr={
                pid: IndividualPoolStake(
                    Fraction(num, den), cfg.pool_vrf_hashes[pid]
                )
                for pid, num, den in chosen
            }
        )

    def tick(self, state: MockState, slot: int) -> TickedMockState:
        if self.config.stake is not None:
            state = self._advance_snapshots(state, slot)
        return TickedMockState(state, slot)

    def apply_tx(self, utxo: dict, tx_bytes: bytes) -> dict:
        """Validates FULLY before mutating: on failure `utxo` is
        untouched (atomic-on-failure — the Mempool's fast path applies
        into its cached view without a defensive copy)."""
        try:
            ins, outs = decode_tx(tx_bytes)
            # shape checks inside the guard: structurally-decodable
            # garbage (unhashable inputs, non-int amounts) must also be
            # an INVALID TX, not a crash — peers gossip arbitrary bytes
            if len(set(ins)) != len(ins):
                raise MissingInput(ins[0])  # duplicate input spends
            if not all(isinstance(ix, int) for _t, ix in ins):
                # a float index like 0.0 would FIND the int-keyed
                # outpoint (0.0 == 0 under dict lookup) — reject the
                # malformed encoding instead
                raise InvalidTx("non-integer input index")
            consumed = 0
            for txin in ins:
                if txin not in utxo:
                    raise MissingInput(txin)
                consumed += utxo[txin][1]
            produced = sum(a for _, a in outs)
            if not isinstance(produced, int) or not isinstance(consumed, int):
                raise InvalidTx("non-integer value")
        except InvalidTx:
            raise
        except Exception as e:
            raise InvalidTx(f"malformed tx: {e!r}") from e
        if self.config.check_value_conservation and consumed != produced:
            raise ValueNotConserved(consumed, produced)
        tid = tx_id(tx_bytes)
        for txin in ins:
            del utxo[txin]
        for ix, (addr, amt) in enumerate(outs):
            utxo[(tid, ix)] = (addr, amt)
        return utxo

    def apply_block(self, ticked: TickedMockState, block) -> MockState:
        utxo = dict(ticked.state.utxo)
        for tx in block.txs:
            utxo = self.apply_tx(utxo, tx)
        return MockState(utxo, ticked.slot, ticked.state.snapshots)

    def reapply_block(self, ticked: TickedMockState, block) -> MockState:
        """Previously validated: inputs are known-present; skip checks."""
        utxo = dict(ticked.state.utxo)
        for tx in block.txs:
            ins, outs = decode_tx(tx)
            tid = tx_id(tx)
            for txin in ins:
                utxo.pop(txin, None)
            for ix, (addr, amt) in enumerate(outs):
                utxo[(tid, ix)] = (addr, amt)
        return MockState(utxo, ticked.slot, ticked.state.snapshots)

    def tip_slot(self, state: MockState) -> int | None:
        return state.tip_slot_

    def protocol_ledger_view(self, ticked: TickedMockState) -> LedgerView:
        if self.config.stake is not None:
            epoch = ticked.slot // self.config.stake.epoch_length
            return self.view_for_epoch(ticked.state, epoch)
        return self.config.ledger_view

    def ledger_view_forecast_at(self, state: MockState) -> Forecast:
        at = -1 if state.tip_slot_ is None else state.tip_slot_
        if self.config.stake is not None:
            cfg = self.config.stake

            def view_fn(s):
                # the snapshot for slot s's epoch is already sealed (it
                # was taken >= 1 full epoch before s, and the forecast
                # horizon is the stability window < epoch length)
                st = self._advance_snapshots(state, s)
                return self.view_for_epoch(st, s // cfg.epoch_length)

            return Forecast(
                at=at,
                max_for=at + 1 + self.config.stability_window,
                view_fn=view_fn,
            )
        return Forecast(
            at=at,
            max_for=at + 1 + self.config.stability_window,
            view_fn=lambda s: self.config.ledger_view,
        )

    def tick_then_apply(self, state, block):
        return self.apply_block(self.tick(state, block.slot), block)

    def tick_then_reapply(self, state, block):
        return self.reapply_block(self.tick(state, block.slot), block)
