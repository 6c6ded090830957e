"""Extended ledger state: ledger state ⊗ header state — the unit of
validation, the LedgerDB checkpoint and the snapshot payload.

Reference: `Ouroboros.Consensus.Ledger.Extended` (Ledger/Extended.hs:53)
`ExtLedgerState {ledgerState, headerState}`; its ApplyBlock instance
(:123-159): tick = ledger tick + protocolLedgerView + tickHeaderState;
apply = ledger apply, then validateHeader; reapply skips every check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import header_validation as hv
from .abstract import Forecast, Ledger


@dataclass(frozen=True)
class ExtLedgerState:
    ledger_state: Any
    header_state: hv.HeaderState


@dataclass(frozen=True)
class TickedExtLedgerState:
    ticked_ledger_state: Any
    ledger_view: Any
    ticked_header_state: hv.TickedHeaderState


class ExtLedger:
    """ApplyBlock (ExtLedgerState blk): a Ledger paired with a protocol,
    with the Ledger interface itself, so that the LedgerDB and chain
    selection work over extended states."""

    def __init__(self, ledger: Ledger, protocol):
        self.ledger = ledger
        self.protocol = protocol

    def genesis(self, genesis_ledger_state) -> ExtLedgerState:
        return ExtLedgerState(genesis_ledger_state,
                              hv.HeaderState(None, self.protocol.initial_state()))

    def tick(self, state: ExtLedgerState, slot: int) -> TickedExtLedgerState:
        """Extended.hs:123-140: ledger tick, ledger view, header tick."""
        lt = self.ledger.tick(state.ledger_state, slot)
        view = self.ledger.protocol_ledger_view(lt)
        ht = hv.tick_header_state(self.protocol, view, slot, state.header_state)
        return TickedExtLedgerState(lt, view, ht)

    def apply_block(self, ticked: TickedExtLedgerState, block) -> ExtLedgerState:
        """Extended.hs:142-156: ledger apply, then validateHeader."""
        ls = self.ledger.apply_block(ticked.ticked_ledger_state, block)
        hs = hv.validate_header(self.protocol, ticked.ticked_header_state, block.header)
        return ExtLedgerState(ls, hs)

    def reapply_block(self, ticked: TickedExtLedgerState, block) -> ExtLedgerState:
        """Extended.hs:159: no checks anywhere."""
        ls = self.ledger.reapply_block(ticked.ticked_ledger_state, block)
        hs = hv.revalidate_header(self.protocol, ticked.ticked_header_state, block.header)
        return ExtLedgerState(ls, hs)

    def tip_slot(self, state: ExtLedgerState) -> int | None:
        return self.ledger.tip_slot(state.ledger_state)

    def tip_point(self, state: ExtLedgerState):
        t = state.header_state.tip
        return None if t is None else t.point

    def ledger_view_forecast_at(self, state: ExtLedgerState) -> Forecast:
        return self.ledger.ledger_view_forecast_at(state.ledger_state)

    def tick_then_apply(self, state, block):
        return self.apply_block(self.tick(state, block.slot), block)

    def tick_then_reapply(self, state, block):
        return self.reapply_block(self.tick(state, block.slot), block)
