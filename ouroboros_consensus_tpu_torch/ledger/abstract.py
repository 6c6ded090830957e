"""Ledger abstraction: the tick/apply state machine over ledger states.

Reference: `Ouroboros.Consensus.Ledger.Abstract` (Ledger/Abstract.hs:74,
108) — `applyBlockLedgerResult` (full checks), `reapplyBlockLedgerResult`
(the previously validated fast path) and the composites `tickThenApply` /
`tickThenReapply` (:132, :168); and `LedgerSupportsProtocol`
(Ledger/SupportsProtocol.hs): `protocol_ledger_view` and a bounded-horizon
forecast of ledger views (Forecast.hs).

A Ledger instance is an object that describes one block type's ledger
rules; ledger states are immutable values it produces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Protocol as TyProtocol


class LedgerError(Exception):
    """Block application failure (the ledger's STS rule violations)."""


@dataclass(frozen=True)
class OutsideForecastRange(Exception):
    at: int  # anchor slot of the forecast
    max_for: int  # first slot beyond the horizon
    for_slot: int  # requested slot


@dataclass(frozen=True)
class Forecast:
    """Bounded-horizon projection of ledger views (Forecast.hs:20-40)."""

    at: int  # anchor slot
    max_for: int  # exclusive horizon: views available for slots < max_for
    view_fn: Any  # slot -> LedgerView

    def forecast_for(self, slot: int):
        if slot >= self.max_for:
            raise OutsideForecastRange(self.at, self.max_for, slot)
        return self.view_fn(slot)


class Ledger(TyProtocol):
    """ApplyBlock + LedgerSupportsProtocol, instance-as-object."""

    def tick(self, state, slot: int):
        """applyChainTickLedgerResult: advance time, no block."""
        ...

    def apply_block(self, ticked_state, block):
        """applyBlockLedgerResult: full validation; raises LedgerError."""
        ...

    def reapply_block(self, ticked_state, block):
        """reapplyBlockLedgerResult: previously validated, no checks."""
        ...

    def tip_slot(self, state) -> int | None:
        """GetTip: slot of the most recently applied block (None: genesis)."""
        ...

    def protocol_ledger_view(self, ticked_state):
        """LedgerView at the ticked state's slot."""
        ...

    def ledger_view_forecast_at(self, state) -> Forecast:
        """Forecast of ledger views anchored at the state's tip."""
        ...

    def tick_then_apply(self, state, block):
        """tickThenApply (Ledger/Abstract.hs:132)."""
        return self.apply_block(self.tick(state, block.slot), block)

    def tick_then_reapply(self, state, block):
        """tickThenReapply (Ledger/Abstract.hs:168)."""
        return self.reapply_block(self.tick(state, block.slot), block)
