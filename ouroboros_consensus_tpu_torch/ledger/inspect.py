"""InspectLedger: surface ledger-internal events to the node.

Reference: `Ouroboros.Consensus.Ledger.Inspect` — `inspectLedger cfg old
new :: [LedgerEvent]`, called after every ledger transition; events are
warnings (unexpected protocol-version signals) or updates (upcoming
changes). The flagship instance is the HFC's
(`HardFork/Combinator/Ledger.hs` inspectHardForkLedger): it reports when
the next era's transition becomes known and when an era boundary is
crossed — cardano-node renders these as the famous "entering era" logs.

Ledgers opt in by defining `inspect(old_state, new_state) -> [event]`;
`inspect_ledger` is the total wrapper. ChainDB traces the events on
every adoption (ChainSel's ledger trace).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LedgerEvent:
    pass


@dataclass(frozen=True)
class LedgerWarning(LedgerEvent):
    message: str


@dataclass(frozen=True)
class LedgerUpdate(LedgerEvent):
    message: str


@dataclass(frozen=True)
class HardForkEraTransition(LedgerUpdate):
    """Crossed an era boundary (inspectHardForkLedger's TransitionKnown
    → era-crossing report)."""

    from_era: str = ""
    to_era: str = ""


def inspect_ledger(ledger, old_state, new_state) -> list[LedgerEvent]:
    """Total wrapper: ledgers without an `inspect` method emit nothing
    (the default InspectLedger instance)."""
    fn = getattr(ledger, "inspect", None)
    if fn is None:
        return []
    return fn(old_state, new_state)


@dataclass(frozen=True)
class ShelleyUpdatedProposals(LedgerUpdate):
    """Protocol-parameter update proposals changed (the Shelley
    InspectLedger instance's ShelleyUpdatedProtocolUpdates)."""

    proposals: tuple = ()


@dataclass(frozen=True)
class ShelleyPParamsAdopted(LedgerUpdate):
    """An epoch boundary adopted new protocol parameters (PPUP NEWPP)."""

    changed: tuple = ()  # (field, old, new) triples


@dataclass(frozen=True)
class ByronDelegationChanged(LedgerUpdate):
    """A Byron delegation certificate moved signing rights (the PBFT
    ledger view changed) — operators watch this: the wrong forging key
    after a re-delegation produces only rejected blocks."""

    changes: tuple = ()  # (genesis_key, old_delegate, new_delegate) hex
