"""The ConsensusProtocol interface — an open universe of protocols.

Reference: `Ouroboros.Consensus.Protocol.Abstract` (Protocol/Abstract.hs:50):
a consensus protocol is a header-level state machine with five associated
types (ChainDepState, LedgerView, SelectView, ValidateView, IsLeader) and
the transitions tick / update / reupdate, plus chain-order comparison.

Haskell's type classes become a plain Python class hierarchy: a protocol
instance is an OBJECT (carrying its params) and the associated types are
whatever the instance produces — duck typing replaces type families. The
port's copy of the reference's protocol/abstract.py. Protocols that batch
expose `validate_batch`, which runs their crypto as one batch of kernel
lanes (protocol/batch.py, protocol/instances.py, protocol/tpraos.py).
"""

from __future__ import annotations

from typing import Any, Protocol as TyProtocol, Sequence, TypeVar

S = TypeVar("S")  # ChainDepState
V = TypeVar("V")  # ValidateView


class ConsensusError(Exception):
    """Base class of protocol validation errors (ValidationErr family)."""


class ConsensusProtocol(TyProtocol):
    """Protocol/Abstract.hs:50 — the five operations every protocol has.

    * `select_view(header)`  — projection chain ordering uses (:178)
    * `tick(ledger_view, slot, state)` — advance to a slot, no header (:139)
    * `update(view, slot, ticked)` — full validation + new state (:146)
    * `reupdate(view, slot, ticked)` — bookkeeping only, no crypto (:164)
    * `check_is_leader(credentials, slot, ticked)` (:126)
    """

    security_param: int  # k

    def tick(self, ledger_view, slot: int, state): ...

    def update(self, view, slot: int, ticked): ...

    def reupdate(self, view, slot: int, ticked): ...

    def check_is_leader(self, can_be_leader, slot: int, ticked): ...

    def select_view(self, header) -> Any: ...

    def compare_candidates(self, ours, theirs) -> int:
        """preferCandidate (:178): > 0 if theirs is strictly better."""
        ...


class BatchingProtocol(ConsensusProtocol, TyProtocol):
    """Protocols whose `update` crypto runs as fused device batches."""

    def validate_batch(self, ticked, views: Sequence[Any]):
        """Fold `update` over `views` with batched crypto; returns a
        BatchResult (state, n_valid, first error) — protocol/batch.py."""
        ...
