"""HeaderStateHistory: k-deep anchored history of header states.

Reference: `Ouroboros.Consensus.HeaderStateHistory` — an AnchoredSeq of
header states over the recent chain, with `current`, `append`, `rewind`,
`trim` and `fromChain` (HeaderStateHistory.hs:62-146). The reference uses
it in two places:

* the ChainSync client's `theirHeaderStateHistory` (Client.hs:291): the
  per-peer candidate keeps the state after every header so a
  roll_backward is an O(1) truncation (the JAX package's
  miniprotocol/chainsync.py; the port's ChainSync is still to come);
* header-state-at-a-recent-point queries on OUR chain (seeding a peer
  candidate at the intersection) without touching the LedgerDB's full
  ExtLedgerStates (`storage/chaindb.py` maintains one per ChainDB and
  answers `header_state_at` from it).

The structure is two parallel lists with the invariant
``len(states) == len(headers) + 1``: ``states[0]`` is the state at the
anchor (the intersection / the immutable tip), ``states[i+1]`` the state
after validating ``headers[i]``. Entries only need a ``.point``
attribute — block Headers and AnnTips both qualify. States are opaque:
the ChainSync client stores raw protocol chain-dep states, the ChainDB
stores full HeaderStates (tip + chain-dep state).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..block.abstract import Point


@dataclass
class HeaderStateHistory:
    """Anchored header-state sequence with O(1) rollback and k-trimming.

    Invariant: len(states) == len(headers) + 1 — states[0] is the state
    at the anchor, states[i+1] the state after headers[i].
    """

    headers: list = field(default_factory=list)
    states: list = field(default_factory=list)
    # trim bound (HeaderStateHistory.hs `trim` trims to the security
    # parameter k): a long history holds O(k) state; rolling back deeper
    # than k fails. None = unbounded (test-only).
    k: int | None = None
    trimmed: bool = False  # anchor advanced past the original base
    # optional `settled(point) -> bool` gate: only entries the callback
    # approves may be trimmed (the ChainSync client sets this to "is the
    # block already adopted on OUR chain" — dropping a not-yet-fetched
    # header would orphan BlockFetch's anchor). None = always trimmable.
    settled: Any = None

    def __len__(self) -> int:
        return len(self.headers)

    def current(self):
        """Newest state (HeaderStateHistory.hs `current`)."""
        return self.states[-1]

    def tip_point(self) -> Point | None:
        return self.headers[-1].point if self.headers else None

    def reset(self, base_state) -> None:
        """Re-anchor at `base_state` with an empty suffix."""
        self.headers = []
        self.states = [base_state]
        self.trimmed = False

    def extend(self, entry, state) -> None:
        """`append` + trim-to-k (HeaderStateHistory.hs:99)."""
        self.headers.append(entry)
        self.states.append(state)
        self.trim()

    def trim(self) -> None:
        """Advance the anchor while the history exceeds k and its oldest
        entry is settled (HeaderStateHistory.hs `trim`). Called on
        extension AND by owners whose settling is asynchronous (the
        ChainSync client re-trims after BlockFetch adopts blocks)."""
        while self.k is not None and len(self.headers) > self.k:
            if self.settled is not None and not self.settled(
                self.headers[0].point
            ):
                break
            del self.headers[0]
            del self.states[0]
            self.trimmed = True

    def truncate_to(self, point: Point | None) -> bool:
        """`rewind` (HeaderStateHistory.hs:117): roll the suffix back to
        `point` (None = back to the anchor). False if the point is no
        longer in the history — including an anchor rollback after
        trimming (deeper than k)."""
        if point is None:
            if self.trimmed:
                return False
            del self.headers[:]
            del self.states[1:]
            return True
        for i in range(len(self.headers) - 1, -1, -1):
            if self.headers[i].point == point:
                del self.headers[i + 1 :]
                del self.states[i + 2 :]
                return True
        return False

    def rollback_n(self, n: int) -> bool:
        """Drop the newest n entries; False if n exceeds the history."""
        if n > len(self.headers):
            return False
        if n:
            del self.headers[-n:]
            del self.states[-n:]
        return True

    def state_at(self, point: Point):
        """Non-destructive lookup: the state AFTER the entry at `point`
        (newest-first scan — intersections cluster near the tip), or
        None if the point is not in the history."""
        for i in range(len(self.headers) - 1, -1, -1):
            if self.headers[i].point == point:
                return self.states[i + 1]
        return None

    @classmethod
    def from_chain(
        cls, protocol, view_for_slot, base_state, headers, k: int | None = None
    ) -> "HeaderStateHistory":
        """Recompute a history by folding `headers` from `base_state`
        (HeaderStateHistory.hs `fromChain` — used by tests and by
        clients re-seeding after a deep intersection change).
        `view_for_slot(slot)` supplies the ledger view forecast."""
        hh = cls(k=k)
        hh.reset(base_state)
        for h in headers:
            ticked = protocol.tick(view_for_slot(h.slot), h.slot, hh.current())
            hh.extend(h, protocol.update(h.to_view(), h.slot, ticked))
        return hh
