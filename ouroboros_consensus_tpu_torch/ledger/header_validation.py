"""Header validation: the envelope checks and the protocol state update.

Reference: `Ouroboros.Consensus.HeaderValidation` — `HeaderState`
(HeaderValidation.hs:151) pairs the protocol's ChainDepState with the tip
(`AnnTip`); `tickHeaderState` (:186); `validateHeader` (:413-432) runs the
protocol-independent envelope checks (`BasicEnvelopeValidation` :251:
block number and slot monotone, prev-hash linked) and then the protocol's
`update`; `revalidateHeader` (:441) is the `reupdate` fast path for
previously validated headers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..block.abstract import Point


class HeaderEnvelopeError(Exception):
    pass


@dataclass
class UnexpectedBlockNo(HeaderEnvelopeError):
    expected: int
    actual: int


@dataclass
class UnexpectedSlotNo(HeaderEnvelopeError):
    expected_at_least: int
    actual: int


@dataclass
class UnexpectedPrevHash(HeaderEnvelopeError):
    expected: bytes | None
    actual: bytes | None


@dataclass(frozen=True)
class AnnTip:
    """Annotated tip (HeaderValidation.hs:96): slot, block no, hash."""

    slot: int
    block_no: int
    hash_: bytes

    @property
    def point(self) -> Point:
        return Point(self.slot, self.hash_)


@dataclass(frozen=True)
class HeaderState:
    """HeaderValidation.hs:151 — tip + protocol chain-dep state."""

    tip: AnnTip | None  # None = genesis
    chain_dep_state: Any


@dataclass(frozen=True)
class TickedHeaderState:
    tip: AnnTip | None
    ticked_chain_dep_state: Any


def tick_header_state(protocol, ledger_view, slot: int, hs: HeaderState) -> TickedHeaderState:
    """tickHeaderState (HeaderValidation.hs:186)."""
    return TickedHeaderState(hs.tip, protocol.tick(ledger_view, slot, hs.chain_dep_state))


def validate_envelope(tip: AnnTip | None, header) -> None:
    """BasicEnvelopeValidation (HeaderValidation.hs:251): the first block
    has block no 0, a successor increments the block no, advances the slot
    and links its prev-hash to the tip's hash."""
    if tip is None:
        expected_bno, min_slot, expected_prev = 0, 0, None
    else:
        expected_bno, min_slot, expected_prev = tip.block_no + 1, tip.slot + 1, tip.hash_
    if header.block_no != expected_bno:
        raise UnexpectedBlockNo(expected_bno, header.block_no)
    if header.slot < min_slot:
        raise UnexpectedSlotNo(min_slot, header.slot)
    if header.prev_hash != expected_prev:
        raise UnexpectedPrevHash(expected_prev, header.prev_hash)


def validate_header(protocol, ticked: TickedHeaderState, header) -> HeaderState:
    """validateHeader (HeaderValidation.hs:413-432): the envelope, then the
    protocol's `update` (the crypto); the new HeaderState."""
    validate_envelope(ticked.tip, header)
    st = protocol.update(header.to_view(), header.slot, ticked.ticked_chain_dep_state)
    return HeaderState(AnnTip(header.slot, header.block_no, header.hash_), st)


def revalidate_header(protocol, ticked: TickedHeaderState, header) -> HeaderState:
    """revalidateHeader (HeaderValidation.hs:441): the envelope as an
    assertion and `reupdate` (no crypto): the replay and reapply path."""
    validate_envelope(ticked.tip, header)
    st = protocol.reupdate(header.to_view(), header.slot, ticked.ticked_chain_dep_state)
    return HeaderState(AnnTip(header.slot, header.block_no, header.hash_), st)
