"""Hard-fork combinator, its protocol half: compose N eras into one
protocol and one era-tagged block; the port's copy of the reference's
hardfork/combinator.py (:1-160, the block wrapper and `decode_block`).

Reference: `Ouroboros.Consensus.HardFork.Combinator` — `HardForkBlock xs`
(Basics.hs:65), the per-era `Telescope` state (State/Types.hs:38), the
cross-era `ConsensusProtocol` instance (Combinator/Protocol.hs) and the
chain-dep state translations (Translation.hs:20-22). The type-level
n-ary sums become an era index + dispatch tables; an era boundary is
one more batch cut, like an epoch boundary, so a batch never holds two
eras. Era transitions are config-driven (TriggerHardForkAtEpoch, the
Summary's bounds).

The ledger half (`HardForkLedger`, cross-era transactions, queries, the
mempool view) waits for the port's ledger eras.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

from ..utils import cbor
from .history import Summary


def _identity(s):
    return s


@dataclass(frozen=True)
class Era:
    """One era of the composite (SingleEraBlock analog)."""

    name: str
    protocol: Any  # ConsensusProtocol instance-as-object
    ledger: Any = None  # the era's ledger (none ported yet)
    # the chain-dep state translation INTO this era from the previous one
    translate_chain_dep: Callable[[Any], Any] = _identity


@dataclass(frozen=True)
class HFState:
    """The Telescope collapsed to (current era index, its state) — past
    eras' states are dead after translation (State/Types.hs Past)."""

    era: int
    inner: Any


@dataclass(frozen=True)
class TickedHFState:
    era: int
    inner: Any  # the era protocol's ticked state

    @property
    def state(self) -> Any:
        """The un-ticked inner payload."""
        return self.inner.state


class HardForkProtocol:
    """ConsensusProtocol (HardForkBlock xs) (Combinator/Protocol.hs)."""

    def __init__(self, eras: Sequence[Era], summary: Summary):
        if len(eras) != len(summary.eras):
            raise ValueError("one era summary per era")
        self.eras = list(eras)
        self.summary = summary
        self.security_param = max(getattr(e.protocol, "security_param", 0) for e in eras)

    def era_of_slot(self, slot: int) -> int:
        return self.summary.era_index_of_slot(slot)

    @property
    def params(self):
        """Forging-side parameter view: the newest era's params stand for
        the composite (the HFC's forging config shape,
        Combinator/Forging.hs)."""
        return self.eras[-1].protocol.params

    def initial_state(self) -> HFState:
        return HFState(0, self.eras[0].protocol.initial_state())

    def cross_eras(self, state: HFState, target: int) -> HFState:
        """Walk the telescope forward, translating at each boundary
        (Translation.hs translateChainDepState)."""
        era, inner = state.era, state.inner
        while era < target:
            era += 1
            inner = self.eras[era].translate_chain_dep(inner)
        return HFState(era, inner)

    def tick(self, ledger_view, slot: int, state: HFState) -> TickedHFState:
        target = self.era_of_slot(slot)
        if target < state.era:
            raise ValueError(f"slot {slot} is in past era {target} < {state.era}")
        state = self.cross_eras(state, target)
        return TickedHFState(target, self.eras[target].protocol.tick(ledger_view, slot,
                                                                    state.inner))

    def update(self, view, slot: int, ticked: TickedHFState) -> HFState:
        return HFState(ticked.era, self.eras[ticked.era].protocol.update(view, slot,
                                                                         ticked.inner))

    def reupdate(self, view, slot: int, ticked: TickedHFState) -> HFState:
        return HFState(ticked.era, self.eras[ticked.era].protocol.reupdate(view, slot,
                                                                           ticked.inner))

    def check_is_leader(self, can_be_leader, slot: int, ticked: TickedHFState):
        return self.eras[ticked.era].protocol.check_is_leader(can_be_leader, slot,
                                                              ticked.inner)

    # -- chain order across eras (Combinator/Protocol/ChainSel.hs) --------

    def select_view(self, header):
        era = self.era_of_slot(header.slot)
        return (era, self.eras[era].protocol.select_view(header))

    @staticmethod
    def _block_no_of(view):
        """Every inner SelectView exposes a block number: richer views
        (Praos) as .block_no, simple protocols the number itself."""
        return view.block_no if hasattr(view, "block_no") else view

    def compare_candidates(self, ours, theirs) -> int:
        """AcrossEraSelection: same era → era rules; different eras →
        block number only. None = empty chain, loses to any candidate."""
        if theirs is None:
            return 0 if ours is None else -1
        if ours is None:
            return 1
        (ea, va), (eb, vb) = ours, theirs
        if ea == eb:
            return self.eras[ea].protocol.compare_candidates(va, vb)
        a_no, b_no = self._block_no_of(va), self._block_no_of(vb)
        return (b_no > a_no) - (b_no < a_no)

    # -- batched validation (era-segmented) --------------------------------

    def validate_batch(self, ticked: TickedHFState, views, backend: str = "device"):
        """The era's own batched fold over a run of views of that era."""
        res = self.eras[ticked.era].protocol.validate_batch(ticked.inner, views,
                                                            backend=backend)
        return replace(res, state=HFState(ticked.era, res.state))


# -- era-tagged block wrapper (NestedContent / Serialisation analog) ---------


@dataclass(frozen=True)
class HardForkBlock:
    """A block tagged with its era (HardForkBlock's one-constructor-per-
    era sum collapsed to an index + payload)."""

    era: int
    block: Any

    @property
    def slot(self) -> int:
        return self.block.slot

    @property
    def block_no(self) -> int:
        return self.block.block_no

    @property
    def hash_(self) -> bytes:
        return self.block.hash_

    @property
    def prev_hash(self):
        return self.block.header.prev_hash

    @property
    def header(self):
        return self.block.header

    @property
    def txs(self):
        return self.block.txs

    @property
    def point(self):
        return self.block.header.point

    @property
    def bytes_(self) -> bytes:
        # era tag + inner bytes (Combinator/Serialisation era tags)
        return cbor.encode([self.era, self.block.bytes_])

    def check_integrity(self) -> bool:
        return self.block.check_integrity()


def unwrap(block):
    return block.block if isinstance(block, HardForkBlock) else block


def decode_block(data: bytes, era_decoders: Sequence[Callable[[bytes], Any]]) -> HardForkBlock:
    era, inner = cbor.decode(data)
    return HardForkBlock(era, era_decoders[era](inner))
