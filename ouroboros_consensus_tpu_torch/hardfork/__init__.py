"""Hard-fork combinator: era composition, era-aware time conversions and
the mixed-era composite (reference: Ouroboros.Consensus.HardFork)."""

from .combinator import Era, HardForkBlock, HardForkProtocol, HFState, TickedHFState, decode_block
from .history import Bound, EraParams, EraSummary, PastHorizon, Summary, summarize

__all__ = [
    "Era", "HardForkBlock", "HardForkProtocol", "HFState", "TickedHFState",
    "decode_block", "Bound", "EraParams", "EraSummary", "PastHorizon", "Summary",
    "summarize",
]
