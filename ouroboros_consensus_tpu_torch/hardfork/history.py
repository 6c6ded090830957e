"""Hard-fork history: era-aware slot/epoch/wallclock conversions.

Reference: `Ouroboros.Consensus.HardFork.History` — `EraParams` + safe
zones (EraParams.hs:131), `Summary`/`EraEnd` (Summary.hs:178), and the
query DSL with `wallclockToSlot`/`slotToWallclock` (Qry.hs:463,478).

The port's copy of the reference's hardfork/history.py. It keeps the
reference's semantics but drops the typed query DSL:
a `Summary` is a list of era summaries with closed-form per-era affine
conversions; every query is a lookup of the containing era followed by
arithmetic. Queries beyond the summary's horizon raise `PastHorizon`
(the forecast-safety property the reference enforces through the
`Qry` interpreter)."""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction


class PastHorizon(Exception):
    """Query outside the summary's certain range (Qry.hs PastHorizon)."""


@dataclass(frozen=True)
class EraParams:
    """EraParams.hs:131 — static per-era conversion constants."""

    epoch_size: int  # slots per epoch
    slot_length: Fraction  # seconds per slot
    safe_zone: int = 0  # slots after the tip within which no era change


@dataclass(frozen=True)
class Bound:
    """A point where an era begins/ends — all three coordinates
    (Summary.hs Bound)."""

    time: Fraction  # seconds since system start
    slot: int
    epoch: int


@dataclass(frozen=True)
class EraSummary:
    """One era's extent: [start, end) with its params (Summary.hs:151)."""

    start: Bound
    end: Bound | None  # None = unbounded (the final/current era)
    params: EraParams

    def contains_slot(self, slot: int) -> bool:
        if slot < self.start.slot:
            return False
        return self.end is None or slot < self.end.slot

    def contains_time(self, t: Fraction) -> bool:
        if t < self.start.time:
            return False
        return self.end is None or t < self.end.time

    def contains_epoch(self, e: int) -> bool:
        if e < self.start.epoch:
            return False
        return self.end is None or e < self.end.epoch


def mk_bound_from_start(start: Bound, params: EraParams, n_epochs: int) -> Bound:
    """End bound of an era running `n_epochs` epochs from `start`."""
    slots = n_epochs * params.epoch_size
    return Bound(
        time=start.time + slots * params.slot_length,
        slot=start.slot + slots,
        epoch=start.epoch + n_epochs,
    )


@dataclass(frozen=True)
class Summary:
    """The known era structure (Summary.hs:178). Invariants: contiguous
    bounds; only the last era may be open-ended."""

    eras: tuple[EraSummary, ...]

    def __post_init__(self):
        prev_end = None
        for i, e in enumerate(self.eras):
            if prev_end is not None and e.start != prev_end:
                raise ValueError("summary gap")
            if e.end is None and i != len(self.eras) - 1:
                raise ValueError("only the last era may be open-ended")
            prev_end = e.end

    # -- era lookups -------------------------------------------------------

    def era_of_slot(self, slot: int) -> EraSummary:
        for e in self.eras:
            if e.contains_slot(slot):
                return e
        raise PastHorizon(f"slot {slot}")

    def era_index_of_slot(self, slot: int) -> int:
        for i, e in enumerate(self.eras):
            if e.contains_slot(slot):
                return i
        raise PastHorizon(f"slot {slot}")

    def era_of_epoch(self, epoch: int) -> EraSummary:
        for e in self.eras:
            if e.contains_epoch(epoch):
                return e
        raise PastHorizon(f"epoch {epoch}")

    # -- conversions (Qry.hs:463,478) --------------------------------------

    def wallclock_to_slot(self, t: Fraction) -> tuple[int, Fraction]:
        """(slot containing t, time spent in it)."""
        for e in self.eras:
            if e.contains_time(t):
                dt = t - e.start.time
                n = int(dt / e.params.slot_length)
                spent = dt - n * e.params.slot_length
                return e.start.slot + n, spent
        raise PastHorizon(f"time {t}")

    def slot_to_wallclock(self, slot: int) -> tuple[Fraction, Fraction]:
        """(start time of slot, its length)."""
        e = self.era_of_slot(slot)
        return (
            e.start.time + (slot - e.start.slot) * e.params.slot_length,
            e.params.slot_length,
        )

    def slot_to_epoch(self, slot: int) -> tuple[int, int]:
        """(epoch containing slot, slot's index within it)."""
        e = self.era_of_slot(slot)
        rel = slot - e.start.slot
        return e.start.epoch + rel // e.params.epoch_size, rel % e.params.epoch_size

    def epoch_to_first_slot(self, epoch: int) -> int:
        e = self.era_of_epoch(epoch)
        return e.start.slot + (epoch - e.start.epoch) * e.params.epoch_size

    def epoch_size(self, epoch: int) -> int:
        return self.era_of_epoch(epoch).params.epoch_size


def summarize(
    system_start: Fraction,
    era_params: list[EraParams],
    transition_epochs: list[int | None],
) -> Summary:
    """Build a Summary from per-era params and the epoch at which each
    era ENDS (None for the final, open era) — the shape protocolInfo
    computes from genesis + TriggerHardForkAtEpoch configs."""
    if len(era_params) != len(transition_epochs):
        raise ValueError("one transition epoch per era")
    eras: list[EraSummary] = []
    start = Bound(Fraction(system_start), 0, 0)
    for params, end_epoch in zip(era_params, transition_epochs):
        if end_epoch is None:
            eras.append(EraSummary(start, None, params))
            break
        n = end_epoch - start.epoch
        if n < 0:
            raise ValueError("era ends before it starts")
        end = mk_bound_from_start(start, params, n)
        eras.append(EraSummary(start, end, params))
        start = end
    return Summary(tuple(eras))
