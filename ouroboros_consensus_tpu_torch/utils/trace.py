"""Tracing: structured events and the tracer combinators.

The JAX package's utils/trace.py is the port's reference (itself after
the reference node's contravariant `Tracer`s, contra-tracer, and the
`Enclose` brackets of Util/Enclose.hs). A Tracer is any
`Callable[[event], None]`; the combinators mirror contramap /
nullTracer / condTracer; `Enclose` is a context manager that emits a
monotonic start and end event. Events are frozen dataclasses with the
reference's names and fields, so a reader of one package finds its
counterpart in the other; rendering them is the caller's job.

Ported: the combinators, the batch path's events (`TransferEvent`,
`WindowStaged`, `WindowSpan`, `AggRedispatch`), the read's and the
store's (`SidecarEvent`, `RepairEvent`), the recovery plane's
(`RecoveryEvent`, `CheckpointEvent`), the live plane's `StallEvent` and
the forge's `ForgeSpan`, the consensus events (`AddedBlock`,
`SwitchedToFork`, `InvalidBlockEvent`), the ChainDB's event algebra and
the LedgerDB's `ValidatedBatch`. The node's (`ForgedBlock`,
`NodeTracers`) come with the node, `ShardSpan` with multi-GPU, and
`LadderEvent` not at all (the port has no warm ladder: it compiles
nothing while it runs)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

Tracer = Callable[[Any], None]


def null_tracer(_event: Any) -> None:
    """nullTracer: drop everything."""


def contramap(f: Callable[[Any], Any], tracer: Tracer) -> Tracer:
    """contramap: adapt the event before forwarding it."""

    def t(ev):
        tracer(f(ev))

    return t


def cond_tracer(pred: Callable[[Any], bool], tracer: Tracer) -> Tracer:
    def t(ev):
        if pred(ev):
            tracer(ev)

    return t


def fanout(*tracers: Tracer) -> Tracer:
    def t(ev):
        for tr in tracers:
            tr(ev)

    return t


class ListTracer:
    """Collect events (the reference's recordingTracerIORef)."""

    def __init__(self):
        self.events: list = []

    def __call__(self, ev):
        self.events.append(ev)


@dataclass(frozen=True)
class EncloseEvent:
    """A start or end bracket (Util/Enclose.hs RisingEdge/FallingEdge);
    the end edge is a new event carrying the duration."""

    label: str
    edge: str  # "start" | "end"
    t: float
    duration: float | None = None  # set on the end edge


class Enclose:
    """Emit start and end events around a block:

        with Enclose(tracer, "stage"):
            ...
    """

    def __init__(self, tracer: Tracer, label: str):
        self.tracer = tracer
        self.label = label
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        self.tracer(EncloseEvent(self.label, "start", self._t0))
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        self.tracer(EncloseEvent(self.label, "end", t1, t1 - self._t0))
        return False


@dataclass(frozen=True)
class TransferEvent:
    """A window's bytes across the card's boundary: the staged columns
    copied up at dispatch, the verdict words, carry or eta copied back
    at materialize."""

    phase: str  # "dispatch" | "materialize"
    lanes: int  # padded window size
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    packed: bool = False  # a packed window (else generically staged)


# -- per-window pipeline spans: a window's events, never a header's ----------


@dataclass(frozen=True)
class WindowStaged:
    """One window dispatched: how it staged and, where the packed
    staging declined, which gate said no."""

    index: int  # process-wide dispatch sequence number
    lanes: int  # the window's headers (before the bucket padding)
    lanes_padded: int
    outcome: str  # "packed-agg" | "packed" | "generic"
    gate: str | None  # the decline reason when outcome == "generic"
    stage_s: float
    dispatch_s: float


@dataclass(frozen=True)
class StallEvent:
    """The live plane's stall watchdog (obs/live.py) tripped: no
    progress for `age_s` seconds against its budget. `phase` is the
    live classification at the trip; `dump_path` names the all-thread
    stack dump written. Evidence, never a kill."""

    phase: str
    age_s: float
    budget_s: float
    dump_path: str | None


@dataclass(frozen=True)
class RecoveryEvent:
    """One transition of the recovery supervisor's ladder
    (obs/recovery.py) for a failing window: a rung tried, "recovered",
    "exhausted", or the reader's "chunk-reread". `fault` is the class
    name of the failure being recovered; `ok` is set on an episode's
    last event."""

    action: str  # "retry" | "stage-split" | "host-reference" | "chunk-reread"
    # | "recovered" | "exhausted"
    window: int  # retire-order window index (or the chunk's place)
    lanes: int
    attempt: int  # 1-based position in the episode's ladder
    fault: str
    detail: str  # repr of the triggering exception, trimmed
    ok: bool | None = None


@dataclass(frozen=True)
class CheckpointEvent:
    """The progress record (obs/recovery.py) moved: a write as a window
    retired, a resume that seeded a replay from it, or the replay's
    completion."""

    kind: str  # "write" | "resume" | "complete"
    headers: int  # retired headers at this point
    windows: int  # retired windows


@dataclass(frozen=True)
class RepairEvent:
    """The store repaired itself (storage/repair.py), or, in a dry run,
    would have: a chunk's tail truncated (the snipped bytes
    quarantined), an index rebuilt, a chunk dropped, an orphan swept, or
    a dirty open's escalation. `applied=False` marks a dry run."""

    action: str  # "truncate-chunk" | "rebuild-index" | "drop-chunk"
    # | "sweep-orphan-index" | "sweep-orphan-sidecar" | "dirty-open-escalated"
    chunk: int  # chunk number (-1 for the store's own actions)
    blocks_kept: int
    blocks_dropped: int
    bytes_quarantined: int
    applied: bool
    detail: str = ""


@dataclass(frozen=True)
class SidecarEvent:
    """One probe or build of a chunk's `.cols` sidecar
    (storage/sidecar.py): hit / miss / stale / torn, or rebuilt. A
    non-hit costs one scan of the chunk, never a verdict."""

    outcome: str  # "hit" | "miss" | "stale" | "rebuilt" | "torn"
    chunk: int = -1


@dataclass(frozen=True)
class AggRedispatch:
    """An aggregated window came back dirty, so `batch.materialize`
    verified it again with the per-lane stage kernels."""

    lanes: int


@dataclass(frozen=True)
class ForgeSpan:
    """One election window of the windowed forge
    (tools/db_synthesizer.py): the pools x slots grid elected, the won
    slots assembled, signed and appended. The loop engine emits none."""

    index: int  # process-wide forge-window sequence number
    engine: str  # "device" | "host"
    slots: int  # the window's slots
    pairs: int  # pools x slots elected
    elected: int  # slots won in the window
    signed: int  # blocks forged and appended (a limit may cut it)
    elect_s: float
    assemble_s: float


@dataclass(frozen=True)
class WindowSpan:
    """One window retired through validate_chain's loop: its phase walls
    and the dispatch -> materialize latency (t_materialized -
    t_dispatch)."""

    index: int
    lanes: int
    outcome: str  # WindowStaged.outcome
    gate: str | None
    stage_s: float
    dispatch_s: float
    materialize_s: float  # the host's wait for the card's result
    epilogue_s: float
    t_dispatch: float  # monotonic at dispatch's end
    t_materialized: float  # monotonic when the result was in
    t_done: float  # monotonic after the epilogue
    n_valid: int
    failed: bool  # the window held the chain's first error


# -- the consensus event vocabulary (Tracers' record, condensed) -------------


@dataclass(frozen=True)
class AddedBlock:
    slot: int
    block_no: int
    hash_: bytes


@dataclass(frozen=True)
class SwitchedToFork:
    n_rollback: int
    new_tip_slot: int


@dataclass(frozen=True)
class InvalidBlockEvent:
    slot: int
    hash_: bytes
    reason: str


# -- the ChainDB event algebra (ChainDB/Impl.hs:10-28) -----------------------
# One dataclass per constructor family: the add-block lifecycle,
# validation verdicts, diffusion pipelining, followers, and the
# copy/snapshot/GC background — typed and matchable so tests assert
# event SEQUENCES, not log strings.


@dataclass(frozen=True)
class IgnoreBlockOlderThanK:
    slot: int
    hash_: bytes


@dataclass(frozen=True)
class IgnoreInvalidBlock:
    slot: int
    hash_: bytes


@dataclass(frozen=True)
class AddedBlockToQueue:
    slot: int
    hash_: bytes
    queue_len: int


@dataclass(frozen=True)
class PoppedBlockFromQueue:
    slot: int
    hash_: bytes


@dataclass(frozen=True)
class AddedBlockToVolatileDB:
    slot: int
    hash_: bytes


@dataclass(frozen=True)
class StoreButDontChange:
    slot: int
    hash_: bytes


@dataclass(frozen=True)
class AddedToCurrentChain:
    n_blocks: int
    new_tip_slot: int


@dataclass(frozen=True)
class SwitchedToAFork:
    n_rollback: int
    n_blocks: int
    new_tip_slot: int


@dataclass(frozen=True)
class ValidCandidate:
    n_blocks: int
    tip_slot: int


@dataclass(frozen=True)
class SetTentativeHeader:
    slot: int
    hash_: bytes


@dataclass(frozen=True)
class TrapTentativeHeader:
    slot: int
    hash_: bytes


@dataclass(frozen=True)
class NewFollowerEvent:
    include_tentative: bool


@dataclass(frozen=True)
class CopiedToImmutableDB:
    n_blocks: int
    up_to_slot: int


@dataclass(frozen=True)
class TookSnapshot:
    n_since_last: int


@dataclass(frozen=True)
class ScheduledGC:
    slot: int


@dataclass(frozen=True)
class PerformedGC:
    slot: int


@dataclass(frozen=True)
class ValidatedBatch:
    """One device batch of the LedgerDB completed (the batched push of
    a run of fresh headers, one epoch segment)."""

    n_headers: int
    n_valid: int
    device_s: float
