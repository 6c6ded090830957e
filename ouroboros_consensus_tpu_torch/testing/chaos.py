"""Deterministic fault injection: each way a replay or a store writer can
die, as a seeded event that a test (or chip_smoke.py) places exactly.

The JAX package's testing/chaos.py is the port's reference: the same
spec grammar, the same per-seam counters and the same seeded jitter.
Where the reference reads a plan from its environment, the port takes it
as a keyword: `revalidate(chaos=...)` and `synthesize(chaos=...)` arm a
plan for the call, and `arming(spec)` arms one around any block.

A spec is a comma-separated list of injections,
``<fault>@<trigger>:<arg>``:

    device-error@dispatch:2       raise DeviceChaosError at the 3rd
                                  window dispatch (batch.dispatch_prepared)
    device-error@stage:finish     ...at the launch of each stage kernel
                                  whose name holds 'finish' (the stage
                                  wrappers of ops/pk/kernels.py)
    staging-thread-death@window:3 raise inside prepare_window for the
                                  4th staged window (the staging thread)
    compile-stall@window:3        sleep `stall_s` at the 4th dispatch: a
                                  plain stall (the port compiles nothing
                                  during a replay)
    sigkill@window:7              SIGKILL self when the 8th window
                                  retires, after its checkpoint landed
    chunk-corrupt@epoch:1         raise ChunkChaosError on the 2nd chunk
                                  read (the chunk index stands for the
                                  epoch: the synthesized chains hold one
                                  chunk an epoch)

Store-writer faults, at `ImmutableDB.append_block` (`write_fault`) and
at the clean-marker write (`storage/guard.write_clean_marker`):

    torn-write@append:4           the 5th append lands half a block in
                                  the chunk, no index entry, and raises
    bitflip@chunk:2               one byte of a block appended into
                                  chunk 2 flips on disk; the index keeps
                                  the true CRC
    index-truncate@epoch:1        chunk 1's index is torn mid-entry
                                  after an append, and the writer raises
    sigkill@append:3              SIGKILL between the 4th append's
                                  chunk write and its index write
    partial-rename@marker         the marker write dies between its tmp
                                  file and the rename

Sidecar faults (storage/sidecar.py), which may never change a verdict:

    sidecar-torn@build:2          the 3rd sidecar build lands a torn
                                  prefix at the final name
    sidecar-stale@open:0          the 1st freshness probe says stale
    sigkill@build:1               SIGKILL between the 2nd build's tmp
                                  write and its rename

Serving-plane faults, at the scheduler's seams (node/serve.py):

    device-error@serve-dispatch:2 raise DeviceChaosError at the 3rd
                                  shared window's dispatch, before its
                                  staging; each tenant segment of it
                                  sheds down the recovery ladder
    sigkill@serve:10              SIGKILL self right after the 11th
                                  serving window's checkpoint landed

Each injection fires once (``xN`` after the arg: N times), so a retried
operation succeeds: the faults are transient by construction. The
reference's ``aot-reject`` and ``probe-timeout`` have no seam in the
port (no AOT store, no device probe), nor has ``device-error@shard``
(one card); a spec that names them is refused.

Disarmed, every seam is one module-bool test.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager

FAULT_KINDS = (
    "compile-stall",
    "device-error",
    "staging-thread-death",
    "sigkill",
    "chunk-corrupt",
    "torn-write",
    "bitflip",
    "index-truncate",
    "partial-rename",
    "sidecar-torn",
    "sidecar-stale",
)

# the seams each fault kind is checked at
_KIND_SITES = {
    "compile-stall": ("dispatch", "stage-call"),
    "device-error": ("dispatch", "stage-call", "serve-dispatch"),
    "staging-thread-death": ("stage",),
    "sigkill": ("retire", "append", "sidecar-build", "serve"),
    "chunk-corrupt": ("chunk",),
    "torn-write": ("append",),
    "bitflip": ("append",),
    "index-truncate": ("append",),
    "partial-rename": ("marker",),
    "sidecar-torn": ("sidecar-build",),
    "sidecar-stale": ("sidecar-open",),
}

# the trigger keys each seam provides: parse_spec refuses a trigger that
# no seam of the fault's kind can satisfy (it would arm and never fire)
_SITE_TRIGGER_KEYS = {
    "dispatch": ("window", "dispatch"),
    "stage-call": ("stage",),
    "stage": ("window",),
    "retire": ("window",),
    "chunk": ("chunk",),
    "append": ("append", "chunk"),
    "marker": ("marker",),
    "sidecar-build": ("build", "chunk"),
    "sidecar-open": ("open", "chunk"),
    "serve": ("serve",),
    "serve-dispatch": ("serve-dispatch",),
}

# the trigger keys a seam's own sequence counter answers for
_SITE_SEQ_KEYS = {
    "dispatch": ("window", "dispatch"),
    "stage": ("window",),
    "retire": ("window",),
    "chunk": ("chunk",),
    "append": ("append",),
    "sidecar-build": ("build",),
    "sidecar-open": ("open",),
    "serve": ("serve",),  # one serving window's checkpoint a seq
    "serve-dispatch": ("serve-dispatch",),  # one shared window a seq
}


class ChaosError(RuntimeError):
    """Base of the injected faults. Transient by contract: the injection
    that raised it is spent, so a retry succeeds."""


class DeviceChaosError(ChaosError):
    """Stands in for a device runtime error."""


class StagingChaosError(ChaosError):
    """The staging thread died mid-prepare."""


class ChunkChaosError(ChaosError):
    """A chunk read came back corrupted (transient I/O)."""


class TornWriteChaos(ChaosError):
    """A block append crashed mid-write: a torn prefix is on disk."""


class IndexTornChaos(ChaosError):
    """The index was torn mid-entry after an append."""


class PartialRenameChaos(ChaosError):
    """A marker write died between the tmp write and the rename."""


# the wildcard arg of partial-rename@marker: any marker
ANY = object()


class _Injection:
    __slots__ = ("kind", "trigger", "arg", "count", "fired")

    def __init__(self, kind: str, trigger: str | None, arg, count: int):
        self.kind = kind
        self.trigger = trigger  # the ctx key the seam matches on, or None
        self.arg = arg  # int sequence / str substring / ANY / None
        self.count = count  # firings left
        self.fired = 0

    def matches(self, ctx: dict) -> bool:
        if self.count <= 0:
            return False
        if self.trigger is None:
            return True
        if self.trigger not in ctx:
            return False
        if self.arg is ANY:
            return True
        v = ctx[self.trigger]
        if isinstance(self.arg, str):
            return self.arg in str(v)
        return v == self.arg

    def spend(self) -> None:
        self.count -= 1
        self.fired += 1

    def describe(self) -> str:
        if self.trigger is None:
            return self.kind
        if self.arg is ANY:
            return f"{self.kind}@{self.trigger}"
        return f"{self.kind}@{self.trigger}:{self.arg}"


class ChaosPlan:
    """A parsed spec, its seed and stall, and the per-seam counters."""

    def __init__(self, injections: list, seed: int = 0, stall_s: float = 0.2):
        self.injections = injections
        self.seed = seed
        self.stall_s = stall_s
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._by_site: dict[str, list] = {}
        for inj in injections:
            for site in _KIND_SITES[inj.kind]:
                self._by_site.setdefault(site, []).append(inj)

    def next_seq(self, site: str) -> int:
        with self._lock:
            n = self._counters.get(site, 0)
            self._counters[site] = n + 1
            return n

    def for_site(self, site: str):
        return self._by_site.get(site, ())

    def fired(self) -> list[str]:
        return [i.describe() for i in self.injections if i.fired]


def parse_spec(spec: str) -> list:
    """The grammar above -> injections; a malformed spec raises
    ValueError (a typo that never fires would fake a green matrix)."""
    out: list = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, tail = part.partition("@")
        kind = kind.strip()
        if kind not in _KIND_SITES:
            raise ValueError(f"chaos: unknown fault kind {kind!r} "
                             f"(know {', '.join(FAULT_KINDS)})")
        if not tail:
            raise ValueError(f"chaos: fault {kind!r} needs a @trigger:arg clause")
        count = 1
        trigger, _, argtxt = tail.partition(":")
        trigger = trigger.strip()
        argtxt = argtxt.strip()
        if "x" in argtxt and argtxt.rsplit("x", 1)[1].isdigit():
            argtxt, _, n = argtxt.rpartition("x")
            count = int(n)
        if not argtxt and kind == "partial-rename" and trigger == "marker":
            arg = ANY  # the documented no-arg form: any marker write
        elif not trigger or not argtxt:
            raise ValueError(f"chaos: {part!r} has an empty trigger or arg "
                             "(want <fault>@<trigger>:<arg>)")
        else:
            arg = int(argtxt) if argtxt.lstrip("-").isdigit() else argtxt
        if trigger == "epoch":  # the chunk index stands for the epoch
            trigger = "chunk"
        satisfiable = {k for site in _KIND_SITES[kind]
                       for k in _SITE_TRIGGER_KEYS.get(site, ())}
        if trigger not in satisfiable:
            raise ValueError(
                f"chaos: {part!r} can never fire: trigger {trigger!r} is not "
                f"provided at any {kind!r} seam (know: {', '.join(sorted(satisfiable))})")
        out.append(_Injection(kind, trigger, arg, count))
    return out


_ARMED = False
_PLAN: ChaosPlan | None = None
_RNG = random.Random(0)


@contextmanager
def arming(spec, seed: int = 0, stall_s: float = 0.2):
    """Arm `spec` (a spec string, or a ChaosPlan as it is) for the block,
    its seed seeding the jitter RNG; None or "" arms nothing. Restores
    what was armed before. Yields the plan (or None)."""
    global _ARMED, _PLAN, _RNG
    if not spec:
        yield None
        return
    saved = (_ARMED, _PLAN, _RNG)
    plan_ = spec if isinstance(spec, ChaosPlan) else ChaosPlan(parse_spec(spec), seed, stall_s)
    _PLAN, _ARMED, _RNG = plan_, True, random.Random(plan_.seed)
    try:
        yield plan_
    finally:
        _ARMED, _PLAN, _RNG = saved


def armed() -> bool:
    return _ARMED


def plan() -> ChaosPlan | None:
    return _PLAN


def jitter() -> float:
    """The backoff jitter factor in [1.0, 1.5): from the plan's seeded
    RNG when armed, the process RNG otherwise."""
    r = _RNG if _ARMED else random
    return 1.0 + 0.5 * r.random()


def _execute(inj: _Injection, site: str, ctx: dict) -> None:
    inj.spend()
    where = f"{site} {ctx}" if ctx else site
    if inj.kind == "compile-stall":
        time.sleep(_PLAN.stall_s if _PLAN is not None else 0.2)
        return
    if inj.kind == "device-error":
        raise DeviceChaosError(f"chaos: injected device error at {where}")
    if inj.kind == "staging-thread-death":
        raise StagingChaosError(f"chaos: staging thread died at {where}")
    if inj.kind == "chunk-corrupt":
        raise ChunkChaosError(f"chaos: chunk read corrupted at {where}")
    if inj.kind == "partial-rename":
        raise PartialRenameChaos(f"chaos: marker rename died at {where}")
    if inj.kind == "sigkill":
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


def _match(site: str, ctx: dict):
    """The matcher every seam shares -> (injection, seq) or None. A
    seam's counter advances only when the plan has injections there."""
    if not _ARMED:
        return None
    p = _PLAN
    if p is None:
        return None
    injections = p.for_site(site)
    if not injections:
        return None
    seq = p.next_seq(site)
    full = dict(ctx)
    for k in _SITE_SEQ_KEYS.get(site, ()):
        full.setdefault(k, seq)
    for inj in injections:
        if inj.matches(full):
            return inj, seq
    return None


def fire(site: str, **ctx) -> None:
    """The seam: a no-op disarmed; armed, the first matching injection
    raises, sleeps or kills by its kind."""
    m = _match(site, ctx)
    if m is not None:
        inj, seq = m
        _execute(inj, site, ctx or {"seq": seq})


def write_fault(**ctx) -> str | None:
    """The chunk writer's seam (`ImmutableDB.append_block`): the kind of
    the matching injection at ``append``, which the writer carries out;
    None when none matches."""
    m = _match("append", ctx)
    if m is None:
        return None
    inj, _seq = m
    inj.spend()
    return inj.kind


def sidecar_fault(site: str, **ctx) -> str | None:
    """The sidecar seams (``sidecar-build`` in `write_sidecar`,
    ``sidecar-open`` in `load_sidecar`): the matching injection's kind,
    which the sidecar module carries out; None when none matches."""
    m = _match(site, ctx)
    if m is None:
        return None
    inj, _seq = m
    inj.spend()
    return inj.kind
