"""Deterministic discrete-event simulation runtime — the io-sim analog.

The port's copy of the JAX package's utils/sim.py (the ChainDB's
decoupled mode runs on it). The reference runs its entire node against
the `IOLike` abstraction so any component executes unmodified under
io-sim's simulated scheduler and virtual clock (Util/IOLike.hs;
runSimOrThrow at ThreadNet/General.hs:37). This module gives the control
plane the same property: cooperative tasks are plain Python generators
yielding effect requests to a scheduler whose order is a pure function
of (spawn order, virtual time) — every run of the same program is
bit-identical, and a failing schedule can be replayed under a debugger.

Effects a task can yield:
  Sleep(dt)        — resume at now + dt
  Recv(chan)       — resume when a message is available (returns it)
  Send(chan, msg)  — enqueue (arrives after chan.delay); never blocks
  Wait(event)      — resume when the event fires
  Fire(event)      — wake all waiters
  Spawn(gen)       — start a child task, resume immediately (returns Task)
  Stop()           — kill this task

Determinism rule: the run queue is ordered by (time, seq) where seq
increases monotonically with every scheduling action — FIFO among
same-time wakeups. No real clock, no OS threads, no races: the analog of
io-sim's schedule exploration is varying spawn order / delays via the
test's PRNG seed.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Generator, Iterable


# -- effect requests ---------------------------------------------------------


@dataclass(frozen=True)
class Sleep:
    dt: float


@dataclass(frozen=True)
class Recv:
    chan: "Channel"


@dataclass(frozen=True)
class RecvTimeout:
    """Recv that resumes with the TIMEOUT sentinel after `dt` if no
    message arrived — the typed-protocols timeout analog (the reference
    enforces e.g. the KeepAlive response deadline this way)."""

    chan: "Channel"
    dt: float


class _Timeout:
    def __repr__(self):
        return "TIMEOUT"


TIMEOUT = _Timeout()  # the RecvTimeout sentinel (identity-compared)


@dataclass(frozen=True)
class Send:
    chan: "Channel"
    msg: Any


@dataclass(frozen=True)
class Wait:
    event: "Event"


@dataclass(frozen=True)
class Fire:
    event: "Event"


@dataclass(frozen=True)
class Spawn:
    gen: Generator
    name: str = "task"


@dataclass(frozen=True)
class Stop:
    pass


class Channel:
    """Unbounded FIFO with a fixed per-message delivery delay (the
    ThreadNet `createConnectedChannelsWithDelay` analog, Network.hs:1341)."""

    def __init__(self, delay: float = 0.0, name: str = "chan"):
        self.delay = delay
        self.name = name
        self._ready: list = []  # heap of (deliver_time, seq, msg)
        self._waiters: list = []  # Tasks blocked on Recv, FIFO


class Event:
    """Broadcast wakeup (the Watcher-on-a-TVar analog, Util/STM.hs:112)."""

    def __init__(self, name: str = "event"):
        self.name = name
        self._waiters: list = []


class TaskFailed(Exception):
    """A task raised; the failure propagates out of Sim.run — the
    ResourceRegistry link-to-parent semantics (Util/ResourceRegistry.hs)."""

    def __init__(self, task_name: str, exc: BaseException):
        super().__init__(f"task {task_name!r} failed: {exc!r}")
        self.task_name = task_name
        self.exc = exc


@dataclass
class Task:
    name: str
    gen: Generator
    alive: bool = True
    result: Any = None
    wait_seq: int = 0  # identifies the CURRENT park (stale-timeout guard)


class Sim:
    """The deterministic scheduler.

    `seed` enables SCHEDULE EXPLORATION (io-sim's strongest property,
    exercised in the reference by varying QuickCheck seeds, SURVEY §5.2):
    same-time wakeups are ordered by a seed-keyed permutation instead of
    FIFO. Every seed still yields a fully deterministic, replayable run —
    a property that fails under seed 1234 fails under seed 1234 forever —
    but DIFFERENT seeds exercise different interleavings of the same
    program, surfacing order-dependent bugs that one schedule would hide.
    """

    def __init__(self, seed: int | None = None):
        self.now = 0.0
        self._seq = 0
        self.seed = seed
        # heap entries: (time, order_key, seq, kind, payload)
        #   kind "task":    payload = (Task, resume_value)
        #   kind "deliver": payload = Channel — flush due messages
        self._runq: list = []
        self.tasks: list[Task] = []
        self.stopped = False

    # -- plumbing ----------------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _order_key(self, seq: int) -> int:
        """FIFO by default; a seeded pseudo-random tiebreak otherwise
        (deterministic per (seed, seq) — replayable)."""
        if self.seed is None:
            return seq
        # splitmix-style integer hash of (seed, seq)
        z = (seq + self.seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    def _schedule(self, t: float, task: Task, value: Any = None) -> None:
        seq = self._next_seq()
        heapq.heappush(
            self._runq, (t, self._order_key(seq), seq, "task", (task, value))
        )

    def fire(self, event: Event) -> None:
        """Wake all waiters of `event`. Callable both from task context
        (the Fire effect routes here) and from synchronous code holding
        the scheduler — e.g. ChainDB.add_block_async notifying the
        add-block runner (the STM-TVar-write analog)."""
        for w in event._waiters:
            self._schedule(self.now, w)
        event._waiters.clear()

    def _schedule_delivery(self, t: float, chan: Channel) -> None:
        seq = self._next_seq()
        heapq.heappush(
            self._runq, (t, self._order_key(seq), seq, "deliver", chan)
        )

    def spawn(self, gen: Generator, name: str = "task") -> Task:
        task = Task(name, gen)
        self.tasks.append(task)
        self._schedule(self.now, task)
        return task

    def _flush_channel(self, chan: Channel) -> None:
        """Hand due messages to blocked receivers (FIFO both sides)."""
        while chan._waiters and chan._ready and chan._ready[0][0] <= self.now:
            _, _, msg = heapq.heappop(chan._ready)
            task = chan._waiters.pop(0)
            self._schedule(self.now, task, msg)

    # -- effect handling ---------------------------------------------------

    def _step(self, task: Task, value: Any) -> None:
        if not task.alive:
            return
        try:
            eff = task.gen.send(value)
        except StopIteration as e:
            task.alive = False
            task.result = e.value
            return
        except Exception as e:
            task.alive = False
            raise TaskFailed(task.name, e) from e

        if isinstance(eff, Sleep):
            self._schedule(self.now + eff.dt, task)
        elif isinstance(eff, (Recv, RecvTimeout)):
            chan = eff.chan
            if chan._ready and chan._ready[0][0] <= self.now and not chan._waiters:
                _, _, msg = heapq.heappop(chan._ready)
                self._schedule(self.now, task, msg)
            else:
                # earlier receivers are queued: join the FIFO behind them
                # (a due message must not let a latecomer jump the queue)
                chan._waiters.append(task)
                task.wait_seq = self._next_seq()
                if chan._ready:  # in-flight message: wake at its due time
                    self._schedule_delivery(chan._ready[0][0], chan)
                if isinstance(eff, RecvTimeout):
                    seq = self._next_seq()
                    heapq.heappush(self._runq, (
                        self.now + eff.dt, self._order_key(seq), seq,
                        "timeout", (chan, task, task.wait_seq),
                    ))
        elif isinstance(eff, Send):
            due = self.now + eff.chan.delay
            heapq.heappush(eff.chan._ready, (due, self._next_seq(), eff.msg))
            if eff.chan._waiters:
                self._schedule_delivery(due, eff.chan)
            self._schedule(self.now, task)
        elif isinstance(eff, Wait):
            eff.event._waiters.append(task)
        elif isinstance(eff, Fire):
            self.fire(eff.event)
            self._schedule(self.now, task)
        elif isinstance(eff, Spawn):
            child = self.spawn(eff.gen, eff.name)
            self._schedule(self.now, task, child)
        elif isinstance(eff, Stop):
            task.alive = False
        else:
            raise TypeError(f"task {task.name!r} yielded {eff!r}")

    # -- run loop ----------------------------------------------------------

    def run(self, until: float | None = None, max_steps: int = 10_000_000) -> float:
        """Run until the queue drains or virtual time passes `until`.
        Returns the final virtual time."""
        steps = 0
        while self._runq and not self.stopped:
            t, _, _, kind, payload = self._runq[0]
            if until is not None and t > until:
                self.now = until
                return self.now
            heapq.heappop(self._runq)
            self.now = max(self.now, t)
            if kind == "deliver":
                self._flush_channel(payload)
                continue
            if kind == "timeout":
                chan, task, wait_seq = payload
                # fire only if the task is STILL in this very park (a
                # delivered message, or a later re-park on the same
                # channel, invalidates the timer)
                if (task.alive and task.wait_seq == wait_seq
                        and task in chan._waiters):
                    chan._waiters.remove(task)
                    self._schedule(self.now, task, TIMEOUT)
                continue
            task, value = payload
            self._step(task, value)
            steps += 1
            if steps >= max_steps:
                raise RuntimeError("sim exceeded max_steps (livelock?)")
        return self.now


# -- convenience for tests ---------------------------------------------------


def run_sim(mains: Iterable[tuple[str, Generator]], until: float | None = None) -> Sim:
    sim = Sim()
    for name, gen in mains:
        sim.spawn(gen, name)
    sim.run(until=until)
    return sim
