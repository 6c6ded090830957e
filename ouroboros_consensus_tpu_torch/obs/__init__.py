"""obs: the port's telemetry, all on the host.

The JAX package's obs/ is the port's reference, module for module:

  * `registry`  counters, gauges and fixed-bucket histograms, the
                Prometheus text exposition and a JSON snapshot
  * `recorder`  the FlightRecorder: the batch tracer's sink (the
                window spans, gate declines, bytes and phase walls of
                validate_chain's loops) folded into the registry
  * `perfetto`  the Chrome trace-event export of a replay's events,
                with a warmup track
  * `warmup`    each kernel source's nvcc wall, each kernel's first
                launch, the recovery and repair rows, crash-safe on disk
  * `resources` each launched kernel's registers, local and shared
                memory, blocks per SM and bytes (`oct_stage_*`)
  * `live`      the live plane: the heartbeat file, the stall watchdog
                and the HTTP endpoint, armed for a replay
  * `ledger`    the append-only JSONL run ledger
  * `server`    the HTTP exposition (/metrics, /metrics.json, /healthz,
                /progress, /slo) on a thread
  * `recovery`  checkpoints and the recovery supervisor

The reference's environment levers are keywords here (revalidate's,
tools/bench.py's and tools/profile_replay.py's): `flight_recorder`
installs the recorder for the call. With nothing installed,
`protocol.batch.BATCH_TRACER` stays None and each site of the seam pays
one None check."""

from __future__ import annotations

import threading
from contextlib import contextmanager

from .recorder import FlightRecorder

_LOCK = threading.Lock()
_RECORDER: FlightRecorder | None = None
_INSTALL_DEPTH = 0  # guarded-by: _LOCK (read without it by `installed`)
_PREV_TRACER = None  # guarded-by: _LOCK


def installed() -> bool:
    """True while an install() is outstanding."""
    return _INSTALL_DEPTH > 0


def recorder() -> FlightRecorder:
    """The process-wide FlightRecorder (created on first use)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def install() -> FlightRecorder:
    """Chain the flight recorder into protocol.batch.BATCH_TRACER after
    any tracer already set. Re-entrant: nested installs share one entry
    in the chain; the outermost `uninstall` restores the previous
    tracer."""
    global _INSTALL_DEPTH, _PREV_TRACER
    rec = recorder()
    with _LOCK:
        if _INSTALL_DEPTH == 0:
            from ..protocol import batch as pbatch

            prev = _PREV_TRACER = pbatch.BATCH_TRACER
            if prev is None:
                pbatch.set_batch_tracer(rec)
            else:
                def chained(ev, _prev=prev, _rec=rec):
                    _prev(ev)
                    _rec(ev)

                pbatch.set_batch_tracer(chained)
        _INSTALL_DEPTH += 1
    return rec


def uninstall() -> None:
    """Undo one `install`."""
    global _INSTALL_DEPTH, _PREV_TRACER
    with _LOCK:
        if _INSTALL_DEPTH == 0:
            return
        _INSTALL_DEPTH -= 1
        if _INSTALL_DEPTH == 0:
            from ..protocol import batch as pbatch

            pbatch.set_batch_tracer(_PREV_TRACER)
            _PREV_TRACER = None


def reset_for_tests() -> None:
    """Drop the live plane, the recorder, the registry, the warmup and
    resources reports (test isolation)."""
    global _RECORDER, _INSTALL_DEPTH, _PREV_TRACER
    from . import live, resources
    from .registry import reset_default_registry
    from .warmup import WARMUP

    live.reset_for_tests()
    with _LOCK:
        if _INSTALL_DEPTH > 0:
            from ..protocol import batch as pbatch

            pbatch.set_batch_tracer(_PREV_TRACER)
        _RECORDER = None
        _INSTALL_DEPTH = 0
        _PREV_TRACER = None
        reset_default_registry()
    WARMUP.reset()
    WARMUP.path = None
    resources.RESOURCES.reset()


@contextmanager
def observe(flight_recorder: bool = False, heartbeat: str | None = None,
            stall_budget_s: float | None = None, stall_dump: str | None = None,
            metrics_port: int | None = None, warmup_report: str | None = None):
    """The observability keywords of a run (revalidate's, tools/bench.py's
    and tools/profile_replay.py's; the reference's OCT_* levers) for the
    block: `warmup_report` (WARMUP's report file), `flight_recorder`
    (install the recorder) and the live plane (`heartbeat`,
    `stall_budget_s`, `stall_dump`, `metrics_port`, live.maybe_arm).
    Yields the armed LivePlane or None. Exception-safe
    in the reference's order (tools/db_analyser.py:636-660): whatever
    escapes, the plane is disarmed, the recorder uninstalled and the
    settings restored, so no listener and no tracer is left behind."""
    from . import live
    from .warmup import WARMUP

    prev_path = WARMUP.path
    if warmup_report is not None:
        WARMUP.path = warmup_report
    installed = False
    try:
        if flight_recorder:
            install()
            installed = True
        plane = live.maybe_arm(heartbeat=heartbeat, stall_budget_s=stall_budget_s,
                               metrics_port=metrics_port, stall_dump=stall_dump,
                               warmup_report=warmup_report)
        try:
            yield plane
        finally:
            if plane is not None:
                plane.disarm()
    finally:
        if installed:
            uninstall()
        WARMUP.path = prev_path


def add_arguments(ap) -> None:
    """The observability flags of a tool's CLI (tools/bench.py,
    tools/profile_replay.py): the reference's OCT_* levers as flags;
    `keywords` turns them into `observe`'s (and revalidate's) keywords."""
    g = ap.add_argument_group("observability (obs/)")
    g.add_argument("--trace", dest="flight_recorder", action="store_true",
                   help="install the flight recorder for the replays")
    g.add_argument("--heartbeat", metavar="FILE",
                   help="rewrite a live JSON heartbeat to FILE every ~2 s")
    g.add_argument("--stall-budget-s", type=float, metavar="S",
                   help="the stall watchdog's no-progress budget (a stack dump on a trip)")
    g.add_argument("--stall-dump", metavar="FILE", help="the stall dump's file")
    g.add_argument("--metrics-port", type=int, metavar="PORT",
                   help="serve /metrics /metrics.json /healthz /progress on PORT "
                        "(0: a free port)")
    g.add_argument("--warmup-report", metavar="FILE",
                   help="rewrite the warmup report (nvcc walls, first launches) to FILE")
    g.add_argument("--ledger", metavar="DIR", default=None,
                   help="the run ledger's directory (default .oct_ledger/; 0: no record)")


def keywords(a) -> dict:
    """`observe`'s keywords from `add_arguments`' flags."""
    return {"flight_recorder": a.flight_recorder, "heartbeat": a.heartbeat,
            "stall_budget_s": a.stall_budget_s, "stall_dump": a.stall_dump,
            "metrics_port": a.metrics_port, "warmup_report": a.warmup_report}
