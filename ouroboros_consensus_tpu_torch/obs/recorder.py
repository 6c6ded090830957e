"""FlightRecorder: the batch tracer's sink.

The JAX package's obs/recorder.py is the port's reference. One
process-wide recorder chains into `protocol.batch.BATCH_TRACER`
(obs.install keeps whatever tracer was set), keeps the timed event
stream for the Perfetto export, and folds each event into the metrics
registry, in the reference's families:

    oct_windows_total{outcome=}            dispatched windows
    oct_gate_declines_total{gate=}         why the packed staging said no
    oct_headers_validated_total            headers retired valid
    oct_agg_redispatch_total               dirty aggregated windows
    oct_h2d_bytes_total / oct_d2h_bytes_total
    oct_window_{stage,dispatch,materialize,epilogue}_seconds   histograms
    oct_window_device_latency_seconds      dispatch -> materialize wall
    oct_stalls_total{phase=}               stall-watchdog trips (obs/live)
    oct_recovery_total{action=}            recovery-ladder transitions
    oct_checkpoint_events_total{kind=}     progress-record movement
    oct_repair_total{action=}              store repairs applied
    oct_sidecar_total{outcome=}            sidecar probe and build outcomes
    oct_forge_windows_total{engine=}       forge election windows
    oct_forge_elected_total                slots won in them
    oct_forge_signed_total                 blocks forged and appended

The reference's `oct_ladder_events_total` and `oct_shard_*` families
are left out: no ported code emits their events. A window, never a
header, is the unit, so a replay of 1M headers records a few hundred
events."""

from __future__ import annotations

import threading
import time

from ..utils.trace import (AggRedispatch, CheckpointEvent, ForgeSpan, RecoveryEvent,
                           RepairEvent, SidecarEvent, StallEvent, TransferEvent, WindowSpan,
                           WindowStaged)
from . import registry as _registry

# the bounded event buffer: a pathological run cannot grow it without limit
MAX_EVENTS = 200_000


class FlightRecorder:
    def __init__(self, reg: "_registry.MetricsRegistry | None" = None):
        self.registry = reg if reg is not None else _registry.default_registry()
        self._lock = threading.Lock()
        self.events: list[tuple[float, object]] = []  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        r = self.registry
        self._windows = r.counter("oct_windows_total", "dispatched device windows",
                                  ("outcome",))
        self._gates = r.counter("oct_gate_declines_total",
                                "packed-staging qualification gate declines", ("gate",))
        self._headers = r.counter("oct_headers_validated_total", "lanes retired valid")
        self._redisp = r.counter("oct_agg_redispatch_total",
                                 "aggregate windows re-dispatched per-lane")
        self._h2d = r.counter("oct_h2d_bytes_total", "bytes staged to device")
        self._d2h = r.counter("oct_d2h_bytes_total", "bytes returned to host")
        self._phase_h = {
            p: r.histogram(f"oct_window_{p}_seconds", f"per-window {p} wall")
            for p in ("stage", "dispatch", "materialize", "epilogue")
        }
        self._latency = r.histogram("oct_window_device_latency_seconds",
                                    "dispatch->materialize wall per window")
        self._stalls = r.counter("oct_stalls_total", "stall-watchdog trips", ("phase",))
        self._recovery = r.counter("oct_recovery_total",
                                   "recovery-supervisor ladder transitions", ("action",))
        self._checkpoints = r.counter("oct_checkpoint_events_total",
                                      "progress-record writes/resumes/completions", ("kind",))
        # applied repairs only: a dry run's rows ride the warmup report
        self._repairs = r.counter("oct_repair_total", "on-disk store repair actions applied",
                                  ("action",))
        self._sidecar = r.counter("oct_sidecar_total", "columnar-sidecar probe/build outcomes",
                                  ("outcome",))
        self._forge_windows = r.counter("oct_forge_windows_total",
                                        "forge election windows dispatched", ("engine",))
        self._forge_elected = r.counter("oct_forge_elected_total", "slots won in forge windows")
        self._forge_signed = r.counter("oct_forge_signed_total", "blocks forged and appended")
        # the heartbeat's source: the newest event (kept once the buffer
        # is full) and the newest retired window's index
        self._last: "tuple[float, object] | None" = None  # guarded-by: _lock
        self._last_span_index = -1  # guarded-by: _lock

    # -- the tracer ---------------------------------------------------------

    def __call__(self, ev) -> None:
        now = time.monotonic()
        with self._lock:
            self._last = (now, ev)
            if len(self.events) < MAX_EVENTS:
                self.events.append((now, ev))
            else:
                self.dropped += 1
        if isinstance(ev, WindowStaged):
            self._windows.labels(outcome=ev.outcome).inc()
            if ev.outcome == "generic":
                self._gates.labels(gate=ev.gate or "packed-off").inc()
            elif ev.gate:
                self._gates.labels(gate=ev.gate).inc()
        elif isinstance(ev, WindowSpan):
            with self._lock:
                if ev.index > self._last_span_index:
                    self._last_span_index = ev.index
            self._headers.inc(ev.n_valid)
            self._phase_h["stage"].observe(ev.stage_s)
            self._phase_h["dispatch"].observe(ev.dispatch_s)
            self._phase_h["materialize"].observe(ev.materialize_s)
            self._phase_h["epilogue"].observe(ev.epilogue_s)
            self._latency.observe(max(0.0, ev.t_materialized - ev.t_dispatch))
        elif isinstance(ev, AggRedispatch):
            self._redisp.inc()
        elif isinstance(ev, TransferEvent):
            if ev.phase == "dispatch":
                self._h2d.inc(ev.h2d_bytes)
            else:
                self._d2h.inc(ev.d2h_bytes)
        elif isinstance(ev, StallEvent):
            self._stalls.labels(phase=ev.phase).inc()
        elif isinstance(ev, RecoveryEvent):
            self._recovery.labels(action=ev.action).inc()
        elif isinstance(ev, CheckpointEvent):
            self._checkpoints.labels(kind=ev.kind).inc()
        elif isinstance(ev, RepairEvent):
            if ev.applied:
                self._repairs.labels(action=ev.action).inc()
        elif isinstance(ev, SidecarEvent):
            self._sidecar.labels(outcome=ev.outcome).inc()
        elif isinstance(ev, ForgeSpan):
            self._forge_windows.labels(engine=ev.engine).inc()
            self._forge_elected.inc(ev.elected)
            self._forge_signed.inc(ev.signed)
        # EncloseEvent: kept in the stream (the Perfetto slices) only

    # -- the live plane's source (obs/live.py) ------------------------------

    def last_event(self) -> "tuple[float, object] | None":
        """(monotonic t, event) of the newest event seen."""
        with self._lock:
            return self._last

    def progress_fingerprint(self) -> tuple:
        """A value that changes whenever the replay makes any observable
        progress (the stall watchdog's test)."""
        with self._lock:
            last_t = self._last[0] if self._last is not None else 0.0
            n = len(self.events) + self.dropped
            idx = self._last_span_index
        return (self._headers.value, idx, last_t, n)

    def headers_retired(self) -> int:
        return int(self._headers.value)

    def last_window_index(self) -> int:
        with self._lock:
            return self._last_span_index

    # -- reporting ----------------------------------------------------------

    def timed_events(self) -> list[tuple[float, object]]:
        with self._lock:
            return list(self.events)

    def _warmup_state(self) -> tuple[dict, float]:
        """The warmup report and its monotonic epoch, so that the export
        puts the builds and first launches on the windows' timeline."""
        from .warmup import WARMUP

        return WARMUP.report(), WARMUP.t0

    def chrome_trace(self) -> dict:
        from . import perfetto

        report, t0 = self._warmup_state()
        return perfetto.to_chrome_trace(self.timed_events(), report, t0)

    def write_chrome_trace(self, path: str) -> dict:
        from . import perfetto

        report, t0 = self._warmup_state()
        return perfetto.write(path, self.timed_events(), report, t0)

    def latency_summary(self) -> dict:
        """p50/p99 of the dispatch -> materialize latency and each phase's
        p50."""
        out = {
            "device_latency_p50_s": self._latency.quantile(0.5),
            "device_latency_p99_s": self._latency.quantile(0.99),
            "windows": self._latency.count,
        }
        for p, h in self._phase_h.items():
            out[f"{p}_p50_s"] = h.quantile(0.5)
        return out

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0
            self._last = None
            self._last_span_index = -1
