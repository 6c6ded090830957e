"""Chrome trace-event (Perfetto / chrome://tracing) export of a replay.

The JAX package's obs/perfetto.py is the port's reference, with the
same layout: one process ("oct replay"), a thread row per phase label
(stage / dispatch / materialize / epilogue / stream and the read's
stream-mmap and stream-parse, which take rows of their own), a
"windows" row with one complete ("X") slice per retired window whose
args carry lanes / outcome / gate / n_valid, counter ("C") tracks of
the H2D and D2H bytes, and a "warmup" row rebuilt from the warmup
report (obs/warmup.py): a slice for each kernel source's nvcc build and
each kernel's first launch, and instants for the recovery and repair
rows. The warmup rows need the recorder's monotonic t0, so they appear
when exporting from the live process (FlightRecorder.chrome_trace,
tools/profile_replay.py --trace-out).

    python -m ouroboros_consensus_tpu_torch.tools.profile_replay --trace-out replay.json
    # then open ui.perfetto.dev and drag the file in

`validate_chrome_trace` is the schema check: the Trace Event Format's
required keys, phase vocabulary, non-negative ts/dur and JSON
serialisability."""

from __future__ import annotations

import json
from typing import Iterable

from ..utils.trace import EncloseEvent, TransferEvent, WindowSpan, WindowStaged

PID = 1
# stable thread ids a track; unknown labels take ids past these
_TIDS = {
    "windows": 1, "stage": 2, "dispatch": 3, "materialize": 4,
    "epilogue": 5, "stream": 6, "warmup": 7,
}

_ALLOWED_PH = {"X", "B", "E", "i", "C", "M"}


def _meta(name: str, tid: int | None = None) -> dict:
    return {"name": "process_name" if tid is None else "thread_name", "ph": "M",
            "pid": PID, "tid": 0 if tid is None else tid, "ts": 0, "args": {"name": name}}


def _warmup_slices(wu: dict, t0: float):
    """(name, end monotonic, wall s, args) of each build and first launch."""
    for src, row in sorted(wu.get("builds", {}).items()):
        wall = float(row.get("wall_s", 0.0))
        yield (f"nvcc {src}" + (" [cached]" if row.get("cached") else ""),
               t0 + float(row.get("t", 0.0)), wall, {"wall_s": wall})
    for stage, row in sorted(wu.get("stages", {}).items()):
        wall = float(row.get("wall_s", 0.0))
        yield (f"{stage} first launch", t0 + float(row.get("t", 0.0)), wall,
               {"via": row.get("via", "launch"), "wall_s": wall})


def _warmup_instants(wu: dict, t0: float):
    for row in wu.get("recovery", []):
        yield f"recovery: {row.get('action', '?')} (window {row.get('window', '?')})", \
            t0 + float(row.get("t", 0.0))
    for row in wu.get("repairs", []):
        yield f"repair: {row.get('action', '?')} (chunk {row.get('chunk', '?')})", \
            t0 + float(row.get("t", 0.0))


def to_chrome_trace(timed_events: Iterable[tuple[float, object]],
                    warmup_report: dict | None = None,
                    warmup_t0: float | None = None) -> dict:
    """[(t_monotonic_received, event)] -> a Trace Event Format document.

    An `EncloseEvent`'s end edge becomes an "X" slice on its label's
    track (its own t and duration); a `WindowSpan` an "X" slice on the
    windows track; a generic `WindowStaged` an instant naming its gate;
    a `TransferEvent` a byte counter. `warmup_report` with `warmup_t0`
    (the recorder's monotonic epoch; report times are relative to it)
    adds the warmup track."""
    timed = list(timed_events)
    tids = dict(_TIDS)

    def tid_of(label: str) -> int:
        t = tids.get(label)
        if t is None:
            t = tids[label] = max(tids.values()) + 1
        return t

    wu = warmup_report if (warmup_report and warmup_t0 is not None) else None
    # every timestamp against the earliest one: the builds and first
    # launches usually start before the first window
    starts = [ev.t - (ev.duration or 0.0) if isinstance(ev, EncloseEvent) else t
              for t, ev in timed]
    if wu:
        starts += [end - wall for _n, end, wall, _a in _warmup_slices(wu, warmup_t0)]
        starts += [t for _n, t in _warmup_instants(wu, warmup_t0)]
    t_zero = min(starts, default=0.0)

    def us(t: float) -> float:
        return max(0.0, (t - t_zero) * 1e6)

    events: list[dict] = [_meta("oct replay")]
    for label, t in sorted(_TIDS.items(), key=lambda kv: kv[1]):
        events.append(_meta(label, t))

    for t_recv, ev in timed:
        if isinstance(ev, EncloseEvent):
            if ev.edge != "end" or ev.duration is None:
                continue  # the end edge alone rebuilds the slice
            events.append({
                "name": ev.label, "cat": "phase", "ph": "X",
                "ts": us(ev.t - ev.duration), "dur": ev.duration * 1e6,
                "pid": PID, "tid": tid_of(ev.label),
            })
        elif isinstance(ev, WindowSpan):
            t0 = ev.t_dispatch - ev.dispatch_s - ev.stage_s
            events.append({
                "name": f"window {ev.index} [{ev.outcome}]", "cat": "window", "ph": "X",
                "ts": us(t0), "dur": max(0.0, (ev.t_done - t0) * 1e6),
                "pid": PID, "tid": _TIDS["windows"],
                "args": {
                    "lanes": ev.lanes, "outcome": ev.outcome, "gate": ev.gate or "",
                    "n_valid": ev.n_valid, "failed": ev.failed,
                    "device_latency_ms": round((ev.t_materialized - ev.t_dispatch) * 1e3, 3),
                },
            })
        elif isinstance(ev, TransferEvent):
            counter = "h2d_bytes" if ev.phase == "dispatch" else "d2h_bytes"
            events.append({
                "name": counter, "cat": "transfer", "ph": "C", "ts": us(t_recv),
                "pid": PID, "tid": 0, "args": {counter: ev.h2d_bytes or ev.d2h_bytes},
            })
        elif isinstance(ev, WindowStaged) and ev.outcome == "generic":
            events.append({
                "name": f"gate: {ev.gate or 'packed-off'}", "cat": "gate", "ph": "i",
                "s": "t", "ts": us(t_recv), "pid": PID, "tid": _TIDS["windows"],
            })

    if wu:
        wtid = _TIDS["warmup"]
        for name, end, wall, args in _warmup_slices(wu, warmup_t0):
            events.append({"name": name, "cat": "warmup", "ph": "X", "ts": us(end - wall),
                           "dur": max(0.0, wall * 1e6), "pid": PID, "tid": wtid,
                           "args": args})
        for name, t in _warmup_instants(wu, warmup_t0):
            events.append({"name": name, "cat": "warmup", "ph": "i", "s": "t", "ts": us(t),
                           "pid": PID, "tid": wtid})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write(path: str, timed_events, warmup_report: dict | None = None,
          warmup_t0: float | None = None) -> dict:
    doc = to_chrome_trace(timed_events, warmup_report, warmup_t0)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc) -> list[str]:
    """Structural validation against the Chrome trace-event JSON object
    model -> the problems (empty: valid)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        errs.append(f"not JSON-serializable: {e}")
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"{where}: name missing or not a string")
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            errs.append(f"{where}: ph {ph!r} not in {sorted(_ALLOWED_PH)}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: ts must be a non-negative number")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errs.append(f"{where}: {k} missing or not an int")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event needs non-negative dur")
        if ph in ("C", "M") and not isinstance(ev.get("args"), dict):
            errs.append(f"{where}: {ph} event needs an args object")
    return errs
