"""The live run plane: the heartbeat and the stall watchdog.

The JAX package's obs/live.py is the port's reference. The recorder,
the warmup report and the run ledger explain a run after it ended; this
plane says what a replay is doing while it runs:

  * `Heartbeat`, a daemon thread that rewrites a JSON snapshot every
    ~2 s by tmp + rename (`heartbeat` path): the phase of the
    recorder's newest event, the newest retired window, the headers
    retired, a rolling headers/s, the warmup slice and the age of the
    last observable progress. `read_heartbeat` and `classify` read it.
  * `StallWatchdog`, a monotonic no-progress budget (`stall_budget_s`).
    On a trip it dumps every thread's stack (`sys._current_frames` and
    a `faulthandler` twin) with the warmup report and the recorder's
    latency summary into a file (`stall_dump`, else beside the warmup
    report or the heartbeat), counts `oct_stalls_total{phase=}` and
    emits a `StallEvent`. The dump is evidence; ending the run is the
    parent's business.
  * `maybe_arm`, the one call that mounts it for a replay: the
    recorder installed, the heartbeat with its watchdog, and the HTTP
    endpoint (`metrics_port`; 0 binds a free port), ref-counted like
    `obs.install`. /healthz and /progress of obs/server.py serve the
    armed plane's document (`current_doc`).

The reference's levers (OCT_HEARTBEAT, OCT_STALL_BUDGET_S,
OCT_STALL_DUMP, OCT_METRICS_PORT, OCT_WARMUP_REPORT) are maybe_arm's
keywords. Everything is host-side and a beat is a dict and a rename
every ~2 s, never a device call."""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque

# the heartbeat's cadence; classify()'s staleness threshold derives from it
BEAT_INTERVAL_S = 2.0
# the rolling rate's window
RATE_WINDOW_S = 30.0


def stall_dump_path(stall_dump: str | None = None, warmup_report: str | None = None,
                    heartbeat: str | None = None) -> str:
    """Where the stall forensics land: `stall_dump` when given, else
    beside the warmup report, else beside the heartbeat, else the cwd."""
    if stall_dump:
        return stall_dump
    for anchor in (warmup_report, heartbeat):
        if anchor:
            return os.path.join(os.path.dirname(os.path.abspath(anchor)), "stall_dump.json")
    return "stall_dump.json"


# ---------------------------------------------------------------------------
# phase classification
# ---------------------------------------------------------------------------


def phase_of(ev) -> str:
    """A recorder event's live phase."""
    from ..utils import trace as T

    if isinstance(ev, T.EncloseEvent):
        return ev.label  # stage | dispatch | materialize | epilogue | stream...
    if isinstance(ev, T.WindowStaged):
        return "dispatch"
    if isinstance(ev, T.WindowSpan):
        return "retired"
    if isinstance(ev, T.TransferEvent):
        return ev.phase
    if isinstance(ev, T.AggRedispatch):
        return "agg-redispatch"
    if isinstance(ev, T.RecoveryEvent):
        return "recovery"
    if isinstance(ev, T.CheckpointEvent):
        return "retired"  # a checkpoint write follows a retired window
    if isinstance(ev, T.StallEvent):
        return "stalled"
    return type(ev).__name__


def _warmup_live(report: dict) -> dict:
    """The warmup slice of the heartbeat. The port builds its kernels
    before a replay and compiles nothing during one, so nothing is
    ever compiling while it runs."""
    notes = report.get("notes") or []
    return {
        "n_stages": report.get("n_stages", 0),
        "compile_total_s": report.get("compile_total_s", 0.0),
        "last_note": notes[-1] if notes else None,
        "compiling_now": False,
    }


def live_snapshot(rec=None, clock=time.monotonic) -> dict:
    """One heartbeat document (what /healthz serves): counter reads, the
    recorder's newest event and the warmup report; never a device call."""
    from .. import obs
    from .warmup import WARMUP

    rec = rec if rec is not None else obs.recorder()
    now = clock()
    last = rec.last_event()
    report = WARMUP.report()
    wu = _warmup_live(report)
    if last is not None:
        phase = phase_of(last[1])
        age = max(0.0, now - last[0])
    else:
        phase = "warmup" if (wu["last_note"] or wu["n_stages"]) else "idle"
        age = report.get("elapsed_s", 0.0)
    return {
        "v": 1,
        "pid": os.getpid(),
        "ts_unix": time.time(),
        "t_mono": now,
        "phase": phase,
        "age_s": round(age, 3),
        "headers": rec.headers_retired(),
        "window_index": rec.last_window_index(),
        "stalls": _stall_count(rec),
        "warmup": wu,
    }


def _stall_count(rec) -> int:
    # under the registry lock: a trip's label first-touch inserts into
    # the child dict that samples() iterates
    with rec.registry._lock:
        fam = rec.registry._families.get("oct_stalls_total")
        if fam is None:
            return 0
        return int(sum(child.value for _l, child in fam.samples()))


def classify(doc: dict | None, now_unix: float | None = None,
             interval_s: float = BEAT_INTERVAL_S) -> str:
    """A reader's classification of a heartbeat document:

        no-heartbeat   no document
        dead           the file stopped being rewritten (> 5 beats old)
        stalled        the watchdog is tripped right now (`stalled_now`)
        compiling      warmup is the freshest activity, no window yet
        staging        the host prepares windows (stage / stream)
        running        windows dispatch and retire
        done           the armed run ended (the final beat, `done`)
        idle           armed, nothing happened yet
    """
    if not isinstance(doc, dict) or "ts_unix" not in doc:
        return "no-heartbeat"
    now_unix = time.time() if now_unix is None else now_unix
    if doc.get("done"):
        return "done"
    if now_unix - float(doc["ts_unix"]) > 5 * interval_s:
        return "dead"
    if doc.get("stalled_now"):
        return "stalled"
    phase = doc.get("phase", "idle")
    if phase == "warmup" or (doc.get("warmup") or {}).get("compiling_now"):
        return "compiling"
    if phase.startswith("stream") or phase in ("stage", "prechecks"):
        return "staging"
    if phase == "stalled":
        return "stalled"
    return "idle" if phase == "idle" else "running"


# ---------------------------------------------------------------------------
# the stall watchdog
# ---------------------------------------------------------------------------


class StallWatchdog:
    """A monotonic no-progress budget over the recorder and the warmup
    report. `check()` takes an injected clock (the tests'); the
    heartbeat calls it each beat. One dump per stall episode: a trip
    stays quiet until progress resumes."""

    def __init__(self, budget_s: float, rec=None, dump_path: str | None = None,
                 clock=time.monotonic):
        from .. import obs

        self.budget_s = float(budget_s)
        self.rec = rec if rec is not None else obs.recorder()
        self.dump_path = dump_path or stall_dump_path()
        self.clock = clock
        self.tripped = False
        self.dumps = 0
        self._last_progress_t = self.clock()
        self._fingerprint = self._current_fingerprint()

    def _current_fingerprint(self) -> tuple:
        from .warmup import WARMUP

        with WARMUP._lock:
            # recovery transitions are progress: a window walked down the
            # ladder is not a wedge
            wu = (len(WARMUP.stages), len(WARMUP.notes), len(WARMUP.builds),
                  len(WARMUP.recovery))
        return self.rec.progress_fingerprint() + wu

    def check(self, now: float | None = None) -> dict | None:
        """Advance the watchdog -> the dump document on a trip, else None."""
        now = self.clock() if now is None else now
        fp = self._current_fingerprint()
        if fp != self._fingerprint:
            self._fingerprint = fp
            self._last_progress_t = now
            self.tripped = False
            return None
        age = now - self._last_progress_t
        if self.tripped or age <= self.budget_s:
            return None
        self.tripped = True
        return self._dump(age)

    def _thread_stacks(self) -> dict:
        """{thread name: [frame lines]} for every live thread."""
        names = {t.ident: t.name for t in threading.enumerate()}
        return {f"{names.get(ident, 'thread')}-{ident}":
                [ln.rstrip("\n") for ln in traceback.format_stack(frame)]
                for ident, frame in sys._current_frames().items()}

    def _dump(self, age: float) -> dict:
        from ..utils.trace import StallEvent
        from .warmup import WARMUP

        last = self.rec.last_event()
        phase = phase_of(last[1]) if last is not None else "warmup"
        doc = {
            "v": 1,
            "pid": os.getpid(),
            "ts_unix": time.time(),
            "phase": phase,
            "age_s": round(age, 3),
            "budget_s": self.budget_s,
            "threads": self._thread_stacks(),
            "heartbeat": live_snapshot(self.rec, clock=self.clock),
            "warmup_report": WARMUP.report(),
            "metrics_summary": self.rec.latency_summary(),
        }
        path = self.dump_path
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
            # the raw faulthandler twin, in case the interpreter is too
            # wedged for the walk above
            import faulthandler

            with open(path + ".txt", "w", encoding="utf-8") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
            doc["_path"] = path
        except OSError:
            doc["_path"] = None  # forensics are best-effort
        self.dumps += 1
        self.rec(StallEvent(phase=phase, age_s=age, budget_s=self.budget_s,
                            dump_path=doc.get("_path")))
        # the StallEvent moved the recorder's stream: refresh the
        # fingerprint so the watchdog's own evidence is not progress
        self._fingerprint = self._current_fingerprint()
        return doc


# ---------------------------------------------------------------------------
# the heartbeat thread
# ---------------------------------------------------------------------------


class Heartbeat:
    """Every `interval_s`: compose `live_snapshot()`, fold in the rolling
    headers/s, rewrite `path` by tmp + rename (a kill mid-rewrite leaves
    the previous beat), and drive the watchdog. `path=None` beats
    without a file. `stop()` writes a final beat marked `done`."""

    def __init__(self, path: str | None, rec=None, interval_s: float = BEAT_INTERVAL_S,
                 watchdog: StallWatchdog | None = None, clock=time.monotonic):
        from .. import obs

        self.path = path
        self.rec = rec if rec is not None else obs.recorder()
        self.interval_s = interval_s
        self.watchdog = watchdog
        self.clock = clock
        self._beat_lock = threading.Lock()
        self.seq = 0  # guarded-by: _beat_lock
        self._samples: deque[tuple[float, int]] = deque()  # guarded-by: _beat_lock
        self.beat_errors = 0  # guarded-by: _beat_lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self, done: bool = False) -> dict:
        with self._beat_lock:
            now = self.clock()
            doc = live_snapshot(self.rec, clock=self.clock)
            self._samples.append((now, doc["headers"]))
            # keep a two-sample anchor: a silent stretch reads 0.0/s
            while len(self._samples) > 2 and now - self._samples[1][0] > RATE_WINDOW_S:
                self._samples.popleft()
            t0, h0 = self._samples[0]
            dt = now - t0
            doc["headers_per_s"] = round((doc["headers"] - h0) / dt, 1) if dt > 0.5 else None
            doc["seq"] = self.seq
            doc["interval_s"] = self.interval_s
            if self.beat_errors:
                doc["beat_errors"] = self.beat_errors
            self.seq += 1
            if self.watchdog is not None:
                self.watchdog.check(now)
                doc["stalls"] = _stall_count(self.rec)
                # the current state, not the lifetime count
                doc["stalled_now"] = self.watchdog.tripped
            if done:
                doc["done"] = True
            if self.path:
                try:
                    tmp = self.path + ".tmp"
                    with open(tmp, "w", encoding="utf-8") as f:
                        json.dump(doc, f)
                    os.replace(tmp, self.path)
                except OSError:
                    pass  # the heartbeat never breaks the run it describes
            return doc

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._safe_beat()  # an armed plane is visible at once
        self._thread = threading.Thread(target=self._run, name="oct-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._safe_beat()

    def _safe_beat(self, done: bool = False) -> None:
        try:
            self.beat(done)
        except Exception as exc:  # noqa: BLE001 — the diagnostics never break the run
            self._note_beat_error(exc)

    def _note_beat_error(self, exc: BaseException) -> None:
        """Count a failed beat (the next good one publishes the count)
        and note the first in the warmup report."""
        with self._beat_lock:
            self.beat_errors += 1
            first = self.beat_errors == 1
        if first:
            from .warmup import WARMUP

            WARMUP.note(f"heartbeat beat failed: {type(exc).__name__}: {exc}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5)
            self._thread = None
        self._safe_beat(done=True)  # the file's last word is the finished run


def read_heartbeat(path: str) -> dict | None:
    """A heartbeat document; None when absent or torn."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# the one-call mount
# ---------------------------------------------------------------------------


class LivePlane:
    """One armed plane: the heartbeat (with its watchdog) and the HTTP
    endpoint over the installed recorder. `disarm()` undoes one arm."""

    def __init__(self, heartbeat: Heartbeat, server=None, rec=None):
        self.heartbeat = heartbeat
        self.server = server
        self.rec = rec

    def doc(self) -> dict:
        return live_snapshot(self.rec)

    def disarm(self) -> None:
        _disarm(self)


_LOCK = threading.Lock()
_DEPTH = 0  # guarded-by: _LOCK
_PLANE: LivePlane | None = None  # guarded-by: _LOCK


def armed() -> LivePlane | None:
    """The armed plane, or None."""
    return _PLANE


def current_doc() -> dict | None:
    """The armed plane's heartbeat document; None when none is armed."""
    plane = _PLANE
    return plane.doc() if plane is not None else None


def maybe_arm(heartbeat: str | None = None, stall_budget_s: float | None = None,
              metrics_port: int | None = None, stall_dump: str | None = None,
              warmup_report: str | None = None, rec=None) -> LivePlane | None:
    """Arm the live plane when any of `heartbeat` (a file),
    `stall_budget_s` or `metrics_port` (0: a free port) is given; else
    None. Ref-counted like obs.install: nested replays share one plane
    and the outermost disarm stops its thread and server. Arming is
    exception-safe: a failure past the count's bump undoes all it did,
    so no listener or installed tracer is left behind."""
    if heartbeat is None and stall_budget_s is None and metrics_port is None:
        return None
    global _DEPTH, _PLANE
    from .. import obs
    from . import server as obs_server

    with _LOCK:
        _DEPTH += 1
        if _PLANE is not None:
            return _PLANE
        installed = hb = srv = None
        try:
            installed = obs.install()
            rec = rec if rec is not None else installed
            wd = (StallWatchdog(stall_budget_s, rec=rec,
                                dump_path=stall_dump_path(stall_dump, warmup_report, heartbeat))
                  if stall_budget_s is not None else None)
            hb = Heartbeat(heartbeat, rec=rec, watchdog=wd).start()
            if metrics_port is not None:
                srv = obs_server.MetricsServer(port=metrics_port, registry=rec.registry,
                                               live_doc=lambda: live_snapshot(rec))
            _PLANE = LivePlane(hb, srv, rec)
        except BaseException:
            if srv is not None:
                srv.close()
            if hb is not None:
                hb.stop()
            if installed is not None:
                obs.uninstall()
            _DEPTH -= 1
            raise
        return _PLANE


def _disarm(plane: LivePlane) -> None:
    global _DEPTH, _PLANE
    with _LOCK:
        if _PLANE is not plane or _DEPTH == 0:
            return
        _DEPTH -= 1
        if _DEPTH > 0:
            return
        _PLANE = None
    plane.heartbeat.stop()
    if plane.server is not None:
        plane.server.close()
    from .. import obs

    obs.uninstall()


def reset_for_tests() -> None:
    """Drop any armed plane (test isolation)."""
    global _DEPTH, _PLANE
    with _LOCK:
        plane, _PLANE, _DEPTH = _PLANE, None, 0
    if plane is not None:
        plane.heartbeat.stop()
        if plane.server is not None:
            plane.server.close()
