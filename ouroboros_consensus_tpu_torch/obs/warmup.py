"""Warmup forensics: where did the time before the first window go?

The JAX package's obs/warmup.py is the port's reference. The port
compiles nothing while it runs (its kernels are built by `nvcc` before
a replay, ops/pk/build.py), so its rows are:

  * `builds`   each kernel source's `nvcc` wall (the seconds from the
               start of the parallel build to that source's exit; 0 for
               a library built earlier, `cached`), noted by
               `build.build_cuda`;
  * `stages`   each kernel's first launch in the process: the host wall
               of the launch call, which holds the module's load on the
               card (no synchronisation: the launch is asynchronous),
               noted by the kernel wrappers (ops/pk/kernels.py);
  * `recovery` the recovery supervisor's ladder transitions
               (obs/recovery.py);
  * `repairs`  the store's repairs (storage/repair.note_repair);
  * `notes`    free-form breadcrumbs (a resume, a failed heartbeat).

Recording is always on: a dict insert at a kernel's first launch, none
after. With a report path set (`WARMUP.path`, revalidate's and the
tools' `warmup_report` keyword), every note rewrites the report by tmp
+ rename, so a process killed mid-run leaves the last complete report
on disk, never a torn one (`read_report`). The AOT, refusal, ladder and
cache-probe rows of the reference are not ported: they exist because
XLA compiles while the replay runs."""

from __future__ import annotations

import json
import os
import threading
import time


class WarmupRecorder:
    """The process's warmup forensics."""

    def __init__(self):
        self._lock = threading.Lock()
        # serialises the tmp write and rename, so that two threads' notes
        # never interleave on the shared tmp path
        self._flush_lock = threading.Lock()
        self.path: str | None = None  # the report file, rewritten after each note
        self.t0 = time.monotonic()
        self.stages: dict[str, dict] = {}  # guarded-by: _lock
        self.builds: dict[str, dict] = {}  # guarded-by: _lock
        self.recovery: list[dict] = []  # guarded-by: _lock
        self.repairs: list[dict] = []  # guarded-by: _lock
        self.notes: list[str] = []  # guarded-by: _lock

    def _t(self) -> float:
        return round(time.monotonic() - self.t0, 3)

    # -- recording ----------------------------------------------------------

    def note_stage(self, stage: str, wall_s: float, via: str = "launch") -> bool:
        """A kernel's first launch wall; True when this call was the
        first for `stage`."""
        with self._lock:
            if stage in self.stages:
                return False
            self.stages[stage] = {"wall_s": round(wall_s, 6), "via": via, "t": self._t()}
        self._flush()
        return True

    def note_build(self, source: str, wall_s: float, cached: bool = False) -> None:
        """A kernel source's nvcc wall (0 when its library was built
        before this process)."""
        with self._lock:
            self.builds[source] = {"wall_s": round(wall_s, 3), "cached": cached,
                                   "t": self._t()}
        self._flush()

    def note_recovery(self, action: str, window: int, attempt: int, fault: str,
                      detail: str = "", ok: bool | None = None) -> None:
        """One recovery-ladder transition (obs/recovery.py)."""
        row = {"action": action, "window": window, "attempt": attempt, "fault": fault,
               "detail": detail[:200], "t": self._t()}
        if ok is not None:
            row["ok"] = ok
        with self._lock:
            self.recovery.append(row)
        self._flush()

    def note_repair(self, action: str, chunk: int = -1, kept: int = 0, dropped: int = 0,
                    bytes_quarantined: int = 0, applied: bool = True,
                    detail: str = "") -> None:
        """One store repair (storage/repair.py); `applied=False` marks a
        dry run's would-repair row."""
        with self._lock:
            self.repairs.append({
                "action": action, "chunk": chunk, "kept": kept, "dropped": dropped,
                "bytes_quarantined": bytes_quarantined, "applied": applied,
                "detail": detail[:200], "t": self._t(),
            })
        self._flush()

    def note(self, msg: str) -> None:
        with self._lock:
            self.notes.append(f"[{time.monotonic() - self.t0:.1f}s] {msg[:200]}")
        self._flush()

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        with self._lock:
            stages = {k: dict(v) for k, v in self.stages.items()}
            builds = {k: dict(v) for k, v in self.builds.items()}
            return {
                "elapsed_s": round(time.monotonic() - self.t0, 1),
                "compile_total_s": round(max((v["wall_s"] for v in builds.values()),
                                             default=0.0), 1),
                "n_stages": len(stages),
                "stages": stages,
                "builds": builds,
                "recovery": [dict(r) for r in self.recovery],
                "repairs": [dict(r) for r in self.repairs],
                "notes": list(self.notes),
            }

    def _flush(self) -> None:
        """Rewrite the report at `path` (when set) by tmp + rename."""
        path = self.path
        if not path:
            return
        try:
            with self._flush_lock:
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(self.report(), f)
                os.replace(tmp, path)
        except OSError:
            pass  # forensics are best-effort: a full disk never breaks the replay

    def reset(self) -> None:
        with self._lock:
            self.t0 = time.monotonic()
            self.stages.clear()
            self.builds.clear()
            self.recovery.clear()
            self.repairs.clear()
            self.notes.clear()


WARMUP = WarmupRecorder()


def read_report(path: str) -> dict | None:
    """A (possibly mid-crash) warmup report; None when absent or
    unreadable."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
