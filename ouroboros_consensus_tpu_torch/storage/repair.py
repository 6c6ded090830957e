"""The store's repair plane: quarantine and the repair rows.

Reference: ImmutableDB startup validation truncates corrupted tails on
disk (ImmutableDB/Impl/Validation.hs:67); the JAX package's
storage/repair.py is the port's reference. Every on-disk repair the
ImmutableDB takes (or, read-only, would take):

  * **Quarantine, never delete**: snipped chunk tails, dropped chunk
    files and swept orphans are MOVED into ``<immutable>/quarantine/``
    before the live file changes, so a wrong repair loses nothing.
  * **Every action a row** (`note_repair`): the open's `repairs` list,
    counted by `count_actions`. A read-only scan's rows carry
    ``applied=False``.

Actions:

    truncate-chunk        a chunk's corrupted tail was cut on disk
    rebuild-index         an index was rebuilt from the chunk's bytes
    drop-chunk            a wholly corrupt chunk (or one stranded past a
                          truncation) was removed
    sweep-orphan-index    an index file without a chunk was removed
    sweep-orphan-sidecar  a sidecar without a live chunk (or a sidecar
                          tmp left by a crash mid-build) was removed
    dirty-open-escalated  a missing clean-shutdown marker escalated the
                          open to all chunks with repair
"""

from __future__ import annotations

import os

REPAIR_ACTIONS = (
    "truncate-chunk",
    "rebuild-index",
    "drop-chunk",
    "sweep-orphan-index",
    "sweep-orphan-sidecar",
    "dirty-open-escalated",
)

QUARANTINE_DIR = "quarantine"


class QuarantineError(Exception):
    """The quarantine copy could not be made (ENOSPC, an unwritable
    quarantine directory): the repair refuses rather than destroy bytes
    it promised to keep. REFUSE in `node/exit.triage`."""


def note_repair(action: str, chunk: int = -1, kept: int = 0,
                dropped: int = 0, bytes_quarantined: int = 0,
                applied: bool = True, detail: str = "") -> dict:
    """One repair action as a row (the reference's note_repair): the
    ImmutableDB keeps the rows of an open on its `repairs`, and
    `count_actions` counts them; the row goes into the warmup report
    (`WARMUP.note_repair`) and, as a `RepairEvent`, through the batch
    tracer (`oct_repair_total{action=}` counts the applied ones)."""
    from ..obs.warmup import WARMUP
    from ..protocol import batch as pbatch

    row = {
        "action": action,
        "chunk": chunk,
        "kept": kept,
        "dropped": dropped,
        "bytes_quarantined": bytes_quarantined,
        "applied": applied,
        "detail": detail[:200],
    }
    WARMUP.note_repair(action=action, chunk=chunk, kept=kept, dropped=dropped,
                       bytes_quarantined=bytes_quarantined, applied=applied, detail=detail)
    tracer = pbatch.BATCH_TRACER
    if tracer is not None:
        from ..utils.trace import RepairEvent

        tracer(RepairEvent(action=action, chunk=chunk, blocks_kept=kept, blocks_dropped=dropped,
                           bytes_quarantined=bytes_quarantined, applied=applied,
                           detail=detail[:200]))
    return row


def count_actions(rows, applied_only: bool = True) -> dict:
    """``{action: count}`` over repair rows: revalidate's applied
    counts, and db_truncater's report (``applied_only=False``: a dry
    run counts its would-repair rows too)."""
    counts: dict = {}
    for row in rows or ():
        if not isinstance(row, dict):
            continue
        if applied_only and not row.get("applied", True):
            continue
        a = row.get("action", "?")
        counts[a] = counts.get(a, 0) + 1
    return counts


class Quarantine:
    """Holds snipped bytes under ``<store>/quarantine/`` instead of
    deleting them. Names collide across repeated repairs of the same
    chunk, so a numeric suffix keeps every generation."""

    def __init__(self, store_path: str, fs, directory: str | None = None):
        self.fs = fs
        self.path = (directory if directory is not None
                     else os.path.join(store_path, QUARANTINE_DIR))
        self._made = False

    def _fresh_target(self, name: str) -> str:
        """Lazy-mkdir the quarantine dir and pick a collision-free
        target path (numeric suffix keeps every generation)."""
        if not self._made:
            self.fs.makedirs(self.path)
            self._made = True
        target = os.path.join(self.path, name)
        suffix = 0
        while self.fs.exists(target):
            suffix += 1
            target = os.path.join(self.path, f"{name}.{suffix}")
        return target

    def store(self, name: str, data: bytes) -> int:
        """Write `data` under a fresh quarantine name; returns the byte
        count banked (0 on empty data). A write failure raises
        `QuarantineError` — callers MUST quarantine before they mutate,
        so the failed copy aborts the repair instead of turning it into
        the deletion this module exists to prevent."""
        if not data:
            return 0
        try:
            self.fs.write_bytes(self._fresh_target(name), data)
            return len(data)
        except OSError as exc:
            raise QuarantineError(
                f"cannot quarantine {name!r} under {self.path}: {exc}"
            ) from exc

    def store_file(self, name: str, src_path: str) -> int:
        """MOVE a whole live file into quarantine (atomic rename —
        O(1), no bytes through memory; the drop/sweep path, where the
        original leaves the store anyway). Same collision-suffix and
        refusal semantics as `store`."""
        try:
            size = self.fs.getsize(src_path)
            self.fs.replace(src_path, self._fresh_target(name))
            return size
        except OSError as exc:
            raise QuarantineError(
                f"cannot quarantine {name!r} under {self.path}: {exc}"
            ) from exc
