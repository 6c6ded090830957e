"""The self-healing replay: crash-consistent checkpoints and the
supervised recovery ladder.

The JAX package's obs/recovery.py is the port's reference, in its two
halves; the port takes keywords where it reads its environment.

**Checkpoint/resume.** `revalidate(checkpoint=path)` arms a
`ProgressWriter` (`arm_writer`); the window loops of
`batch.validate_chain` call `note_window` as each window retires, which
rewrites a small JSON record (the chain position, the whole PraosState
and a digest over both) by tmp + rename, so a kill mid-write leaves the
previous record. `revalidate(resume=True, checkpoint=path)` reads it
back (`resume_record`: the digest must hold, the record must belong to
this chain by `chain_tag`, must not be complete and must have retired a
window), seeds the fold from its state and skips the headers it
vouches for. The record's schema and digest are the reference's, field
for field. A replay that completes (cleanly or at a validation error)
marks its record complete, so a later resume never skips a fresh run's
work.

**The supervisor.** A window whose staging, dispatch, wait or epilogue
raises a RECOVER-class error (node/exit.py: failed launches, CUDA
errors, I/O, the chaos faults) is validated again, alone, by the rungs
of its backend's ladder until one returns; its result is the window's:

    device   retry         the window's own path again (validate_batch,
                           staged anew from its host columns), after a
                           jittered backoff
             stage-split   the five per-lane stage kernels, no aggregate
    native   retry         the C++ verifier again
             host-reference the exact per-header fold (`host_reference_fold`)

The device ladder has no host rung: a window that exhausts it re-raises
its last error (a failed launch raises with no fallback). A sticky CUDA
error fails both rungs; its recovery is the checkpoint and a new
process. Every transition is a `RecoveryEvent` on the supervisor
(`events`, `counts`), which revalidate puts on its result. Recovery runs
are not re-dispatches: they never count in `batch.AGG_REDISPATCH`.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass

SCHEMA_VERSION = 1

LADDERS = {
    "device": ("retry", "stage-split"),
    "native": ("retry", "host-reference"),
}


# ---------------------------------------------------------------------------
# PraosState <-> JSON (the progress record)
# ---------------------------------------------------------------------------


def _hx(b: bytes | None) -> str | None:
    return b.hex() if b is not None else None


def _unhx(s: str | None) -> bytes | None:
    return bytes.fromhex(s) if s is not None else None


def encode_state(st) -> dict:
    """PraosState -> a JSON-safe dict: the whole sequential fold state.
    The device nonce carry is not in it: a resume seeds the fold from
    this host state."""
    return {
        "last_slot": st.last_slot,
        "ocert_counters": {k.hex(): int(v) for k, v in sorted(st.ocert_counters.items())},
        "evolving_nonce": _hx(st.evolving_nonce),
        "candidate_nonce": _hx(st.candidate_nonce),
        "epoch_nonce": _hx(st.epoch_nonce),
        "lab_nonce": _hx(st.lab_nonce),
        "last_epoch_block_nonce": _hx(st.last_epoch_block_nonce),
    }


def decode_state(d: dict):
    from ..protocol.praos import PraosState

    return PraosState(
        last_slot=d.get("last_slot"),
        ocert_counters={bytes.fromhex(k): int(v)
                        for k, v in (d.get("ocert_counters") or {}).items()},
        evolving_nonce=_unhx(d.get("evolving_nonce")),
        candidate_nonce=_unhx(d.get("candidate_nonce")),
        epoch_nonce=_unhx(d.get("epoch_nonce")),
        lab_nonce=_unhx(d.get("lab_nonce")),
        last_epoch_block_nonce=_unhx(d.get("last_epoch_block_nonce")),
    )


def _digest(chain_tag_: str, headers: int, windows: int, state: dict) -> str:
    """The digest over everything a resume trusts: a torn or edited
    record fails closed (a fresh start), never a wrong seed."""
    blob = json.dumps({"chain_tag": chain_tag_, "headers": headers, "windows": windows,
                       "state": state}, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.blake2s(blob, digest_size=16).hexdigest()


def chain_tag(db_path: str, params) -> str:
    """The replay a record belongs to: the chain's path and the protocol
    parameters; a record of another chain is ignored on resume."""
    blob = f"{os.path.abspath(db_path)}|{params!r}".encode()
    return hashlib.blake2s(blob, digest_size=8).hexdigest()


# ---------------------------------------------------------------------------
# ProgressWriter: the record rewritten as each window retires
# ---------------------------------------------------------------------------


class ProgressWriter:
    """The chain position across validate_chain calls (revalidate makes
    one an epoch segment) and the record, rewritten atomically as each
    window retires."""

    def __init__(self, path: str, chain_tag_: str, headers: int = 0, windows: int = 0):
        self.path = path
        self.chain_tag = chain_tag_
        self._lock = threading.Lock()
        self.headers = headers
        self.windows = windows

    def note(self, state, n_new: int) -> None:
        with self._lock:
            self.headers += int(n_new)
            self.windows += 1
            self._write(state, complete=False, error=None)

    def finalize(self, state, error=None) -> None:
        """The replay ended (cleanly or at a validation error): mark the
        record complete."""
        with self._lock:
            self._write(state, complete=True,
                        error=None if error is None else repr(error)[:200])

    def _write(self, state, complete: bool, error) -> None:
        enc = encode_state(state)
        doc = {
            "schema": SCHEMA_VERSION,
            "kind": "oct-checkpoint",
            "chain_tag": self.chain_tag,
            "headers": self.headers,
            "windows": self.windows,
            "state": enc,
            "digest": _digest(self.chain_tag, self.headers, self.windows, enc),
            "complete": complete,
            "error": error,
            "pid": os.getpid(),
            "ts_unix": time.time(),
        }
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # a checkpoint is best-effort: it never breaks the replay


_WRITER: ProgressWriter | None = None


def arm_writer(path: str | None, chain_tag_: str, resumed_headers: int = 0,
               resumed_windows: int = 0) -> ProgressWriter | None:
    """Mount the process's checkpoint writer at `path` (None disarms).
    A resume passes its record's position, so that the count stays
    anchored at genesis."""
    global _WRITER
    _WRITER = (None if path is None
               else ProgressWriter(path, chain_tag_, resumed_headers, resumed_windows))
    return _WRITER


def disarm_writer() -> None:
    global _WRITER
    _WRITER = None


def note_window(state, n_new: int) -> None:
    """The retire seam of the window loops: one None check when no
    checkpoint is armed."""
    w = _WRITER
    if w is not None:
        w.note(state, n_new)


def read_checkpoint(path: str | None) -> dict | None:
    """A record, integrity-checked; None when absent, torn, of another
    schema or with a digest that does not hold."""
    if not path:
        return None
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("kind") != "oct-checkpoint":
        return None
    if doc.get("schema") != SCHEMA_VERSION:
        return None
    try:
        want = _digest(doc["chain_tag"], doc["headers"], doc["windows"], doc["state"])
    except (KeyError, TypeError):
        return None
    if doc.get("digest") != want:
        return None
    return doc


def resume_record(chain_tag_: str, path: str | None) -> dict | None:
    """The record a replay of `chain_tag_` may resume from: valid, of
    this chain, not complete, with at least one retired header."""
    doc = read_checkpoint(path)
    if doc is None or doc.get("complete"):
        return None
    if doc.get("chain_tag") != chain_tag_:
        return None
    if not doc.get("headers"):
        return None
    return doc


# ---------------------------------------------------------------------------
# RecoverySupervisor: the in-process ladder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RecoveryEvent:
    """One ladder transition: a rung tried, "recovered", "exhausted", or
    the reader's "chunk-reread"."""

    action: str
    window: int
    lanes: int
    attempt: int
    fault: str
    detail: str
    ok: bool | None = None


def recoverable(exc: BaseException) -> bool:
    """Only RECOVER-class faults ride the ladder (node/exit.triage):
    refusals, on-disk corruption and programming errors surface raw."""
    from ..node import exit as node_exit

    return node_exit.triage(exc) is node_exit.Disposition.RECOVER


def recovery_event(action: str, window: int, lanes: int, attempt: int,
                   exc: BaseException, ok: bool | None = None) -> RecoveryEvent:
    return RecoveryEvent(action, window, lanes, attempt, type(exc).__name__,
                         repr(exc)[:200], ok)


class RecoverySupervisor:
    """Runs a failing window down LADDERS[backend]. `enabled=False`
    re-raises every error as it came (the revalidate keyword
    `recovery=False`); `backoff_s` is the base of the retry rung's
    jittered sleep (the jitter from the chaos plan's seeded RNG when one
    is armed); `sleep` is injectable for tests."""

    def __init__(self, backoff_s: float = 0.05, sleep=time.sleep, enabled: bool = True):
        self.backoff_s = backoff_s
        self.sleep = sleep
        self.enabled = enabled
        self.episodes = 0
        self.recovered = 0
        self.events: list[RecoveryEvent] = []
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def note(self, ev: RecoveryEvent) -> None:
        with self._lock:
            self.events.append(ev)
            self.counts[ev.action] = self.counts.get(ev.action, 0) + 1

    def _run_rung(self, rung: str, params, ticked, hvs, backend: str, device, aggregate):
        from ..protocol import batch as pbatch

        redispatched = pbatch.AGG_REDISPATCH
        try:
            return self._rung(pbatch, rung, params, ticked, hvs, backend, device, aggregate)
        finally:
            pbatch.AGG_REDISPATCH = redispatched  # a rung is not a re-dispatch

    @staticmethod
    def _rung(pbatch, rung, params, ticked, hvs, backend, device, aggregate):
        if rung == "retry":
            return pbatch.validate_batch(params, ticked, hvs, backend, device, None, aggregate)
        if rung == "stage-split":
            return pbatch.validate_batch(params, ticked, hvs, "device", device, None, False)
        if rung == "host-reference":
            return host_reference_fold(params, ticked, hvs)
        raise ValueError(f"unknown recovery rung {rung!r}")

    def recover_window(self, params, ticked, hvs, exc: BaseException, backend: str = "device",
                       device=None, aggregate: bool = True, window: int = -1):
        """One failing window -> its BatchResult, or `exc` re-raised
        (supervisor disabled, a class the ladder may not absorb), or the
        last rung's error re-raised when every rung failed."""
        if not self.enabled or not recoverable(exc):
            raise exc
        from ..testing import chaos

        lanes = len(hvs)
        self.episodes += 1
        last: BaseException = exc
        ladder = LADDERS[backend]
        for attempt, rung in enumerate(ladder, start=1):
            self.note(recovery_event(rung, window, lanes, attempt, last))
            if rung == "retry" and self.backoff_s > 0:
                self.sleep(self.backoff_s * chaos.jitter())
            try:
                res = self._run_rung(rung, params, ticked, hvs, backend, device, aggregate)
            except Exception as e:  # noqa: BLE001 — the next rung
                last = e
                continue
            self.recovered += 1
            self.note(recovery_event("recovered", window, lanes, attempt, exc, ok=True))
            return res
        self.note(recovery_event("exhausted", window, lanes, len(ladder), last, ok=False))
        raise last

    def reread_chunk(self, read, chunk: int, exc: BaseException) -> bytes:
        """The reader's one re-read of a chunk whose read failed with a
        RECOVER-class error (db_analyser's chunk seam); a second failure
        propagates."""
        if not self.enabled or not recoverable(exc):
            raise exc
        self.note(recovery_event("chunk-reread", chunk, 0, 1, exc))
        data = read()
        self.note(recovery_event("recovered", chunk, 0, 1, exc, ok=True))
        return data


def host_reference_fold(params, ticked, hvs):
    """The native ladder's floor: the window folded one header at a time,
    each a one-header window of the C++ verifier with its exact
    epilogue, ticking between headers: the sequential reference fold,
    with no batching and no device."""
    from ..protocol import batch as pbatch
    from ..protocol import praos
    from ..protocol.views import ViewColumns

    views = hvs.views() if isinstance(hvs, ViewColumns) else list(hvs)
    st = ticked.state
    t = ticked
    for i, hv in enumerate(views):
        if i:
            t = praos.tick(params, ticked.ledger_view, hv.slot, st)
        res = pbatch.validate_batch(params, t, [hv], "native", None)
        if res.error is not None:
            return pbatch.BatchResult(st, i, res.error)
        st = res.state
    return pbatch.BatchResult(st, len(views), None)
