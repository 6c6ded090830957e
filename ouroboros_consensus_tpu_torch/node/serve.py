"""Follow-the-tip serving plane: many peers' candidate suffixes batched
into shared packed windows.

A node that follows the tip does not replay one long chain: it validates
the short candidate suffixes that many peers push at once (ChainSync
feeding ChainSel). One window per peer would pad every window to the
smallest bucket and pay the whole dispatch per peer. This module batches
instead, with the reference's algorithm (the JAX package's
node/serve.py):

  * every peer (tenant) owns a FIFO of candidate suffixes and its own
    sequential fold state (PraosState: nonce carry and OCert counters);
  * one scheduler thread (`pump`) picks a window shape that has pending
    lanes (a round-robin cursor over the shapes), fills ONE shared
    window from its tenants by a rotating quantum fill, and dispatches
    it through the replay's window path (`batch.prepare_window` into a
    staging buffer the service owns, `dispatch_prepared`, `materialize`:
    every kernel of the replay, the window aggregate on bc windows);
  * every per-lane check depends only on (params, ledger view, epoch
    nonce, header bytes); the only cross-lane state is the sequential
    fold, which runs per tenant: each tenant's segment of a shared
    window is sliced out of the per-lane verdicts (`PackedVerdicts.full`,
    after a dirty aggregated window's re-dispatch) and folded against
    that tenant's own state, so no lane can bleed into another tenant's
    verdict. A shared window's nonce carry is never read. A window of
    one tenant chains the device nonce fold from that tenant's state
    (`batch.state_carry`), as the replay chains its windows;
  * a tenant's verdict is its first failure (`SuffixVerdict`): headers
    after it are discarded unexamined;
  * a window whose staging or dispatch raises a RECOVER-class error
    sheds each of its tenant segments down the device ladder
    (obs/recovery.RecoverySupervisor: retry, then stage-split, both on
    the card); the episode opens a degraded interval on the SLO surface
    that two clean windows close. The port's device ladder has no host
    floor: a fault that outlasts it raises out of `pump`;
  * `plane="host"` serves every window by the per-tenant host reference
    fold (obs/recovery.host_reference_fold: the C++ verifier a header at
    a time; no staging, no device). The caller picks it; the device
    plane never drops to it on its own;
  * `checkpoint=<file>` rewrites a progress record as each window
    retires (tmp + rename through the fs seam, with a digest; read fail
    closed), so that a killed service relaunched on the same file
    resumes every tenant's fold state and banked verdicts: seeded
    traffic (testing/traffic.py) regenerates byte-identically and
    `submit` fast-forwards past the suffixes already banked.

The SLO surface is `slo_snapshot()`: p50/p99 verdict latency, aggregate
headers/s, queue depths, the degraded flag and its intervals; served
by obs/server.py's `/slo` route."""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve
from ..obs import recovery as _recovery
from ..obs import registry as _registry
from ..protocol import batch as pbatch
from ..protocol import praos
from ..protocol.admission import PLANES, AdmissionPolicy, AdmissionRefused, WindowShape, shape_of
from ..testing import chaos
from ..utils.fs import RealFS

__all__ = [
    "SuffixVerdict", "Tenant", "ValidationService", "read_serve_checkpoint",
]

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class SuffixVerdict:
    """One resolved candidate suffix: how many of its headers extended
    the tenant's chain, and the first-failure error (None: the whole
    suffix was valid)."""

    tenant_id: str
    seq: int
    n_valid: int
    error: str | None

    def row(self) -> list:
        """The comparable form (the checkpoint, and the byte-identity
        checks across the device, host and degraded paths)."""
        return [self.seq, self.n_valid, self.error]


def _canon_error(err) -> str | None:
    """Class name and message: the same across the device epilogue,
    every recovery rung and the host fold, which raise the same error
    classes with the same arguments."""
    if err is None:
        return None
    return f"{type(err).__name__}: {err}"


@dataclass
class _Job:
    """One queued candidate suffix; `offset`: its headers already folded
    into the tenant's state (a suffix may span several windows)."""

    seq: int
    hvs: tuple
    shape: WindowShape
    offset: int = 0
    t_submit: float = 0.0


@dataclass
class Tenant:
    """One peer's server-side lane: fold state, suffix FIFO and resolved
    verdicts. Mutated on the scheduler thread (pump) or under the
    service lock."""

    tenant_id: str
    state: praos.PraosState
    queue: deque = field(default_factory=deque)
    verdicts: list = field(default_factory=list)
    seen: int = 0  # suffixes ever submitted (the resume fast-forward key)
    done: int = 0  # suffixes finalized (verdict banked)
    headers_done: int = 0
    resume_offset: int = 0  # of suffix `done`, folded before a relaunch

    def pending_headers(self) -> int:
        return sum(len(j.hvs) - j.offset for j in self.queue)


def _doc_digest(doc: dict) -> str:
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.blake2s(blob, digest_size=16).hexdigest()


def read_serve_checkpoint(path: str | None, fs=None) -> dict | None:
    """A serve progress record, integrity-checked; None when absent,
    torn, of another schema or with a digest that does not hold (fail
    closed: a fresh start is always correct, a wrong re-seed never is)."""
    if not path:
        return None
    fs = fs if fs is not None else RealFS()
    try:
        doc = json.loads(fs.read_bytes(path).decode("utf-8"))
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("kind") != "oct-serve-checkpoint":
        return None
    if doc.get("schema") != SCHEMA_VERSION:
        return None
    digest = doc.get("digest")
    body = {k: v for k, v in doc.items() if k != "digest"}
    if digest != _doc_digest(body):
        return None
    return doc


class ValidationService:
    """The long-lived serving plane: tenants `submit()` candidate
    suffixes, `pump()` runs one scheduling step (fill one shared window,
    dispatch, scatter the verdicts), `run_until_drained()` loops it. One
    scheduler thread owns pump(); `submit`, `register`, `verdicts` and
    `slo_snapshot` may be called from other threads (the service lock
    guards the tenants and the intervals).

    `plane`: "device" (the card's window path; `device`, None: the CUDA
    card, raising without one) or "host" (the per-tenant host reference
    fold). `aggregate`: bc windows take the window aggregate, as
    `revalidate`'s default. `checkpoint`: the progress record's path
    (None: none). `supervisor`: the RecoverySupervisor a faulted window
    sheds to (None: one of its own). `fs`: the checkpoint's fs seam."""

    def __init__(self, params, lview, eta0: bytes, *, plane: str = "device", device=None,
                 aggregate: bool = True, registry=None, max_window: int = 256,
                 checkpoint: str | None = None, supervisor=None, fs=None):
        if plane not in PLANES:
            raise ValueError(f"unknown serving plane {plane!r} (know {', '.join(PLANES)})")
        self.params = params
        self.lview = lview
        self.eta0 = eta0
        self.plane = plane
        self.device = resolve(device) if plane == "device" else None
        self.aggregate = aggregate
        self.registry = (registry if registry is not None
                         else _registry.default_registry())
        self.policy = AdmissionPolicy(plane)
        self.max_window = max(1, int(max_window))
        self.checkpoint = checkpoint
        self.fs = fs if fs is not None else RealFS()
        self.supervisor = (supervisor if supervisor is not None
                           else _recovery.RecoverySupervisor())
        # the traffic a record belongs to: a record of other parameters or
        # another epoch nonce is not resumed
        self.serve_tag = hashlib.blake2s(f"{params!r}|{eta0.hex()}".encode(),
                                         digest_size=8).hexdigest()
        self._lock = threading.Lock()
        self.tenants: dict[str, Tenant] = {}  # guarded-by: _lock
        self.windows = 0  # guarded-by: _lock
        self.lanes = 0  # lanes dispatched over the windows — guarded-by: _lock
        # headers pending across the queues, kept as submits and windows
        # change it (the gauge is set on every submit, so a sum over the
        # tenants there would cost O(tenants) a submit) — guarded-by: _lock
        self._pending = 0
        self.degraded = False  # guarded-by: _lock
        # [t_open, t_close | None, fault class] — guarded-by: _lock
        self.degraded_intervals: list[list] = []
        self._clean_streak = 0
        self._rr = 0  # the window fill's rotation cursor (scheduler thread)
        self._buffers: dict[WindowShape, torch.Tensor] = {}  # scheduler thread
        self.resumed = False
        self._t0 = time.monotonic()
        r = self.registry
        self._m_suffixes = r.counter(
            "oct_serve_suffixes_total",
            "candidate suffixes resolved by the serving plane",
            ("result",),
        )
        self._m_headers = r.counter(
            "oct_serve_headers_total",
            "headers validated by the serving plane",
        )
        self._m_windows = r.counter(
            "oct_serve_windows_total",
            "shared serving windows retired", ("mode",),
        )
        self._m_degraded = r.gauge(
            "oct_serve_degraded",
            "1 while serving rides the recovery ladder (degraded mode)",
        )
        self._m_queue = r.gauge(
            "oct_serve_queue_depth",
            "pending headers across all tenant queues",
        )
        self._m_latency = r.histogram(
            "oct_serve_verdict_latency_seconds",
            "submit->verdict wall per candidate suffix",
        )
        if self.checkpoint:
            self._try_resume()

    # -- tenants ------------------------------------------------------------

    def register(self, tenant_id: str, state=None) -> Tenant:
        """Idempotent: an existing tenant is returned unchanged (its fold
        state is the server's truth, not the caller's)."""
        with self._lock:
            t = self.tenants.get(tenant_id)
            if t is None:
                if state is None:
                    state = praos.PraosState(epoch_nonce=self.eta0)
                t = Tenant(tenant_id, state)
                self.tenants[tenant_id] = t
            return t

    def submit(self, tenant_id: str, hvs) -> int:
        """Enqueue one candidate suffix -> its per-tenant sequence
        number. A malformed suffix raises AdmissionRefused at the door
        (nothing else is touched). After a resume, suffixes whose
        verdicts are already banked are fast-forwarded."""
        t = self.register(tenant_id)
        try:
            shape = shape_of(tenant_id, hvs)
        except AdmissionRefused:
            self._m_suffixes.labels(result="refused").inc()
            raise
        with self._lock:
            seq = t.seen
            t.seen += 1
            if seq < t.done:
                return seq  # verdict banked before the relaunch
            job = _Job(seq, tuple(hvs), shape, t_submit=time.monotonic())
            if seq == t.done and t.resume_offset:
                # the killed process folded a prefix of this suffix: its
                # headers are already in the restored state
                job.offset = min(t.resume_offset, len(job.hvs))
                t.resume_offset = 0
            t.queue.append(job)
            self._pending += len(job.hvs) - job.offset
        self._update_queue_gauge()
        return seq

    def verdicts(self, tenant_id: str) -> list:
        with self._lock:
            t = self.tenants.get(tenant_id)
            return list(t.verdicts) if t is not None else []

    # -- the scheduler ------------------------------------------------------

    def pump(self) -> bool:
        """One scheduling step: pick a window shape with pending lanes,
        fill ONE shared window fairly across its tenants, dispatch,
        scatter the per-tenant verdicts. False when no tenant has
        pending work."""
        with self._lock:
            groups: dict[WindowShape, list[Tenant]] = {}
            for t in self.tenants.values():
                if t.queue:
                    groups.setdefault(t.queue[0].shape, []).append(t)
            if not groups:
                return False
            shapes = sorted(groups, key=lambda s: (s.proof_len, s.body_len))
            shape = shapes[self._rr % len(shapes)]
            tenants = groups[shape]
            order = (tenants[self._rr % len(tenants):]
                     + tenants[:self._rr % len(tenants)])
            self._rr += 1
            pending = sum(len(t.queue[0].hvs) - t.queue[0].offset for t in order)
        decision = self.policy.admit(shape, min(pending, self.max_window))
        cap = min(decision.lane_cap, self.max_window)
        # fair fill: rotating passes granting up to one quantum a tenant a
        # pass until the window is full or the shape drains
        takes = {t.tenant_id: 0 for t in order}
        avail = {t.tenant_id: len(t.queue[0].hvs) - t.queue[0].offset for t in order}
        quantum = max(1, cap // max(1, len(order)))
        space = cap
        while space > 0:
            progressed = False
            for t in order:
                room = min(avail[t.tenant_id] - takes[t.tenant_id], quantum, space)
                if room > 0:
                    takes[t.tenant_id] += room
                    space -= room
                    progressed = True
            if not progressed:
                break
        whvs: list = []
        segments: list[tuple] = []  # (tenant, job, lo, hi)
        for t in order:
            n = takes[t.tenant_id]
            if not n:
                continue
            job = t.queue[0]
            lo = len(whvs)
            whvs.extend(job.hvs[job.offset:job.offset + n])
            segments.append((t, job, lo, lo + n))
        if not whvs:
            return False
        results, fault = self._run_window(whvs, segments, shape, self.windows)
        self._m_windows.labels(mode=decision.mode).inc()
        with self._lock:
            for (t, job, _lo, _hi), res in zip(segments, results):
                t.state = res.state
                t.headers_done += res.n_valid
                job.offset += res.n_valid
                self._pending -= res.n_valid
                self._m_headers.inc(res.n_valid)
                if res.error is not None:
                    self._finalize(t, job, res.error)
                elif job.offset >= len(job.hvs):
                    self._finalize(t, job, None)
            self.windows += 1
            self.lanes += len(whvs)
            self._note_fault(fault)
        self._update_queue_gauge()
        self._write_checkpoint()
        # the record of THIS window is durable before the kill seam fires
        chaos.fire("serve")
        return True

    def run_until_drained(self, max_windows: int = 100_000) -> int:
        n = 0
        while n < max_windows and self.pump():
            n += 1
        return n

    # -- one window ---------------------------------------------------------

    def _buffer(self, shape: WindowShape) -> torch.Tensor:
        """The shape's staging buffer, sized for `max_window` lanes
        (pinned on the card). One window is in flight at a time, and its
        verdict words are read (behind the upload) before the next one
        is staged, so a buffer is reused window after window."""
        buf = self._buffers.get(shape)
        if buf is None:
            n = pbatch.packed_bytes_bound(self.max_window, shape.body_len,
                                          self.params.kes_depth)
            buf = torch.empty(n, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._buffers[shape] = buf
        return buf

    def _run_window(self, whvs, segments, shape: WindowShape, widx: int):
        """Dispatch one shared window and fold each tenant segment -> (the
        segments' BatchResults, the fault that shed them or None). A
        RECOVER-class fault sheds each segment down the device ladder
        (each rung a full validation of the segment, so the verdicts are
        the same); any other error, and a fault the ladder cannot absorb,
        raises."""
        if self.plane == "host":
            return self._host_window(whvs, segments), None
        try:
            # the serving dispatch seam (device-error@serve-dispatch:N)
            # fires before the staging: a faulted window sheds whole
            # segments, never half-built state
            chaos.fire("serve-dispatch")
            sw = pbatch.prepare_window(self.params, self.lview, self.eta0, whvs,
                                       self._buffer(shape))
            solo = len(segments) == 1
            # a window of one tenant chains the fold from its state; a
            # shared window's carry is never read
            carry = pbatch.state_carry(segments[0][0].state) if solo else None
            v = pbatch.materialize(pbatch.dispatch_prepared(
                sw._replace(aggregate=self.aggregate), self.device, carry))
            if solo:
                t = segments[0][0]
                ticked = praos.tick(self.params, self.lview, whvs[0].slot, t.state)
                return [pbatch.epilogue(self.params, ticked, whvs, sw.pre, v)], None
            full = v.full()
            return [self._segment_epilogue(t, whvs, sw.pre, full, lo, hi)
                    for t, _job, lo, hi in segments], None
        except Exception as exc:  # noqa: BLE001 — the supervisor triages:
            # it absorbs RECOVER-class faults only and re-raises the rest
            results = []
            for t, _job, lo, hi in segments:
                seg = list(whvs[lo:hi])
                ticked = praos.tick(self.params, self.lview, seg[0].slot, t.state)
                results.append(self.supervisor.recover_window(
                    self.params, ticked, seg, exc, "device", self.device, self.aggregate,
                    widx))
            return results, exc

    def _segment_epilogue(self, tenant, whvs, pre, full, lo, hi):
        """One tenant's slice of a shared window: the positional
        HostChecks and per-lane Verdicts columns cut to its segment, then
        the sequential fold against that tenant's state (the only
        stateful step, so no lane of another tenant can reach it)."""
        seg = list(whvs[lo:hi])
        ticked = praos.tick(self.params, self.lview, seg[0].slot, tenant.state)
        pre_t = pbatch.HostChecks(
            kes_window_errors=list(pre.kes_window_errors[lo:hi]),
            vrf_lookup_errors=list(pre.vrf_lookup_errors[lo:hi]),
            kes_evolution=np.asarray(pre.kes_evolution)[lo:hi],
        )
        v_t = pbatch.Verdicts(*(np.asarray(col)[lo:hi] for col in full))
        return pbatch.epilogue(self.params, ticked, seg, pre_t, v_t)

    def _host_window(self, whvs, segments):
        """The host plane: each tenant segment by the host reference fold
        (no staging, no device)."""
        results = []
        for t, _job, lo, hi in segments:
            seg = list(whvs[lo:hi])
            ticked = praos.tick(self.params, self.lview, seg[0].slot, t.state)
            results.append(_recovery.host_reference_fold(self.params, ticked, seg))
        return results

    # -- bookkeeping (callers hold self._lock where noted) -------------------

    def _finalize(self, tenant, job, error) -> None:
        # caller holds self._lock
        tenant.queue.popleft()
        tenant.done += 1
        self._pending -= len(job.hvs) - job.offset  # discarded unexamined
        err = _canon_error(error)
        tenant.verdicts.append(SuffixVerdict(tenant.tenant_id, job.seq, job.offset, err))
        self._m_suffixes.labels(result="valid" if err is None else "invalid").inc()
        if job.t_submit:
            self._m_latency.observe(time.monotonic() - job.t_submit)

    def _note_fault(self, fault) -> None:
        # caller holds self._lock
        now = time.monotonic() - self._t0
        if fault is not None:
            self._clean_streak = 0
            if not self.degraded:
                self.degraded = True
                self.degraded_intervals.append([now, None, type(fault).__name__])
                self._m_degraded.set(1)
            return
        self._clean_streak += 1
        if self.degraded and self._clean_streak >= 2:
            # two clean windows in a row close the degraded interval
            self.degraded = False
            self.degraded_intervals[-1][1] = now
            self._m_degraded.set(0)

    def _update_queue_gauge(self) -> None:
        with self._lock:
            depth = self._pending
        self._m_queue.set(depth)

    # -- the SLO surface -----------------------------------------------------

    def slo_snapshot(self) -> dict:
        """The live SLO document (obs/server.py `/slo`): verdict-latency
        tails, aggregate throughput, queue depths, degraded state and the
        admission decisions."""
        with self._lock:
            headers = sum(t.headers_done for t in self.tenants.values())
            depths = [t.pending_headers() for t in self.tenants.values()]
            doc = {
                "kind": "oct-serve-slo",
                "schema": SCHEMA_VERSION,
                "serve_tag": self.serve_tag,
                "tenants": len(self.tenants),
                "windows": self.windows,
                "headers": headers,
                "suffixes_done": sum(t.done for t in self.tenants.values()),
                "queue_depth": sum(depths),
                "queue_depth_max": max(depths, default=0),
                "degraded": self.degraded,
                "degraded_intervals": [list(iv) for iv in self.degraded_intervals],
                "resumed": self.resumed,
            }
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        doc["headers_per_s"] = headers / elapsed
        doc["verdict_latency_p50_s"] = self._m_latency.quantile(0.5)
        doc["verdict_latency_p99_s"] = self._m_latency.quantile(0.99)
        doc["admission"] = dict(self.policy.decisions)
        doc["device_serving"] = self.plane == "device"
        doc["ts_unix"] = time.time()
        return doc

    # -- checkpoint / resume -------------------------------------------------

    def _write_checkpoint(self) -> None:
        """The progress record, rewritten atomically as each window
        retires (tmp + rename): the tenants' fold states, banked verdicts
        and in-progress suffix offsets, all a relaunch needs to resume
        without folding a header twice."""
        if not self.checkpoint:
            return
        with self._lock:
            doc = {
                "schema": SCHEMA_VERSION,
                "kind": "oct-serve-checkpoint",
                "serve_tag": self.serve_tag,
                "windows": self.windows,
                "tenants": {
                    tid: {
                        "state": _recovery.encode_state(t.state),
                        "done": t.done,
                        "headers_done": t.headers_done,
                        "offset": (t.queue[0].offset if t.queue else 0),
                        "verdicts": [v.row() for v in t.verdicts],
                    }
                    for tid, t in sorted(self.tenants.items())
                },
                "pid": os.getpid(),
                "ts_unix": time.time(),
            }
        doc["digest"] = _doc_digest(doc)
        try:
            self.fs.write_atomic(self.checkpoint, json.dumps(doc).encode("utf-8"))
        except OSError:
            pass  # a checkpoint is best-effort: it never breaks serving

    def _try_resume(self) -> bool:
        doc = read_serve_checkpoint(self.checkpoint, self.fs)
        if doc is None or doc.get("serve_tag") != self.serve_tag:
            return False
        for tid, row in doc["tenants"].items():
            t = self.register(tid, state=_recovery.decode_state(row["state"]))
            t.done = int(row["done"])
            t.headers_done = int(row["headers_done"])
            t.resume_offset = int(row["offset"])
            t.verdicts = [SuffixVerdict(tid, *r) for r in row["verdicts"]]
        with self._lock:
            self.windows = int(doc["windows"])
        self.resumed = True
        return True
