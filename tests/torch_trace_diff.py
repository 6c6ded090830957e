"""Shared code of the tracer-seam differentials (tests/test_torch_trace.py,
tests/test_torch_recorder.py): the 48-block test chain of
tests/torch_port_chain.py validated by the JAX package's validate_chain
and by the port's, each with a ListTracer and a FlightRecorder on a
fresh registry chained into its batch seam.

The JAX side runs its device loop on the CPU with a hash-only crypto
stub (`leader_stub`, after tests/test_packed_batch.py's `_stub_verify`:
every signature passes; η, the leader value and the leader verdicts
are the reference's own `_leader_nonce_tail` of the declared β), which
on a chain whose signatures are valid gives the real verdicts; the port
runs its plain twins (real crypto). The corrupted case is therefore one
that leaves the signatures valid: the pool's stake cut to 95/100, so
that a header mid-chain (30, in the first packed window) fails its
leader check (VRFLeaderValueTooBig) on both sides. A dirty aggregated
window is forced on both sides: the JAX aggregate stubbed to fail
(tests/test_aggregate.py `_stub_aggregate(False)`), the port's
aggregated verdicts reported not clean."""

import copy
import dataclasses
import threading
from contextlib import ExitStack
from fractions import Fraction

import pytest
import torch

from ouroboros_consensus_tpu.obs.recorder import FlightRecorder as RRecorder
from ouroboros_consensus_tpu.obs.registry import MetricsRegistry as RRegistry
from ouroboros_consensus_tpu.protocol import batch as rbatch
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.obs.recorder import FlightRecorder as PRecorder
from ouroboros_consensus_tpu_torch.obs.registry import MetricsRegistry as PRegistry
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import praos as ppraos
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

from tests import torch_port_chain as tpc

MAX_BATCH = 16
CUT_STAKE = Fraction(95, 100)  # the corrupted case's stake of the one pool
FAILS_AT = 30  # the first header whose leader value that stake refuses
# families whose values are walls or bytes (held to the port's own result
# fields instead)
TIMED = ("oct_h2d_bytes_total", "oct_d2h_bytes_total", "oct_window_device_latency_seconds",
         *(f"oct_window_{p}_seconds" for p in ("stage", "dispatch", "materialize", "epilogue")))


class Chain:
    def __init__(self, path: str):
        self.path = path
        self.lview = tpc.forge(path)
        self.pparams = carry.params_from_reference(tpc.PARAMS)
        self.phvs = pda.read_header_views(path)
        self.rhvs = [tpc.ref_view(h) for h in self.phvs]
        self.cut_lview = dataclasses.replace(self.lview, pool_distr={
            k: dataclasses.replace(v, stake=CUT_STAKE) for k, v in self.lview.pool_distr.items()})

    def lviews(self, corrupt: bool):
        """(the JAX ledger view, the port's): the pool's stake cut to
        CUT_STAKE when `corrupt`."""
        lv = self.cut_lview if corrupt else self.lview
        return lv, carry.lview_from_reference(lv)


class Run:
    """One traced validate_chain: its result, events (with the thread
    each came from) and the recorder."""

    def __init__(self, res, events, threads, recorder):
        self.res = res
        self.events = events
        self.threads = threads
        self.recorder = recorder

    def of(self, *names):
        return [e for e in self.events if type(e).__name__ in names]


def _tracer(recorder):
    events, threads = [], []
    lock = threading.Lock()

    def t(ev):
        with lock:
            events.append(ev)
            threads.append(threading.current_thread().name)
        recorder(ev)

    return t, events, threads


def leader_stub(*cols):
    """The JAX fused verify with its signature checks passing and its
    leader and nonce tail real (its last three columns: β, the
    thresholds)."""
    import jax.numpy as jnp

    beta_decl, thr_lo, thr_hi = cols[-3:]
    win, amb, eta, lv = rbatch._leader_nonce_tail(jnp.asarray(beta_decl).astype(jnp.int32),
                                                  thr_lo, thr_hi)
    ones = jnp.ones((win.shape[0],), bool)
    return rbatch.Verdicts(ones, ones, ones, win, amb, eta, lv)


def jax_run(chain: Chain, corrupt: bool = False, depth: int = 1,
            dirty_agg: bool = False) -> Run:
    """The JAX package's validate_chain over the chain, stubbed crypto;
    `depth` 1 stages inline (OCT_STAGE_THREAD=0), else on its thread."""
    from tests.test_aggregate import _stub_aggregate

    from ouroboros_consensus_tpu.ops.pk import aggregate as ragg

    lview, _ = chain.lviews(corrupt)
    rec = RRecorder(RRegistry())
    tracer, events, threads = _tracer(rec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OCT_VRF_AGG", "1" if dirty_agg else "0")
        mp.setenv("OCT_STAGE_THREAD", "0" if depth == 1 else "1")
        for name in ("verify_praos", "verify_praos_bc", "verify_praos_any"):
            mp.setattr(rbatch, name, leader_stub)
        if dirty_agg:
            mp.setattr(ragg, "aggregate_window", _stub_aggregate(False))
        rbatch.set_batch_tracer(tracer)
        try:
            res = rbatch.validate_chain(tpc.PARAMS, lambda _e: lview, rpraos.PraosState(),
                                        chain.rhvs, max_batch=MAX_BATCH, pipeline_depth=depth)
        finally:
            rbatch.set_batch_tracer(None)
    return Run(res, events, threads, rec)


def port_run(chain: Chain, corrupt: bool = False, depth: int = 1,
             dirty_agg: bool = False) -> Run:
    """The port's validate_chain over the chain on the CPU; `dirty_agg`
    takes the aggregate and reports every aggregated window not clean
    (else the per-lane stages, as the stubbed JAX run)."""
    _, plview = chain.lviews(corrupt)
    rec = PRecorder(PRegistry())
    tracer, events, threads = _tracer(rec)
    with ExitStack() as stack:
        if dirty_agg:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            clean = pbatch.PackedVerdicts.clean
            mp.setattr(pbatch.PackedVerdicts, "clean",
                       lambda self: self.agg is None and clean(self))
        pbatch.set_batch_tracer(tracer)
        try:
            res = pbatch.validate_chain(chain.pparams, lambda _e: plview,
                                        ppraos.PraosState(), chain.phvs, max_batch=MAX_BATCH,
                                        device="cpu", pipeline_depth=depth,
                                        aggregate=dirty_agg)
        finally:
            pbatch.set_batch_tracer(None)
    return Run(res, events, threads, rec)


@pytest.fixture(scope="module")
def fenced_jax():
    """The JAX package's jit cache empty for the module (so its programs
    are compiled over the stubs) and as it was after it (so the stubbed
    programs leave with it); its warmup report too, as it was (the
    first executes of those programs note themselves there, and the
    JAX package's own tests read it)."""
    from ouroboros_consensus_tpu.obs.warmup import WARMUP as RWARMUP

    saved = dict(rbatch._JIT)
    with RWARMUP._lock:
        report = {k: copy.deepcopy(v) for k, v in vars(RWARMUP).items()
                  if not k.startswith("_")}
    rbatch._JIT.clear()
    yield
    rbatch._JIT.clear()
    rbatch._JIT.update(saved)
    with RWARMUP._lock:
        for k, v in report.items():
            setattr(RWARMUP, k, v)


def kinds(run: Run, drop_materialize_edges: bool = True) -> list:
    """The event kinds in order, phases and edges spelled out. The JAX
    loop reads a window's results on a worker thread, so its D2H
    TransferEvent lands before or inside the "materialize" bracket:
    those brackets' edges are dropped here (their count is compared
    apart)."""
    out = []
    for e in run.events:
        name = type(e).__name__
        if name == "EncloseEvent":
            if drop_materialize_edges and e.label == "materialize":
                continue
            name += f":{e.label}:{e.edge}"
        elif name == "TransferEvent":
            name += f":{e.phase}"
        out.append(name)
    return out


def window_rows(run: Run) -> list:
    """(kind, index relative to the first dispatch, lanes, outcome, gate,
    n_valid, failed) of each WindowStaged and WindowSpan, in order."""
    staged = run.of("WindowStaged")
    base = staged[0].index if staged else 0
    rows = []
    for e in run.of("WindowStaged", "WindowSpan"):
        if type(e).__name__ == "WindowStaged":
            rows.append(("staged", e.index - base, e.lanes, e.lanes_padded, e.outcome, e.gate))
        else:
            rows.append(("span", e.index - base, e.lanes, e.outcome, e.gate, e.n_valid,
                         e.failed))
    return rows


def snapshot(run: Run) -> dict:
    """The recorder's registry snapshot, the wall and byte families left
    out; a family with no samples is left out too (the JAX package
    registers families the port does not)."""
    snap = run.recorder.registry.snapshot()
    return {k: v["samples"] for k, v in snap.items()
            if k not in TIMED and v["samples"]
            and not (len(v["samples"]) == 1 and v["samples"][0].get("value") == 0
                     and not v["samples"][0].get("labels"))}


def same_result(r: Run, p: Run) -> None:
    assert p.res.n_valid == r.res.n_valid
    assert carry.error_to_plain(p.res.error) == carry.error_to_plain(r.res.error)
    assert carry.state_to_plain(p.res.state) == carry.state_to_plain(r.res.state)


def threads_of(run: Run, name: str, **match) -> set:
    return {t for e, t in zip(run.events, run.threads)
            if type(e).__name__ == name and all(getattr(e, k) == v for k, v in match.items())}


def set_threads() -> None:
    torch.set_num_threads(1)
