"""The port's FlightRecorder and the events outside the window loop
(CPU).

Against the JAX package: a dirty aggregated window (the aggregate forced
to fail on both sides) emits the reference's events in its order
(AggRedispatch after the window's dispatch, before its span; a D2H
TransferEvent for each set of words read back) and the same registry
snapshot; each side's Perfetto document passes the other side's
validator. On the port alone: `revalidate(collect_phases=True)` is a
tracer over the seam whose totals equal the recorder's families, and
the sidecar, checkpoint, recovery, repair and forge events land in
their families and in the warmup report."""

import collections
import os

import pytest

from ouroboros_consensus_tpu.obs import perfetto as rperfetto
from ouroboros_consensus_tpu_torch import carry, obs
from ouroboros_consensus_tpu_torch.obs import perfetto, recovery
from ouroboros_consensus_tpu_torch.obs.warmup import WARMUP
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol.praos import PraosState
from ouroboros_consensus_tpu_torch.storage import repair, sidecar
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

from tests import torch_port_chain as tpc
from tests import torch_trace_diff as ttd
from tests.torch_trace_diff import fenced_jax  # noqa: F401 — a fixture

ttd.set_threads()


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    return ttd.Chain(str(tmp_path_factory.mktemp("recorder") / "chain"))


@pytest.fixture(scope="module")
def dirty(chain, fenced_jax):  # noqa: F811
    return ttd.jax_run(chain, dirty_agg=True), ttd.port_run(chain, dirty_agg=True)


def test_dirty_aggregated_windows_match_reference(dirty):
    r, p = dirty
    ttd.same_result(r, p)
    assert ttd.kinds(p) == ttd.kinds(r)
    assert ttd.window_rows(p) == ttd.window_rows(r)
    assert ttd.snapshot(p) == ttd.snapshot(r)
    outcomes = [s.outcome for s in p.of("WindowStaged")]
    assert outcomes == ["generic", "generic", "packed-agg", "packed-agg"]
    snap = p.recorder.registry.snapshot()
    assert snap["oct_agg_redispatch_total"]["samples"][0]["value"] == 2


def test_agg_redispatch_comes_between_its_dispatch_and_its_span(dirty):
    """Reference test_obs.py:409: each re-dispatch after its window's
    WindowStaged and before its WindowSpan, between two D2H transfers
    (the aggregate's words, then the stages')."""
    _, p = dirty
    k = ttd.kinds(p)
    for i in [i for i, x in enumerate(k) if x == "AggRedispatch"]:
        assert k[i - 1] == k[i + 1] == "TransferEvent:materialize"
        assert k[:i].count("WindowStaged") == k[:i].count("WindowSpan") + 1


def test_perfetto_documents_pass_each_other_s_validator(dirty):
    r, p = dirty
    port_doc = perfetto.to_chrome_trace(p.recorder.timed_events(), WARMUP.report(), WARMUP.t0)
    ref_doc = rperfetto.to_chrome_trace(r.recorder.timed_events())
    for validate in (perfetto.validate_chrome_trace, rperfetto.validate_chrome_trace):
        assert validate(port_doc) == [] and validate(ref_doc) == []
    names = {e["name"] for e in port_doc["traceEvents"]}
    assert {"stage", "dispatch", "materialize", "epilogue"} <= names
    assert sum(n.startswith("window ") for n in names) == 4
    assert "gate: body-width-mixed" in names
    bad = {"traceEvents": [{"name": 3, "ph": "Q", "ts": -1, "pid": "x"}]}
    assert len(perfetto.validate_chrome_trace(bad)) >= 4
    assert perfetto.validate_chrome_trace([]) != []


def test_collect_phases_is_the_recorder_s_totals(chain):
    """One way a phase is measured: the collector over the seam; its
    windows, bytes and headers equal the recorder's families."""
    assert not hasattr(pbatch, "PhaseTally")
    res = pda.revalidate(chain.path, chain.pparams, chain.lviews(False)[1], device="cpu",
                         max_batch=ttd.MAX_BATCH, validate_all="stream", collect_phases=True,
                         flight_recorder=True)
    assert pbatch.BATCH_TRACER is None  # both taken out again
    snap = obs.recorder().registry.snapshot()

    def total(name):
        return sum(s["value"] for s in snap[name]["samples"])

    assert res.n_valid == 48 and res.error is None
    # the columnar read cuts at width steps: every window stages packed
    assert total("oct_windows_total") == res.n_windows == res.packed_windows > 0
    assert total("oct_headers_validated_total") == res.n_valid
    assert total("oct_h2d_bytes_total") == res.h2d_bytes > 0
    assert total("oct_d2h_bytes_total") == res.d2h_bytes > 0
    assert set(res.phases) == {"read", "stage", "dispatch", "materialize", "epilogue"}
    # the read's spans reach the recorder, not the result's phases
    labels = collections.Counter(e.label for _t, e in obs.recorder().timed_events()
                                 if type(e).__name__ == "EncloseEvent" and e.edge == "end")
    # a span a chunk, and each chunk's sealed sidecar a hit
    assert labels["stream"] == labels["stream-mmap"] // 2 == total("oct_sidecar_total") > 1
    assert [s["labels"] for s in snap["oct_sidecar_total"]["samples"]] == [{"outcome": "hit"}]


def test_checkpoint_events(chain, tmp_path):
    ck = str(tmp_path / "ck.json")
    rec = obs.install()
    try:
        res = pda.revalidate(chain.path, chain.pparams, chain.lviews(False)[1], device="cpu",
                             max_batch=ttd.MAX_BATCH, validate_all="stream", checkpoint=ck)
    finally:
        obs.uninstall()
    evs = [e for _t, e in rec.timed_events()]
    kinds = [(e.kind, e.headers) for e in evs if type(e).__name__ == "CheckpointEvent"]
    assert kinds[-1] == ("complete", 48) and res.n_valid == 48
    # a write as each window retires, after its span
    spans = [e.n_valid for e in evs if type(e).__name__ == "WindowSpan"]
    writes = [h for k, h in kinds if k == "write"]
    assert writes == [sum(spans[:i + 1]) for i in range(len(spans))]


def test_resume_is_a_checkpoint_event_and_a_note(monkeypatch):
    seen = []
    monkeypatch.setattr(pbatch, "BATCH_TRACER", seen.append)
    recovery.note_resume({"headers": 16, "windows": 1})
    assert [(e.kind, e.headers, e.windows) for e in seen] == [("resume", 16, 1)]
    assert WARMUP.report()["notes"][-1].endswith("16 headers / 1 windows already retired")


def test_recovery_events_reach_the_recorder_and_the_warmup_report(chain, monkeypatch):
    """The supervisor's transitions are utils.trace.RecoveryEvents: on
    the supervisor (`events`, `counts`), counted by the recorder and
    rowed in the warmup report, with the same values."""
    calls = []
    native = pbatch.run_batch_native

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("native verifier fault")
        return native(*a, **kw)

    monkeypatch.setattr(pbatch, "run_batch_native", failing)
    sup = recovery.RecoverySupervisor(backoff_s=0)
    rec = obs.install()
    try:
        got = pbatch.validate_chain(chain.pparams, lambda _e: chain.lviews(False)[1],
                                    PraosState(), chain.phvs, backend="native", max_batch=16,
                                    supervisor=sup)
    finally:
        obs.uninstall()
    assert got.n_valid == 48
    assert [e.action for e in sup.events] == ["retry", "recovered"]
    assert all(type(e).__module__.endswith("utils.trace") for e in sup.events)
    snap = rec.registry.snapshot()["oct_recovery_total"]["samples"]
    assert {s["labels"]["action"]: s["value"] for s in snap} == sup.counts
    rows = WARMUP.report()["recovery"]
    assert [(r["action"], r["fault"]) for r in rows] == [
        (e.action, e.fault) for e in sup.events]


def test_repair_rows_reach_the_tracer_and_the_warmup_report(monkeypatch):
    seen = []
    monkeypatch.setattr(pbatch, "BATCH_TRACER", seen.append)
    row = repair.note_repair("truncate-chunk", chunk=3, kept=5, dropped=2,
                             bytes_quarantined=99, applied=False)
    assert row["action"] == "truncate-chunk" and row["applied"] is False
    (ev,) = seen
    assert (ev.action, ev.chunk, ev.blocks_kept, ev.blocks_dropped, ev.bytes_quarantined,
            ev.applied) == ("truncate-chunk", 3, 5, 2, 99, False)
    assert WARMUP.report()["repairs"][-1]["kept"] == 5
    # a dry run's row is not an applied repair
    rec = obs.recorder()
    rec(ev)
    assert rec.registry.snapshot()["oct_repair_total"]["samples"] == []


def test_sidecar_record_emits_its_outcome(monkeypatch):
    seen = []
    monkeypatch.setattr(pbatch, "BATCH_TRACER", seen.append)
    before = sidecar.counters()["stale"]
    sidecar.record("stale", 7)
    assert [(e.outcome, e.chunk) for e in seen] == [("stale", 7)]
    assert sidecar.counters()["stale"] == before + 1


def test_forge_spans_match_the_forge(tmp_path):
    """The windowed forge's ForgeSpans (the host engine): the windows'
    elected and signed sums are the chain's blocks, their slots the
    forge's slots, and the recorder's oct_forge_* families count them."""
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_synthesizer as ds

    params = tpc.PARAMS
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    rec = obs.install()
    try:
        res = ds.synthesize(str(tmp_path / "db"), carry.params_from_reference(params), pools,
                            synth.make_ledger_view(pools), ds.ForgeLimit(blocks=24),
                            chunk_size=24, engine="host")
    finally:
        obs.uninstall()
    spans = [e for _t, e in rec.timed_events() if type(e).__name__ == "ForgeSpan"]
    assert spans and {s.engine for s in spans} == {"host"}
    assert sum(s.signed for s in spans) == res.n_blocks == 24
    assert sum(s.slots for s in spans) == res.n_slots
    assert all(s.pairs == s.slots * len(pools) or s is spans[-1] for s in spans)
    snap = rec.registry.snapshot()
    assert snap["oct_forge_windows_total"]["samples"][0]["value"] == len(spans)
    assert snap["oct_forge_signed_total"]["samples"][0]["value"] == 24
    assert snap["oct_forge_elected_total"]["samples"][0]["value"] == sum(
        s.elected for s in spans)
    assert os.path.isdir(tmp_path / "db")
