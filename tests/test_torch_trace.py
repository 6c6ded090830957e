"""The port's batch tracer seam against the JAX package's (CPU).

The 48-block test chain (tests/torch_port_chain.py, max_batch 16: two
generically staged windows of mixed body widths, then two packed ones,
across two epoch boundaries) runs through the JAX package's
validate_chain and through the port's, each with a ListTracer and a
FlightRecorder on a fresh registry (tests/torch_trace_diff.py). Held
equal: the results, the sequence of event kinds, the window rows
(indices relative to the first, lanes, outcome, gate, n_valid, failed)
and the registry snapshots less the wall and byte families; on a clean
chain, a corrupted one (the failing window) and at pipeline depth 3
(the staging thread's events beside the launching thread's)."""

import pytest

from ouroboros_consensus_tpu.utils import trace as RT
from ouroboros_consensus_tpu_torch.utils import trace as PT

from tests import torch_trace_diff as ttd
from tests.torch_trace_diff import fenced_jax  # noqa: F401 — a fixture

ttd.set_threads()

SCENARIOS = {"clean": dict(), "corrupted": dict(corrupt=True), "depth3": dict(depth=3)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, fenced_jax):  # noqa: F811
    chain = ttd.Chain(str(tmp_path_factory.mktemp("trace") / "chain"))
    return {k: (ttd.jax_run(chain, **kw), ttd.port_run(chain, **kw))
            for k, kw in SCENARIOS.items()}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_results_match_reference(runs, scenario):
    ttd.same_result(*runs[scenario])


@pytest.mark.parametrize("scenario", ["clean", "corrupted"])
def test_event_kinds_match_reference(runs, scenario):
    r, p = runs[scenario]
    assert ttd.kinds(p) == ttd.kinds(r)
    # the materialize brackets, whose edges the comparison leaves out
    assert ttd.kinds(p, False).count("EncloseEvent:materialize:end") == \
        ttd.kinds(r, False).count("EncloseEvent:materialize:end")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_window_rows_match_reference(runs, scenario):
    r, p = runs[scenario]
    assert ttd.window_rows(p) == ttd.window_rows(r)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_registry_snapshots_match_reference(runs, scenario):
    r, p = runs[scenario]
    assert ttd.snapshot(p) == ttd.snapshot(r)


def test_the_chain_has_generic_and_packed_windows(runs):
    r, p = runs["clean"]
    staged = p.of("WindowStaged")
    assert [s.outcome for s in staged] == ["generic", "generic", "packed", "packed"]
    # a generic window names its gate, and its span carries it
    assert {s.gate for s in staged[:2]} == {"body-width-mixed"}
    assert {s.gate for s in p.of("WindowSpan")[:2]} == {"body-width-mixed"}
    assert sum(s.n_valid for s in p.of("WindowSpan")) == 48


def test_corrupted_chain_ends_at_the_failing_window(runs):
    """The window holding the first refused leader retires failed with
    its valid prefix; none after it retires (reference test_obs.py:373)."""
    r, p = runs["corrupted"]
    spans = p.of("WindowSpan")
    assert spans[-1].failed and not any(s.failed for s in spans[:-1])
    assert spans[-1].outcome == "packed"
    assert p.res.n_valid == sum(s.n_valid for s in spans) == ttd.FAILS_AT
    assert type(p.res.error).__name__ == type(r.res.error).__name__ == \
        "VRFLeaderValueTooBig"


def test_depth3_events_come_from_two_threads(runs):
    """At depth 3 the staging thread emits the "stage" brackets and the
    launching thread everything else; every window is staged once and
    retires once, in order."""
    r, p = runs["depth3"]
    stage = ttd.threads_of(p, "EncloseEvent", label="stage")
    assert stage and all(t.startswith("validate-stage") for t in stage)
    others = {t for e, t in zip(p.events, p.threads)
              if not (type(e).__name__ == "EncloseEvent" and e.label == "stage")}
    assert others == {"MainThread"}
    for run in (r, p):
        idx = [s.index for s in run.of("WindowSpan")]
        assert idx == sorted(idx) == [s.index for s in run.of("WindowStaged")]
    labels = lambda run: sorted(  # noqa: E731
        (e.label, e.edge) for e in run.of("EncloseEvent"))
    assert labels(p) == labels(r)


def test_event_classes_keep_the_reference_fields():
    """Every ported event class has the reference's fields, in order."""
    import dataclasses

    for name in ("EncloseEvent", "TransferEvent", "WindowStaged", "WindowSpan",
                 "AggRedispatch", "SidecarEvent", "RepairEvent", "RecoveryEvent",
                 "CheckpointEvent", "StallEvent", "ForgeSpan"):
        ours = [f.name for f in dataclasses.fields(getattr(PT, name))]
        assert ours == [f.name for f in dataclasses.fields(getattr(RT, name))], name


def test_combinators():
    seen = PT.ListTracer()
    odd = PT.cond_tracer(lambda x: x % 2, seen)
    PT.fanout(odd, PT.contramap(lambda x: x * 10, seen))(3)
    PT.fanout(odd, PT.null_tracer)(4)
    assert seen.events == [3, 30]
    with PT.Enclose(seen, "x"):
        pass
    start, end = seen.events[2:]
    assert (start.edge, end.edge) == ("start", "end") and end.duration >= 0
