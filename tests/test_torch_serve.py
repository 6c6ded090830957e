"""The port's serving plane (node/serve.py, protocol/admission.py,
obs/server.py, testing/traffic.py) against the JAX package's, on the
CPU, over real-crypto multi-peer traffic: both proof formats, a fork
storm of equivocators, a counter jump and an unknown pool.

  * the port's device plane (the kernels' plain twins) gives each
    tenant's verdict rows and final state equal to the JAX
    ValidationService's under OCT_SERVE_DEVICE=0 and to the JAX
    sequential praos.update fold, and the same windows (the segments of
    each, in order);
  * the host plane gives them too and never stages a window;
  * the rotating quantum fill starves no tenant;
  * `shape_of` refuses what the reference refuses, with its strings;
  * the traffic is byte-reproducible, and its headers have the width of
    bench.py's chain;
  * a checkpoint read fails closed; /slo and /metrics answer over
    loopback."""

import json
import urllib.error
import urllib.request

import pytest

from ouroboros_consensus_tpu.protocol import admission as radmission
from ouroboros_consensus_tpu_torch.block.praos_block import body_hash
from ouroboros_consensus_tpu_torch.obs import server
from ouroboros_consensus_tpu_torch.obs.registry import MetricsRegistry
from ouroboros_consensus_tpu_torch.protocol import admission
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import forge as pforge
from ouroboros_consensus_tpu_torch.node import serve
from ouroboros_consensus_tpu_torch.testing import traffic
from ouroboros_consensus_tpu_torch.tools import bench

import torch_serve_mix as mix
from torch_port_chain import ref_view


@pytest.fixture(scope="module")
def tr():
    return mix.make()


@pytest.fixture(scope="module")
def device_run(tr):
    return mix.run_port(tr)


@pytest.fixture(scope="module")
def reference_run(tr):
    with pytest.MonkeyPatch.context() as mp:
        return mix.run_reference(tr, mp)


def test_the_mix_holds_every_shape(tr, device_run):
    rows = device_run[0]
    specs = {s.tenant_id: s for s in tr.tenants}
    assert {s.proof_len for s in tr.tenants} == {80, 128}
    assert specs["peer-000"].equivocal_with == "peer-001"
    errors = [r[2] for rs in rows.values() for r in rs if r[2] is not None]
    assert any(e.startswith("CounterOverIncrementedOCERT: (0, 2)") for e in errors)
    assert any(e.startswith("NoCounterForKeyHashOCERT") for e in errors)
    assert sum(r[1] for rs in rows.values() for r in rs) > 24


def test_device_plane_equals_the_reference_service(device_run, reference_run):
    assert device_run[0] == reference_run[0]
    assert device_run[1] == reference_run[1]


def test_device_plane_equals_the_sequential_fold(tr, device_run):
    want_rows, want_states = mix.reference_fold(tr)
    assert device_run[0] == want_rows
    assert device_run[1] == want_states


def test_window_composition_equals_the_reference(device_run, reference_run):
    log = device_run[2]
    assert log == reference_run[2]
    # windows were shared, suffixes spanned windows, and bc windows stood apart
    assert any(len(w) > 1 for w in log)
    assert len(log) < sum(len(w) for w in log)


def test_device_plane_metrics_and_slo(device_run):
    svc = device_run[3]
    doc = svc.slo_snapshot()
    assert doc["kind"] == "oct-serve-slo" and doc["device_serving"] is True
    assert doc["windows"] == len(device_run[2]) == svc._m_windows.labels(mode="warm").value
    assert svc.lanes == sum(hi - lo for w in device_run[2] for _t, _s, lo, hi in w)
    assert doc["admission"] == {"warm": doc["windows"], "host": 0}
    assert doc["queue_depth"] == 0 and doc["suffixes_done"] == 12
    assert svc._m_queue.value == 0  # the failures' unexamined tails left it too
    assert doc["degraded"] is False and doc["degraded_intervals"] == []
    assert doc["headers"] == svc._m_headers.value
    assert doc["verdict_latency_p50_s"] is not None


def test_host_plane_never_stages_and_equals_the_reference(tr, reference_run, monkeypatch):
    def trap(*a, **kw):
        raise AssertionError("the host plane staged a window")

    monkeypatch.setattr(pbatch, "prepare_window", trap)
    monkeypatch.setattr(pbatch, "dispatch_prepared", trap)
    rows, states, log, svc = mix.run_port(tr, plane="host")
    assert (rows, states, log) == reference_run
    assert svc.device is None
    assert svc._m_windows.labels(mode="host").value == svc.windows > 0
    assert svc.slo_snapshot()["device_serving"] is False


def test_quantum_fill_cannot_starve_a_same_shape_tenant():
    """Three 3-header tenants finish in the first two 8-lane windows
    while a 24-header suffix of the same shape is pending throughout."""
    small = mix.make(n_tenants=3, rounds=1, bc_every=0, fork_storm=0, equivocators=0,
                     bad_lane_every=0, unknown_pool_every=0)
    big = mix.make(n_tenants=4, rounds=1, suffix_len=24, bc_every=0, fork_storm=0,
                   equivocators=0, bad_lane_every=0, unknown_pool_every=0)
    svc = mix.port_service(small, plane="host")
    svc.register("peer-003", big.genesis_state())
    big_sfx = big.next_suffix(big.tenants[3])
    svc.submit(big_sfx.tenant_id, big_sfx.hvs)
    for sfx in small.suffixes():
        svc.submit(sfx.tenant_id, sfx.hvs)
    assert svc.pump() and svc.pump()
    for spec in small.tenants:
        assert [v.row() for v in svc.verdicts(spec.tenant_id)] == [[0, 3, None]]
    assert not svc.verdicts("peer-003")
    # the gauge kept by submits and windows is the queues' sum: the big
    # suffix had 2 lanes of the first window and 5 of the second
    assert svc._m_queue.value == svc.slo_snapshot()["queue_depth"] == 24 - 7
    svc.run_until_drained()
    assert [v.row() for v in svc.verdicts("peer-003")] == [[0, 24, None]]
    assert svc._m_queue.value == 0


@pytest.mark.parametrize("case", ["empty", "mixed-proofs", "mixed-bodies", "backwards",
                                  "repeat", "good"])
def test_shape_of_refuses_what_the_reference_refuses(tr, case):
    tr.reset()
    d03 = list(tr.next_suffix(tr.tenants[0]).hvs)
    bc = list(tr.next_suffix(tr.tenants[5]).hvs)
    tr.reset()
    wide = mix.make(body_len=40)
    other = wide.next_suffix(wide.tenants[0]).hvs
    hvs = {"empty": [], "mixed-proofs": d03[:2] + bc[2:], "mixed-bodies": d03[:2] + [other[2]],
           "backwards": [d03[1], d03[0]], "repeat": [d03[0], d03[0]], "good": d03}[case]
    got = want = None
    try:
        want = radmission.shape_of("peer-x", [ref_view(h) for h in hvs])
    except radmission.AdmissionRefused as e:
        want = ("refused", e.tenant_id, e.reason, str(e))
    try:
        got = admission.shape_of("peer-x", hvs)
    except admission.AdmissionRefused as e:
        got = ("refused", e.tenant_id, e.reason, str(e))
    if case == "good":
        assert (got.proof_len, got.body_len) == (want.proof_len, want.body_len) == (80, 404)
    else:
        assert got == want and got[0] == "refused"


def test_a_refused_submission_touches_nothing(tr):
    svc = mix.port_service(tr, plane="host")
    tr.reset()
    hvs = list(tr.next_suffix(tr.tenants[0]).hvs)
    tr.reset()
    with pytest.raises(admission.AdmissionRefused):
        svc.submit("peer-000", [hvs[1], hvs[0]])
    assert svc.slo_snapshot()["queue_depth"] == 0
    assert svc._m_suffixes.labels(result="refused").value == 1
    assert not svc.pump()


def test_admission_policy_admits_full_windows():
    shape = admission.WindowShape(proof_len=128, body_len=452)
    dev, host = admission.AdmissionPolicy("device"), admission.AdmissionPolicy("host")
    d = dev.admit(shape, 300)
    assert (d.mode, d.lane_cap, d.bucket, d.predicted_wall_s, d.device_resources) == \
        ("warm", 300, 512, None, None)
    assert host.admit(shape, 5).mode == "host"
    assert dev.decisions == {"warm": 1, "host": 0} and host.decisions == {"warm": 0, "host": 1}
    with pytest.raises(ValueError):
        admission.AdmissionPolicy("xla")
    with pytest.raises(ValueError):
        serve.ValidationService(None, None, b"", plane="twin")


def test_traffic_is_byte_reproducible(tr):
    again = mix.make()
    tr.reset()
    a = [(s.tenant_id, s.seq, [h.signed_bytes + h.kes_sig for h in s.hvs])
         for s in tr.suffixes()]
    tr.reset()
    b = [(s.tenant_id, s.seq, [h.signed_bytes + h.kes_sig for h in s.hvs])
         for s in again.suffixes()]
    assert a == b
    other = mix.make(seed=4)
    assert [h.signed_bytes for h in other.next_suffix(other.tenants[0]).hvs] != a[0][2]


def test_traffic_has_the_bench_chains_width(tr):
    """A traffic header is as wide as bench.py's chain's header at the
    same block and slot (its one pool, no transactions)."""
    params = bench.bench_params()
    pools, _ = bench.bench_ledger()
    asm = pforge.BlockAssembler(params, pools)
    slot = traffic.TrafficConfig().base_slot + 11
    chain = asm.forge(0, slot=slot, block_no=slot // 2, prev_hash=bytes(32), txs=(),
                      ocert_counter=0, vrf_output=bytes(64), vrf_proof=bytes(128))
    tr.reset()
    bc = tr.next_suffix(tr.tenants[5]).hvs
    tr.reset()
    assert {len(h.signed_bytes) for h in bc} == {len(chain.header.body.signed_bytes)}
    assert body_hash(()) != body_hash((b"x" * 16,))  # peers' bodies differ


def test_traffic_stays_in_one_epoch_and_kes_window(tr):
    p = tr.params
    tr.reset()
    slots = [h.slot for s in tr.suffixes() for h in s.hvs]
    tr.reset()
    assert len({p.epoch_of(s) for s in slots + [tr.tip_slot]}) == 1
    assert max(slots) < tr.slot_end
    with pytest.raises(ValueError, match="overruns"):
        tight = mix.make(n_tenants=1, rounds=1, suffix_len=4,
                         base_slot=p.first_slot_of(p.epoch_of(tr.tip_slot) + 1) - 12)
        tight.next_suffix(tight.tenants[0])


def test_checkpoint_read_is_fail_closed(tr, tmp_path):
    ck = str(tmp_path / "ck.json")
    svc = mix.port_service(tr, plane="host", checkpoint=ck)
    mix.drive(svc, tr)
    doc = serve.read_serve_checkpoint(ck)
    assert doc is not None and doc["windows"] == svc.windows
    assert doc["tenants"]["peer-003"]["verdicts"][0][2].startswith("CounterOver")
    assert mix.port_service(tr, plane="host", checkpoint=ck).resumed is True
    tampered = dict(doc)
    tampered["windows"] = doc["windows"] + 1
    with open(ck, "w") as f:
        json.dump(tampered, f)
    assert serve.read_serve_checkpoint(ck) is None
    for blob in ("{not json", "[1, 2]", json.dumps({**doc, "schema": 2})):
        with open(ck, "w") as f:
            f.write(blob)
        assert serve.read_serve_checkpoint(ck) is None
    assert serve.read_serve_checkpoint(str(tmp_path / "absent.json")) is None
    assert serve.read_serve_checkpoint(None) is None
    # a refused record means a fresh start, never a wrong seed
    assert mix.port_service(tr, plane="host", checkpoint=ck).resumed is False


def test_slo_and_metrics_over_loopback(tr):
    reg = MetricsRegistry()
    svc = mix.port_service(tr, plane="host", registry=reg)
    srv = server.MetricsServer(registry=reg, slo_doc=svc.slo_snapshot)
    try:
        mix.drive(svc, tr)
        url = f"http://127.0.0.1:{srv.port}"
        doc = json.load(urllib.request.urlopen(f"{url}/slo"))
        headers = svc.slo_snapshot()["headers"]
        assert doc["kind"] == "oct-serve-slo" and doc["headers"] == headers > 0
        assert doc["queue_depth"] == 0 and doc["headers_per_s"] > 0
        assert doc["verdict_latency_p50_s"] is not None
        assert doc["verdict_latency_p99_s"] >= doc["verdict_latency_p50_s"]
        txt = urllib.request.urlopen(f"{url}/metrics").read().decode()
        assert 'oct_metrics_scrapes_total{path="/slo"} 1' in txt
        assert f"oct_serve_headers_total {headers}" in txt
        assert "# TYPE oct_serve_verdict_latency_seconds histogram" in txt
        snap = json.load(urllib.request.urlopen(f"{url}/metrics.json"))
        assert snap["oct_serve_windows_total"]["samples"][0]["labels"] == {"mode": "host"}
        health = json.load(urllib.request.urlopen(f"{url}/healthz"))
        assert health["phase"] == "idle" and health["v"] == 1
        prog = json.load(urllib.request.urlopen(f"{url}/progress"))
        assert set(prog) == {"phase", "headers", "age_s", "window_index", "stalls",
                             "ts_unix"}
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/nope")
        assert ei.value.code == 404
        bare = server.MetricsServer(registry=MetricsRegistry())
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://127.0.0.1:{bare.port}/slo")
            assert ei.value.code == 404
        finally:
            bare.close()
    finally:
        srv.close()


def test_routes_answer_as_the_reference(tr):
    from ouroboros_consensus_tpu.obs import server as rserver
    from ouroboros_consensus_tpu.obs.registry import MetricsRegistry as RRegistry

    a, b = RRegistry(), MetricsRegistry()
    slo = {"kind": "oct-serve-slo", "headers": 7}
    for path in ("/metrics", "/metrics.json", "/slo", "/elsewhere", "/metrics"):
        want = rserver.handle_path(path, a, None, lambda: slo)
        got = server.handle_path(path, b, None, lambda: slo)
        assert got == want
    assert server.handle_path("/slo", b)[0] == rserver.handle_path("/slo", a)[0] == \
        b"404 Not Found"
    live = {"phase": "replay", "headers": 3, "age_s": 0.5, "extra": 1}
    for path in ("/healthz", "/progress"):
        assert server.handle_path(path, b, lambda: live) == \
            rserver.handle_path(path, a, lambda: live)


def test_submit_from_other_threads_while_pumping(tr, reference_run):
    """Three threads submit while the scheduler thread pumps (the switch
    interval shortened): every suffix is served once, and each tenant's
    rows and state are the sequential run's."""
    import sys
    import threading
    import time

    tr.reset()
    arrivals = list(tr.suffixes())
    tr.reset()
    svc = mix.port_service(tr, plane="host")
    tenants = [s.tenant_id for s in tr.tenants]
    groups = [tenants[i::3] for i in range(3)]
    start = threading.Barrier(4)

    def submitter(mine):
        start.wait()
        for sfx in arrivals:
            if sfx.tenant_id in mine:
                svc.submit(sfx.tenant_id, sfx.hvs)

    threads = [threading.Thread(target=submitter, args=(g,)) for g in groups]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        start.wait()
        deadline = time.monotonic() + 60
        while svc.slo_snapshot()["suffixes_done"] < len(arrivals):
            assert time.monotonic() < deadline
            svc.pump()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert (mix.rows(svc, tr), mix.states(svc, tr)) == reference_run[:2]
