"""The port's live plane (CPU), after the JAX package's tests/test_live.py:
the heartbeat document and its classification, a kill mid-rewrite, the
stall watchdog's one dump an episode on a stubbed clock, the ref-counted
mount, /healthz answering mid-replay with the armed plane's document,
and a failed replay that leaves no listener and no tracer behind."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch

from ouroboros_consensus_tpu_torch import obs
from ouroboros_consensus_tpu_torch.obs import live, server
from ouroboros_consensus_tpu_torch.obs.warmup import WARMUP
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.testing import chaos
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda
from ouroboros_consensus_tpu_torch.utils import trace as T

from tests import torch_port_chain as tpc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from ouroboros_consensus_tpu_torch import carry

    path = str(tmp_path_factory.mktemp("live") / "db")
    lview = tpc.forge(path)
    return path, carry.params_from_reference(tpc.PARAMS), carry.lview_from_reference(lview)


def _span(i: int, n: int = 8):
    return T.WindowSpan(index=i, lanes=n, outcome="packed", gate=None, stage_s=0.01,
                        dispatch_s=0.02, materialize_s=0.03, epilogue_s=0.004, t_dispatch=1.0,
                        t_materialized=2.0, t_done=3.0, n_valid=n, failed=False)


def _get(port: int, route: str) -> dict:
    return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                             timeout=10).read())


def test_snapshot_phase_from_the_last_event():
    rec = obs.recorder()
    assert live.live_snapshot(rec)["phase"] == "idle"
    rec(T.WindowStaged(0, 8, 8, "packed", None, 0.01, 0.02))
    assert live.live_snapshot(rec)["phase"] == "dispatch"
    rec(_span(0))
    doc = live.live_snapshot(rec)
    assert (doc["phase"], doc["headers"], doc["window_index"]) == ("retired", 8, 0)
    rec(T.EncloseEvent("stream-parse", "end", 1.0, 0.5))
    assert live.classify(live.live_snapshot(rec)) == "staging"


def test_classify_vocabulary():
    now = 1000.0
    base = {"ts_unix": now, "phase": "retired", "warmup": {}}
    assert live.classify(None) == "no-heartbeat"
    assert live.classify(base, now_unix=now) == "running"
    assert live.classify(base, now_unix=now + 60) == "dead"
    assert live.classify({**base, "stalled_now": True}, now_unix=now) == "stalled"
    assert live.classify({**base, "phase": "stage"}, now_unix=now) == "staging"
    assert live.classify({**base, "phase": "warmup"}, now_unix=now) == "compiling"
    assert live.classify({**base, "phase": "idle"}, now_unix=now) == "idle"
    assert live.classify({**base, "done": True}, now_unix=now + 60) == "done"


def test_heartbeat_beats_and_rolling_rate(tmp_path):
    clk = [0.0]
    rec = obs.recorder()
    hb = live.Heartbeat(str(tmp_path / "hb.json"), rec=rec, clock=lambda: clk[0])
    assert hb.beat()["headers_per_s"] is None
    rec(_span(0, 100))
    clk[0] = 2.0
    doc = hb.beat()
    assert doc["headers_per_s"] == 50.0 and doc["seq"] == 1
    assert live.read_heartbeat(hb.path)["headers"] == 100
    hb.stop()  # never started: the final beat only
    assert live.classify(live.read_heartbeat(hb.path)) == "done"


_KILLED_MID_REWRITE = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
from ouroboros_consensus_tpu_torch import obs
from ouroboros_consensus_tpu_torch.obs import live
from ouroboros_consensus_tpu_torch.utils import trace as T
rec = obs.recorder()
rec(T.WindowSpan(index=3, lanes=8, outcome="packed", gate=None, stage_s=.01, dispatch_s=.02,
                 materialize_s=.03, epilogue_s=.004, t_dispatch=1., t_materialized=2.,
                 t_done=3., n_valid=8, failed=False))
hb = live.Heartbeat(sys.argv[2], rec=rec)
hb.beat()
with open(hb.path + ".tmp", "w") as f:
    f.write('{"torn": tru')  # killed mid-rewrite
os._exit(137)
"""


def test_heartbeat_survives_a_kill_mid_rewrite(tmp_path):
    path = str(tmp_path / "hb.json")
    proc = subprocess.run([sys.executable, "-c", _KILLED_MID_REWRITE, REPO, path],
                          capture_output=True, timeout=120)
    assert proc.returncode == 137, proc.stderr.decode()[-2000:]
    doc = live.read_heartbeat(path)
    assert doc is not None and doc["phase"] == "retired" and doc["headers"] == 8
    assert live.classify(doc, now_unix=doc["ts_unix"] + 60) == "dead"


def test_watchdog_one_dump_per_episode(tmp_path):
    """A wedge trips once; recovery transitions are progress; a new
    wedge after them is a new episode with its own dump."""
    rec = obs.recorder()
    rec(T.WindowStaged(7, 8, 16, "packed", None, 0.01, 0.02))
    clk = [0.0]
    wd = live.StallWatchdog(budget_s=10.0, rec=rec, dump_path=str(tmp_path / "d.json"),
                            clock=lambda: clk[0])
    clk[0] = 5.0
    assert wd.check() is None
    clk[0] = 11.0
    doc = wd.check()
    assert doc is not None and doc["phase"] == "dispatch"
    assert any("test_watchdog_one_dump_per_episode" in "".join(st)
               for st in doc["threads"].values())
    assert json.load(open(tmp_path / "d.json"))["budget_s"] == 10.0
    assert os.path.exists(str(tmp_path / "d.json") + ".txt")
    clk[0] = 30.0
    assert wd.check() is None and wd.dumps == 1  # the same episode
    WARMUP.note_recovery("retry", window=7, attempt=1, fault="DeviceChaosError")
    clk[0] = 31.0
    assert wd.check() is None and not wd.tripped  # progress re-arms it
    clk[0] = 45.0
    assert wd.check() is not None and wd.dumps == 2
    snap = rec.registry.snapshot()["oct_stalls_total"]["samples"]
    assert sum(s["value"] for s in snap) == 2
    assert [type(e).__name__ for _t, e in rec.timed_events()].count("StallEvent") == 2


def test_maybe_arm_is_refcounted(tmp_path):
    assert live.maybe_arm() is None  # nothing asked for: no plane
    hb = str(tmp_path / "hb.json")
    a = live.maybe_arm(heartbeat=hb)
    b = live.maybe_arm(heartbeat=hb)
    assert a is b and obs.installed() and live.armed() is a
    b.disarm()
    assert live.armed() is a and obs.installed()  # one arm still out
    a.disarm()
    assert live.armed() is None and not obs.installed()
    assert pbatch.BATCH_TRACER is None
    assert live.classify(live.read_heartbeat(hb)) == "done"


def test_healthz_serves_the_armed_plane_else_idle():
    srv = server.MetricsServer(port=0)
    try:
        assert _get(srv.port, "/healthz")["phase"] == "idle"
        plane = live.maybe_arm(metrics_port=0)
        try:
            plane.rec(_span(4, 16))
            # the plain server and the plane's own serve the armed document
            for port in (srv.port, plane.server.port):
                doc = _get(port, "/healthz")
                assert (doc["phase"], doc["headers"]) == ("retired", 16)
                assert _get(port, "/progress")["window_index"] == 4
        finally:
            plane.disarm()
        assert _get(srv.port, "/healthz")["phase"] == "idle"
    finally:
        srv.close()


def test_revalidate_answers_healthz_mid_replay(chain, tmp_path, monkeypatch):
    """The armed replay answers /healthz, /metrics.json and /progress from
    a second thread while a window is being retired, with a phase that
    is not idle; the heartbeat's last document classifies as done."""
    path, params, lview = chain
    hb = str(tmp_path / "hb.json")
    at_epilogue, scraped = threading.Event(), threading.Event()
    epilogue = pbatch.epilogue

    def held(*a, **kw):
        at_epilogue.set()
        scraped.wait(30)
        return epilogue(*a, **kw)

    monkeypatch.setattr(pbatch, "epilogue", held)
    out: dict = {}

    def replay():
        out["res"] = pda.revalidate(path, params, lview, device="cpu", max_batch=16,
                                    validate_all="stream", heartbeat=hb, metrics_port=0,
                                    stall_budget_s=300)

    t = threading.Thread(target=replay, daemon=True)
    t.start()
    try:
        assert at_epilogue.wait(120)
        port = live.armed().server.port
        hz = _get(port, "/healthz")
        assert hz["pid"] == os.getpid() and hz["phase"] not in ("idle", "warmup")
        assert "oct_windows_total" in _get(port, "/metrics.json")
        assert set(_get(port, "/progress")) <= set(server._PROGRESS_KEYS)
    finally:
        scraped.set()
        t.join(timeout=300)
    assert not t.is_alive() and out["res"].n_valid == tpc.N_BLOCKS
    assert live.armed() is None and pbatch.BATCH_TRACER is None
    assert live.classify(live.read_heartbeat(hb)) == "done"
    with pytest.raises(OSError):
        _get(port, "/healthz")


def test_a_failed_replay_leaves_no_listener_behind(chain, tmp_path):
    """An error escaping the replay (a fault past the device ladder)
    disarms the plane: the endpoint is closed, the recorder and the
    phase collector uninstalled."""
    path, params, lview = chain
    ports = []
    dispatch = pbatch.dispatch_prepared

    def note_port(*a, **kw):
        ports.append(live.armed().server.port)
        return dispatch(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pbatch, "dispatch_prepared", note_port)
        with pytest.raises(chaos.DeviceChaosError):
            pda.revalidate(path, params, lview, device="cpu", max_batch=16,
                           validate_all="stream", metrics_port=0, flight_recorder=True,
                           collect_phases=True, backoff_s=0, aggregate=False,
                           chaos="device-error@stage:finishx3", pipeline_depth=1)
    assert ports
    assert live.armed() is None and not obs.installed() and pbatch.BATCH_TRACER is None
    with pytest.raises(OSError):
        _get(ports[0], "/healthz")
