"""The port's warmup report, resources report, run ledger, Perfetto
export and metric names (CPU), after the JAX package's own cases
(tests/test_obs.py, tests/test_resources.py, tests/test_ledger.py),
each where the port has its counterpart."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from ouroboros_consensus_tpu.obs import perfetto as rperfetto
from ouroboros_consensus_tpu_torch import obs
from ouroboros_consensus_tpu_torch.obs import ledger, perfetto, resources
from ouroboros_consensus_tpu_torch.obs.registry import MetricsRegistry
from ouroboros_consensus_tpu_torch.obs.warmup import WARMUP, WarmupRecorder, read_report
from ouroboros_consensus_tpu_torch.ops.pk import kernels
from ouroboros_consensus_tpu_torch.utils import trace as T

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------


def test_warmup_report_and_flush(tmp_path):
    path = str(tmp_path / "warmup.json")
    w = WarmupRecorder()
    w.path = path
    assert w.note_stage("ed", 0.25)
    assert not w.note_stage("ed", 9.0)  # only the first launch counts
    assert read_report(path)["stages"]["ed"]["wall_s"] == pytest.approx(0.25)
    w.note_build("ed", 41.5)
    w.note_build("kes", 0.0, cached=True)
    w.note_recovery("retry", window=2, attempt=1, fault="DeviceChaosError")
    w.note_repair("truncate-chunk", chunk=1, kept=3, dropped=1)
    w.note("replay starting")
    rep = read_report(path)
    assert rep["builds"]["ed"]["wall_s"] == 41.5 and rep["builds"]["kes"]["cached"]
    assert rep["compile_total_s"] == 41.5  # the parallel build's longest source
    assert rep["n_stages"] == 1
    assert rep["recovery"][0]["action"] == "retry" and rep["repairs"][0]["kept"] == 3
    assert any("replay starting" in n for n in rep["notes"])
    w.reset()
    assert w.report()["stages"] == {} and w.report()["builds"] == {}


_KILLED_MID_FLUSH = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
from ouroboros_consensus_tpu_torch.obs.warmup import WARMUP
WARMUP.path = sys.argv[2]
WARMUP.note_build("msm", 12.5)
WARMUP.note_stage("msm", 0.125)
dump = json.dump

def torn(obj, f, **kw):
    f.write('{"elapsed_s": 1, "stag')  # the kill lands mid-write
    f.flush()
    os._exit(137)

json.dump = torn
WARMUP.note_stage("dedupe", 0.5)
"""


def test_warmup_report_survives_a_kill_mid_flush(tmp_path):
    """A process killed while it rewrites its report leaves the last
    complete one: the tmp file takes the torn write, the rename never
    happens."""
    path = str(tmp_path / "warmup.json")
    proc = subprocess.run([sys.executable, "-c", _KILLED_MID_FLUSH, REPO, path],
                          capture_output=True, timeout=120)
    assert proc.returncode == 137, proc.stderr.decode()[-2000:]
    rep = read_report(path)
    assert rep is not None and rep["stages"] == {"msm": rep["stages"]["msm"]}
    assert rep["builds"]["msm"]["wall_s"] == 12.5
    assert read_report(path + ".tmp") is None  # the torn one


def test_a_launch_notes_its_first_wall_and_a_failed_capture_is_counted():
    """kernels._launched, as every wrapper calls it right after a launch:
    one more launch counted, the first launch's wall into the warmup
    report, and the first capture of the kernel's figures, which fails
    here (no card) and is counted, never raised, and not tried again."""
    x = torch.zeros(4, dtype=torch.int32)
    kernels.reset_launches()
    try:
        kernels._launched("ed", 0.0, (x,), x)
        assert kernels.LAUNCHES["ed"] == 1
        assert "ed" in WARMUP.stages
        first = WARMUP.stages["ed"]["wall_s"]
        rep = resources.RESOURCES.report()
        assert rep["kernels"] == {} and "ed" in rep["failed"]
        kernels._launched("ed", 0.0, (x,), x)
        assert kernels.LAUNCHES["ed"] == 2
        assert WARMUP.stages["ed"]["wall_s"] == first
    finally:
        kernels.reset_launches()


# ---------------------------------------------------------------------------
# resources
# ---------------------------------------------------------------------------


def test_resources_first_capture_wins_and_mirrors_gauges():
    row = {"registers": 96, "local_bytes": 1712, "shared_bytes": 0, "max_threads": 320,
           "blocks_per_sm": 2, "argument_bytes": 300, "output_bytes": 40}
    assert resources.RESOURCES.note_kernel("agg_prep", row)
    assert not resources.RESOURCES.note_kernel("agg_prep", {**row, "registers": 1})
    rep = resources.RESOURCES.report()
    assert rep["kernels"]["agg_prep"] == row
    json.dumps(rep)
    snap = obs.registry.default_registry().snapshot()
    assert snap["oct_stage_registers"]["samples"] == [
        {"labels": {"stage": "agg_prep"}, "value": 96}]
    assert {s["labels"]["kind"]: s["value"]
            for s in snap["oct_stage_hbm_bytes"]["samples"]} == {"argument": 300, "output": 40}


def test_resources_capture_is_once_a_kernel_with_no_recorder(monkeypatch):
    """The capture needs no recorder and no keyword: a kernel's first
    launch takes its row, later launches take none, and a launch that
    passes capture=False (a tool body other than the one whose figures
    the row holds) leaves it to a later one."""
    calls = []

    def capture(name, args, outs):
        calls.append(name)
        return resources.RESOURCES.note_kernel(name, {"registers": 32})

    monkeypatch.setattr(resources, "capture_kernel", capture)
    x = torch.zeros(2, dtype=torch.int32)
    kernels.reset_launches()
    try:
        assert not obs.installed()
        for _ in range(3):
            kernels._launched("msm", 0.0, (x,), x)
        kernels._launched("primitives", 0.0, (x,), x, capture=False)
        assert calls == ["msm"]
        kernels._launched("primitives", 0.0, (x,), x)
        assert calls == ["msm", "primitives"]
        assert kernels.LAUNCHES["msm"] == 3 and kernels.LAUNCHES["primitives"] == 2
        assert set(resources.RESOURCES.report()["kernels"]) == {"msm", "primitives"}
    finally:
        kernels.reset_launches()


def test_capture_kernel_counts_a_failure():
    assert not resources.capture_kernel("no-such-kernel", (), ())
    assert "no-such-kernel" in resources.RESOURCES.report()["failed"]


# ---------------------------------------------------------------------------
# the run ledger
# ---------------------------------------------------------------------------


def test_ledger_record_validates_and_round_trips(tmp_path):
    d = str(tmp_path / "ledger")
    rec = ledger.record_run("bench", dir_=d, config={"headers": 32768},
                            result={"value": 1.5, "unit": "headers/s"}, wall_s=2.0,
                            env={"flight_recorder": True})
    assert rec is not None and ledger.validate_record(rec) == []
    assert rec["build_id"] is None  # no card here
    (back,) = ledger.read_runs(d)
    assert back == {k: v for k, v in rec.items() if k != "_path"}
    assert ledger.validate_record(back) == []
    assert back["git"]["rev"] is None or len(back["git"]["rev"]) == 40
    # append-only, and a torn line is skipped
    ledger.record_run("profile_replay", dir_=d)
    with open(rec["_path"], "a") as f:
        f.write('{"schema": 1, "kind": "tor')
    assert [r["kind"] for r in ledger.read_runs(d)] == ["bench", "profile_replay"]
    assert [r["kind"] for r in ledger.read_runs(d, kind="bench")] == ["bench"]
    assert ledger.record_run("bench", dir_="0") is None  # the ledger off


def test_ledger_rejects_malformed_records():
    assert ledger.validate_record([]) == ["record is not an object"]
    good = ledger.build_record("x", build_id="b")
    for key, bad in (("schema", 2), ("kind", ""), ("git", {}), ("env", None),
                     ("config", [1]), ("wall_s", "1"), ("result", {"x": float("nan")})):
        assert ledger.validate_record({**good, key: bad}), key


def test_ledger_record_replay_folds_the_obs_state(tmp_path):
    d = str(tmp_path / "ledger")
    rec = obs.recorder()
    rec(T.WindowStaged(0, 8, 8, "packed", None, 0.1, 0.2))
    WARMUP.note_stage("unpack", 0.01)
    resources.RESOURCES.note_kernel("unpack", {"registers": 40})
    out = ledger.record_replay("profile_replay", recorder=rec, dir_=d, wall_s=1.0)
    assert out["metrics"]["oct_windows_total"]["samples"][0]["value"] == 1
    assert out["warmup_report"]["stages"]["unpack"]["wall_s"] == 0.01
    assert out["device_resources"]["kernels"]["unpack"] == {"registers": 40}
    assert ledger.validate_record(ledger.read_runs(d)[0]) == []


def test_ledger_cli_tail(tmp_path, capsys):
    d = str(tmp_path / "ledger")
    assert ledger.main(["tail", "--dir", d]) == 1
    ledger.record_run("bench", dir_=d, result={"value": 7.0, "unit": "headers/s"},
                      wall_s=3.0, build_id="torch 2 | NVIDIA H100 80GB HBM3, 700.00 W")
    capsys.readouterr()
    assert ledger.main(["tail", "--dir", d, "--last", "1"]) == 0
    line = capsys.readouterr().out
    assert "bench" in line and "7.0 headers/s" in line
    assert ledger.main(["tail", "--dir", d, "--build-id", "A100"]) == 1


# ---------------------------------------------------------------------------
# Perfetto and the metric names
# ---------------------------------------------------------------------------


def test_perfetto_warmup_track_passes_both_validators():
    WARMUP.note_build("ed", 30.0)
    WARMUP.note_stage("ed", 0.002)
    WARMUP.note_recovery("retry", window=0, attempt=1, fault="DeviceChaosError")
    rec = obs.recorder()
    with T.Enclose(rec, "stage"):
        pass
    rec(T.TransferEvent("dispatch", 8, h2d_bytes=100, packed=True))
    doc = rec.chrome_trace()
    for validate in (perfetto.validate_chrome_trace, rperfetto.validate_chrome_trace):
        assert validate(doc) == []
    warm = {e["name"] for e in doc["traceEvents"] if e.get("tid") == 7 and e["ph"] != "M"}
    assert warm == {"nvcc ed", "ed first launch", "recovery: retry (window 0)"}
    # the build precedes the rest: it starts the timeline
    nvcc = next(e for e in doc["traceEvents"] if e["name"] == "nvcc ed")
    assert nvcc["ts"] == 0.0 and nvcc["dur"] == 30.0e6


def _readme_metric_names():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        text = f.read()
    concrete, wildcards = set(), set()
    for tok in re.findall(r"(?<![.\w])oct_[a-z0-9_]+(?:\{[^}\s]*\})?[a-z0-9_*]*", text):
        tok = re.sub(r"\{[^}]*=[^}]*\}", "", tok)
        m = re.match(r"^([a-z0-9_]*)\{([a-z0-9_,]+)\}([a-z0-9_]*)$", tok)
        if m:
            concrete |= {m.group(1) + alt + m.group(3) for alt in m.group(2).split(",")}
        elif "*" in tok:
            wildcards.add(tok)
        elif re.fullmatch(r"oct_[a-z0-9_]+", tok):
            concrete.add(tok)
    return concrete, wildcards


def test_readme_metric_names_match_registrations():
    """Both ways, as the reference's test: every family the README names
    is registered by the port, and every registered one is named."""
    import fnmatch

    from ouroboros_consensus_tpu_torch.node import serve
    from ouroboros_consensus_tpu_torch.obs import server
    from ouroboros_consensus_tpu_torch.obs.recorder import FlightRecorder

    reg = MetricsRegistry()
    FlightRecorder(reg)
    resources.register_families(reg)
    actual = set(reg._families)
    for mod in (server, serve):
        with open(mod.__file__, encoding="utf-8") as f:
            actual |= set(re.findall(r'"(oct_[a-z0-9_]+)"', f.read()))
    concrete, wildcards = _readme_metric_names()
    assert concrete
    missing = {n for n in concrete if n not in actual} | {
        w for w in wildcards if not any(fnmatch.fnmatch(a, w) for a in actual)}
    assert not missing
    undocumented = {a for a in actual if a not in concrete
                    and not any(fnmatch.fnmatch(a, w) for w in wildcards)}
    assert not undocumented


def test_profile_replay_budget_trace_and_ledger(tmp_path):
    """tools/profile_replay.profile on the 48-block test chain (the CPU
    twins): a warm and a hot replay's budget, the latency summary, a
    trace both validators accept, and one ledger record."""
    from ouroboros_consensus_tpu_torch import carry
    from ouroboros_consensus_tpu_torch.tools import profile_replay

    from tests import torch_port_chain as tpc

    db = str(tmp_path / "db")
    lview = carry.lview_from_reference(tpc.forge(db))
    trace = str(tmp_path / "replay.perfetto.json")
    lines = []
    out = profile_replay.profile(db, carry.params_from_reference(tpc.PARAMS), lview,
                                 device="cpu", max_batch=16, trace_out=trace,
                                 ledger_dir=str(tmp_path / "ledger"), log=lines.append,
                                 warmup_report=str(tmp_path / "warmup.json"))
    assert out["headers"] == tpc.N_BLOCKS and out["trace_problems"] == []
    assert {"stage", "dispatch", "materialize", "epilogue", "stream"} <= set(out["phases_s"])
    assert out["latency"]["windows"] == 2 * out["bytes"]["packed"]  # both replays' spans
    assert [ln.split(":")[0] for ln in lines if ln.startswith("==")] == ["== warm", "== hot"]
    with open(trace) as f:
        assert rperfetto.validate_chrome_trace(json.load(f)) == []
    (rec,) = ledger.read_runs(str(tmp_path / "ledger"))
    assert ledger.validate_record(rec) == [] and rec["kind"] == "profile_replay"
    assert rec["result"]["headers"] == tpc.N_BLOCKS and rec["env"]["trace_out"] == trace
    assert rec["metrics"]["oct_windows_total"]["samples"]
    assert not obs.installed() and WARMUP.path is None  # the keywords undone
