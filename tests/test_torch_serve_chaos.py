"""The serving plane under faults, on the CPU, over real-crypto traffic:

  * `device-error@serve-dispatch` sheds the faulted window's tenant
    segments down the device ladder: every verdict and state equal to
    the undisturbed host plane's, no tenant dropped, and the degraded
    interval opens and then closes after two clean windows;
  * a fault that outlasts the port's device ladder (retry, stage-split:
    no host floor, unlike the reference's) raises out of `pump`;
  * a real SIGKILL after a window's checkpoint (`sigkill@serve`), then a
    relaunch on the same record: the seeded traffic re-submitted, the
    banked suffixes fast-forwarded, a suffix cut mid-way resumed at its
    offset, and the combined verdicts equal to an uninterrupted run's;
  * the serve seams fire at the same sequence positions as the JAX
    package's."""

import json
import os
import signal
import subprocess
import sys

import pytest

from ouroboros_consensus_tpu.testing import chaos as rchaos
from ouroboros_consensus_tpu_torch.node import serve
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.testing import chaos

import torch_serve_mix as mix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# three draft-03 tenants (peer-002 with a counter jump), 8-lane windows:
# three windows, the first one shared by all three
SMALL = dict(n_tenants=3, bc_every=0, fork_storm=0, equivocators=0, bad_lane_every=3,
             unknown_pool_every=0)


def test_device_error_sheds_to_the_ladder_and_heals():
    tr = mix.make(**SMALL)
    want_rows, want_states, want_log, _ = mix.run_port(tr, plane="host")
    sup = recovery.RecoverySupervisor(backoff_s=0.0)
    with chaos.arming("device-error@serve-dispatch:0") as plan:
        rows, states, log, svc = mix.run_port(tr, supervisor=sup)
    assert plan.fired() == ["device-error@serve-dispatch:0"]
    assert (rows, states, log) == (want_rows, want_states, want_log)
    assert len(log) >= 3 and len(log[0]) == 3  # the faulted window was shared
    # each of its three segments recovered on its first rung
    assert [e.action for e in sup.events] == ["retry", "recovered"] * 3
    doc = svc.slo_snapshot()
    assert doc["degraded"] is False and svc._m_degraded.value == 0
    (t_open, t_close, klass), = doc["degraded_intervals"]
    assert t_close is not None and t_close >= t_open
    assert klass == "DeviceChaosError"
    assert doc["suffixes_done"] == 6 and doc["queue_depth"] == 0


def test_an_exhausted_ladder_raises_out_of_pump():
    """The port's device ladder ends at stage-split and re-raises (the
    reference's goes on to its xla-twin and host-reference rungs and
    sheds the window to the host fold)."""
    tr = mix.make(**SMALL)
    sup = recovery.RecoverySupervisor(backoff_s=0.0)
    svc = mix.port_service(tr, supervisor=sup)
    for sfx in tr.suffixes():
        svc.submit(sfx.tenant_id, sfx.hvs)
    tr.reset()
    spec = "device-error@serve-dispatch:0,device-error@dispatch:0,device-error@dispatch:1"
    with chaos.arming(spec) as plan:
        with pytest.raises(chaos.DeviceChaosError, match="dispatch"):
            svc.pump()
    assert len(plan.fired()) == 3
    assert [e.action for e in sup.events] == ["retry", "stage-split", "exhausted"]
    assert svc.windows == 0 and not any(svc.verdicts(s.tenant_id) for s in tr.tenants)


def test_a_propagate_class_error_is_not_absorbed(monkeypatch):
    """A verdict or programming error (PROPAGATE) is re-raised as it
    came, never retried."""
    tr = mix.make(**SMALL)
    sup = recovery.RecoverySupervisor(backoff_s=0.0)
    svc = mix.port_service(tr, supervisor=sup)
    sfx = next(iter(tr.suffixes()))
    tr.reset()
    svc.submit(sfx.tenant_id, sfx.hvs)

    def broken(*a, **kw):
        raise AssertionError("a wrong program")

    monkeypatch.setattr(serve.pbatch, "prepare_window", broken)
    with pytest.raises(AssertionError, match="a wrong program"):
        svc.pump()
    assert sup.events == []


_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from ouroboros_consensus_tpu_torch.node import serve
from ouroboros_consensus_tpu_torch.obs.registry import MetricsRegistry
from ouroboros_consensus_tpu_torch.testing import chaos, traffic

ck, spec, out = sys.argv[2] or None, sys.argv[3], sys.argv[4]
tr = traffic.make_traffic(device="cpu", n_tenants=4, rounds=2, suffix_len=3, kes_depth=3,
                          bad_lane_every=3, seed=7)
svc = serve.ValidationService(tr.params, tr.lview, tr.eta0, plane="host",
                              registry=MetricsRegistry(), max_window=4, checkpoint=ck)
for s in tr.tenants:
    svc.register(s.tenant_id, tr.genesis_state())
with chaos.arming(spec or None):
    for sfx in tr.suffixes():
        svc.submit(sfx.tenant_id, sfx.hvs)
    svc.run_until_drained()
with open(out, "w") as f:
    json.dump({"resumed": svc.resumed, "windows": svc.windows,
               "verdicts": {s.tenant_id: [v.row() for v in svc.verdicts(s.tenant_id)]
                            for s in tr.tenants},
               "states": {t: serve._recovery.encode_state(x.state)
                          for t, x in svc.tenants.items()}}, f)
"""


def test_sigkill_mid_traffic_resumes_every_tenant(tmp_path):
    def run_child(ck, spec):
        out = str(tmp_path / f"out_{len(os.listdir(tmp_path))}.json")
        proc = subprocess.run([sys.executable, "-c", _CHILD, REPO, ck, spec, out],
                              capture_output=True, timeout=300)
        return proc, out

    proc, out = run_child("", "")
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    with open(out) as f:
        ref = json.load(f)
    assert sum(len(v) for v in ref["verdicts"].values()) == 8

    ck = str(tmp_path / "serve_ck.json")
    proc, _ = run_child(ck, "sigkill@serve:2")
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr.decode()[-2000:])
    doc = serve.read_serve_checkpoint(ck)
    assert doc is not None and doc["windows"] == 3
    banked = sum(len(t["verdicts"]) for t in doc["tenants"].values())
    assert banked < 8
    assert any(t["offset"] for t in doc["tenants"].values())  # a suffix cut mid-way

    proc, out = run_child(ck, "")
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    with open(out) as f:
        res = json.load(f)
    assert res["resumed"] is True
    assert res["verdicts"] == ref["verdicts"]
    assert res["states"] == ref["states"]
    assert res["windows"] > doc["windows"]


SEQUENCE = ["serve-dispatch", "serve", "dispatch", "serve-dispatch", "serve", "serve-dispatch",
            "serve", "dispatch", "serve-dispatch", "serve"]


def _firings(mod, sites):
    out = []
    for site in sites:
        try:
            mod.fire(site)
            out.append((site, None))
        except mod.ChaosError as e:
            out.append((site, type(e).__name__))
    return out


@pytest.mark.parametrize("spec", [
    "device-error@serve-dispatch:1",
    "device-error@serve-dispatch:0,device-error@serve-dispatch:3,device-error@dispatch:1",
    "device-error@serve-dispatch:2x2",
])
def test_serve_seams_fire_at_the_same_places(spec, monkeypatch):
    monkeypatch.setenv("OCT_CHAOS", spec)
    rchaos.reset()
    try:
        want = _firings(rchaos, SEQUENCE)
    finally:
        monkeypatch.delenv("OCT_CHAOS")
        rchaos.reset()
    with chaos.arming(spec) as plan:
        got = _firings(chaos, SEQUENCE)
        assert plan.fired()
    assert got == want
