"""The port's fault injection (testing/chaos.py) against the JAX
package's: `parse_spec` accepts and rejects what the reference does (the
reference's faults that have no seam in the port, refused there, are
listed apart), the parsed injections are the same, the seams fire at the
same sequence positions, and a plan's seeded jitter is the same
sequence. The reference arms its plan from its environment, the port by
`arming`."""

import pytest

from ouroboros_consensus_tpu.testing import chaos as rchaos
from ouroboros_consensus_tpu_torch.testing import chaos

ACCEPTED = [
    "device-error@dispatch:2", "device-error@window:2", "device-error@stage:finish",
    "device-error@dispatch:2x3", "staging-thread-death@window:3", "compile-stall@window:3",
    "compile-stall@stage:ed", "sigkill@window:7", "chunk-corrupt@epoch:1",
    "chunk-corrupt@chunk:0", "torn-write@append:4", "bitflip@chunk:2", "bitflip@append:20",
    "index-truncate@epoch:1", "sigkill@append:3", "partial-rename@marker",
    "partial-rename@marker:clean", "sidecar-torn@build:2", "sidecar-torn@chunk:1",
    "sidecar-stale@open:0", "sigkill@build:1",
    "device-error@dispatch:1, chunk-corrupt@epoch:0", " ,sigkill@window:0,",
    "device-error@serve-dispatch:2", "sigkill@serve:3",
]
REJECTED = [
    "bogus@window:1", "device-error", "device-error@dispatch:", "device-error@:3",
    "device-error@nowhere:1", "bitflip@window:1", "partial-rename@append:1",
    "staging-thread-death@dispatch:1", "sidecar-stale@build:1", "torn-write@append",
]
# the reference's faults and triggers with no seam in the port
PORT_REFUSES = [
    "aot-reject@stage:aggregate", "probe-timeout", "device-error@shard:0",
    "device-error@forge-dispatch:0", "sigkill@forge:10",
]


def _shape(injections):
    return [(i.kind, i.trigger, "ANY" if i.arg is chaos.ANY or i.arg is rchaos.ANY else i.arg,
             i.count) for i in injections]


@pytest.mark.parametrize("spec", ACCEPTED)
def test_accepted_specs_parse_alike(spec):
    assert _shape(chaos.parse_spec(spec)) == _shape(rchaos.parse_spec(spec))


@pytest.mark.parametrize("spec", REJECTED)
def test_rejected_specs_are_rejected_by_both(spec):
    with pytest.raises(ValueError):
        rchaos.parse_spec(spec)
    with pytest.raises(ValueError):
        chaos.parse_spec(spec)


@pytest.mark.parametrize("spec", PORT_REFUSES)
def test_faults_without_a_seam_are_refused(spec):
    rchaos.parse_spec(spec)
    with pytest.raises(ValueError):
        chaos.parse_spec(spec)


def _firings(mod, sites, **kw):
    """Which calls of a seam raise (or return a kind), in order."""
    out = []
    for site in sites:
        try:
            if site == "append":
                out.append((site, mod.write_fault(**kw)))
            else:
                mod.fire(site, **kw)
                out.append((site, None))
        except mod.ChaosError as e:
            out.append((site, type(e).__name__))
    return out


SEQUENCE = ["dispatch", "stage", "dispatch", "append", "chunk", "dispatch", "stage",
            "append", "stage", "dispatch", "chunk", "append"]


@pytest.mark.parametrize("spec", [
    "device-error@dispatch:2,staging-thread-death@window:1",
    "device-error@dispatch:1x2,chunk-corrupt@epoch:1,torn-write@append:2",
    "bitflip@append:0,index-truncate@append:1",
])
def test_seams_fire_at_the_same_places(spec, monkeypatch):
    monkeypatch.setenv("OCT_CHAOS", spec)
    rchaos.reset()
    try:
        want = _firings(rchaos, SEQUENCE)
    finally:
        monkeypatch.delenv("OCT_CHAOS")
        rchaos.reset()
    with chaos.arming(spec) as plan:
        got = _firings(chaos, SEQUENCE)
        fired = plan.fired()
    assert got == want
    assert fired and not chaos.armed()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_seeded_jitter_is_the_same_sequence(seed, monkeypatch):
    spec = "device-error@dispatch:0"
    monkeypatch.setenv("OCT_CHAOS", spec)
    monkeypatch.setenv("OCT_CHAOS_SEED", str(seed))
    rchaos.reset()
    try:
        want = [rchaos.jitter() for _ in range(16)]
    finally:
        monkeypatch.delenv("OCT_CHAOS")
        monkeypatch.delenv("OCT_CHAOS_SEED")
        rchaos.reset()
    with chaos.arming(spec, seed=seed):
        got = [chaos.jitter() for _ in range(16)]
    assert got == want
    assert all(1.0 <= j < 1.5 for j in got)


def test_disarmed_seams_do_nothing_and_arming_nests():
    assert not chaos.armed()
    chaos.fire("dispatch")
    assert chaos.write_fault(chunk=0) is None
    with chaos.arming("device-error@dispatch:0") as outer:
        with chaos.arming(None) as inner:
            assert inner is None and chaos.plan() is outer
        with chaos.arming("chunk-corrupt@epoch:0"):
            chaos.fire("dispatch")  # the outer plan is not armed in here
        with pytest.raises(chaos.DeviceChaosError):
            chaos.fire("dispatch")
    assert not chaos.armed() and chaos.plan() is None


def test_compile_stall_is_a_plain_stall():
    slept = []
    with chaos.arming("compile-stall@window:0", stall_s=0.01):
        import time

        t0 = time.perf_counter()
        chaos.fire("dispatch")
        slept.append(time.perf_counter() - t0)
    assert slept[0] >= 0.01
