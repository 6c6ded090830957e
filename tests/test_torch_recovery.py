"""The port's obs/recovery.py against the JAX package's: the checkpoint
record a replay writes is the reference's field for field (schema,
chain tag, position, state, digest, completion) at every retired window,
and a tampered or torn record fails closed; the supervisor's ladders
(device: retry, stage-split, no host rung; native: retry,
host-reference) each recover, exhaust and re-raise, or stand aside for a
disabled supervisor and for an error the ladder may not absorb; and the
native floor, `host_reference_fold`, equals the reference's on a clean
and on a failing window."""

import json
import os
import shutil

import pytest
import torch

from torch_port_chain import (N_BLOCKS, PARAMS, corrupt_copy, forge, port_native,
                              ref_view)

from ouroboros_consensus_tpu.obs import recovery as rrecovery
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import praos
from ouroboros_consensus_tpu_torch.protocol.praos import PraosState
from ouroboros_consensus_tpu_torch.testing import chaos
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)
PPARAMS = carry.params_from_reference(PARAMS)
RECORD_KEYS = ("schema", "kind", "chain_tag", "headers", "windows", "state", "digest",
               "complete", "error")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("recovery") / "db")
    return path, forge(path)


def _records(monkeypatch, writer_cls, out: list):
    """Keep a copy of every record `writer_cls` writes."""
    write = writer_cls._write

    def keep(self, *a, **kw):
        write(self, *a, **kw)
        with open(self.path) as f:
            out.append({k: v for k, v in json.load(f).items() if k in RECORD_KEYS})

    monkeypatch.setattr(writer_cls, "_write", keep)


def test_checkpoint_records_are_the_reference_s(chain, tmp_path, monkeypatch):
    path, lview = chain
    want, got = [], []
    _records(monkeypatch, rrecovery.ProgressWriter, want)
    _records(monkeypatch, recovery.ProgressWriter, got)
    with monkeypatch.context() as mp:
        mp.setenv("OCT_CHECKPOINT", str(tmp_path / "ref.json"))
        ref = jda.revalidate(path, PARAMS, lview, backend="native", max_batch=16)
    res = port_native(path, lview, checkpoint=str(tmp_path / "port.json"))
    assert ref.n_valid == res.n_valid == N_BLOCKS
    assert len(got) == len(want) > 3 and got == want
    assert got[-1]["complete"] and got[-1]["headers"] == N_BLOCKS
    assert recovery.chain_tag(path, PPARAMS) == rrecovery.chain_tag(path, PARAMS)


def _a_record(tmp_path, path) -> str:
    p = str(tmp_path / "ck.json")
    st = PraosState(last_slot=7, ocert_counters={b"\x01" * 28: 2}, evolving_nonce=b"\x02" * 32)
    w = recovery.arm_writer(p, recovery.chain_tag(path, PPARAMS))
    w.note(st, 5)
    recovery.disarm_writer()
    return p


@pytest.mark.parametrize("spoil", ["digest", "state", "headers", "torn", "schema", "empty"])
def test_a_tampered_or_torn_record_fails_closed(chain, tmp_path, spoil):
    path, _ = chain
    p = _a_record(tmp_path, path)
    tag = recovery.chain_tag(path, PPARAMS)
    doc = recovery.resume_record(tag, p)
    assert doc is not None and recovery.decode_state(doc["state"]).last_slot == 7
    raw = open(p).read()
    d = json.loads(raw)
    if spoil == "digest":
        d["digest"] = "0" * 32
    elif spoil == "state":
        d["state"]["last_slot"] = 8
    elif spoil == "headers":
        d["headers"] = 6
    elif spoil == "schema":
        d["schema"] = 2
    new = "" if spoil == "empty" else raw[: len(raw) // 2] if spoil == "torn" else json.dumps(d)
    open(p, "w").write(new)
    assert recovery.read_checkpoint(p) is None and recovery.resume_record(tag, p) is None
    assert rrecovery.read_checkpoint(p) is None  # the reference agrees


def _window(chain, n=4, dirty=False, tmp_path=None):
    """The first `n` headers (one window) and the ticked state before them."""
    path, lview = chain
    if dirty:
        db = str(tmp_path / "dirty")
        corrupt_copy(path, db, "kes_sig", index=2)
        path = db
    hvs = pda.read_header_views(path)[:n]
    plview = carry.lview_from_reference(lview)
    return hvs, praos.tick(PPARAMS, plview, hvs[0].slot, PraosState()), lview


def _failing(monkeypatch, times: int):
    """run_batch_native raising a RECOVER-class error its first `times` calls."""
    run = pbatch.run_batch_native
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) <= times:
            raise RuntimeError("native verifier fault")
        return run(*a, **kw)

    monkeypatch.setattr(pbatch, "run_batch_native", failing)
    return calls


@pytest.mark.parametrize("times,rung", [(1, "retry"), (2, "host-reference")])
def test_native_ladder_recovers(chain, monkeypatch, times, rung):
    hvs, ticked, _ = _window(chain)
    want = pbatch.validate_batch(PPARAMS, ticked, hvs, "native", None)
    _failing(monkeypatch, times)
    sup = recovery.RecoverySupervisor(backoff_s=0)
    got = pbatch.validate_chain(PPARAMS, lambda _e: ticked.ledger_view, PraosState(), hvs,
                                backend="native", supervisor=sup)
    assert (got.n_valid, got.state, got.error) == (want.n_valid, want.state, None)
    assert [e.action for e in sup.events] == [*recovery.LADDERS["native"][:times],
                                              "recovered"]
    assert sup.events[-1].ok and sup.recovered == sup.episodes == 1


def test_native_ladder_exhausts_and_raises(chain, monkeypatch):
    hvs, ticked, _ = _window(chain)
    _failing(monkeypatch, 10 ** 6)
    sup = recovery.RecoverySupervisor(backoff_s=0)
    with pytest.raises(RuntimeError, match="native verifier fault"):
        pbatch.validate_chain(PPARAMS, lambda _e: ticked.ledger_view, PraosState(), hvs,
                              backend="native", supervisor=sup)
    assert [e.action for e in sup.events] == ["retry", "host-reference", "exhausted"]
    assert sup.events[-1].ok is False


def test_disabled_or_unrecoverable_errors_pass_straight_through(chain, monkeypatch):
    hvs, ticked, _ = _window(chain)
    _failing(monkeypatch, 1)
    sup = recovery.RecoverySupervisor(enabled=False)
    with pytest.raises(RuntimeError):
        pbatch.validate_chain(PPARAMS, lambda _e: ticked.ledger_view, PraosState(), hvs,
                              backend="native", supervisor=sup)

    def buggy(*a, **kw):
        raise TypeError("a bug")

    monkeypatch.setattr(pbatch, "run_batch_native", buggy)
    sup = recovery.RecoverySupervisor(backoff_s=0)
    with pytest.raises(TypeError):
        pbatch.validate_chain(PPARAMS, lambda _e: ticked.ledger_view, PraosState(), hvs,
                              backend="native", supervisor=sup)
    assert sup.events == [] and sup.episodes == 0


def test_retry_backoff_is_jittered_by_the_plan_s_rng(chain, monkeypatch):
    hvs, ticked, _ = _window(chain)
    _failing(monkeypatch, 1)
    slept = []
    sup = recovery.RecoverySupervisor(backoff_s=0.5, sleep=slept.append)
    with chaos.arming("chunk-corrupt@epoch:99", seed=3):
        pbatch.validate_chain(PPARAMS, lambda _e: ticked.ledger_view, PraosState(), hvs,
                              backend="native", supervisor=sup)
    with chaos.arming("chunk-corrupt@epoch:99", seed=3):
        want = 0.5 * chaos.jitter()
    assert slept == [want]


def test_device_ladder_stage_split_recovers_on_the_device(chain):
    """finish fails twice (the window, then its retry): the stage-split
    rung, the per-lane kernels on the device, gives the window's verdicts."""
    hvs, ticked, _ = _window(chain)
    sup = recovery.RecoverySupervisor(backoff_s=0)
    with chaos.arming("device-error@stage:finishx2"):
        got = pbatch.validate_chain(PPARAMS, lambda _e: ticked.ledger_view, PraosState(), hvs,
                                    device="cpu", pipeline_depth=1, aggregate=False,
                                    supervisor=sup)
    want = pbatch.validate_batch(PPARAMS, ticked, hvs, "native", None)
    assert (got.n_valid, got.state, got.error) == (want.n_valid, want.state, None)
    assert [e.action for e in sup.events] == ["retry", "stage-split", "recovered"]


def test_device_ladder_has_no_host_rung_and_reraises(chain):
    assert recovery.LADDERS["device"] == ("retry", "stage-split")
    hvs, ticked, _ = _window(chain)
    sup = recovery.RecoverySupervisor(backoff_s=0)
    redispatched = pbatch.AGG_REDISPATCH
    with chaos.arming("device-error@stage:finishx3"):
        with pytest.raises(chaos.DeviceChaosError):
            pbatch.validate_chain(PPARAMS, lambda _e: ticked.ledger_view, PraosState(), hvs,
                                  device="cpu", pipeline_depth=3, aggregate=False,
                                  supervisor=sup)
    assert [e.action for e in sup.events] == ["retry", "stage-split", "exhausted"]
    assert pbatch.AGG_REDISPATCH == redispatched  # a rung is not a re-dispatch


@pytest.mark.parametrize("dirty", [False, True], ids=["clean", "failing"])
def test_native_floor_equals_the_reference_s(chain, tmp_path, dirty):
    hvs, ticked, lview = _window(chain, n=8, dirty=dirty, tmp_path=tmp_path)
    got = recovery.host_reference_fold(PPARAMS, ticked, hvs)
    rticked = rpraos.tick(PARAMS, lview, hvs[0].slot, rpraos.PraosState())
    want = rrecovery.host_reference_fold(PARAMS, rticked, [ref_view(hv) for hv in hvs])
    assert got.n_valid == want.n_valid == (2 if dirty else 8)
    assert carry.error_to_plain(got.error) == carry.error_to_plain(want.error)
    assert carry.state_to_plain(got.state) == carry.state_to_plain(want.state)


def test_no_checkpoint_no_record(chain, tmp_path):
    path, lview = chain
    db = str(tmp_path / "db")
    shutil.copytree(path, db)
    res = port_native(db, lview)
    assert res.resumed_headers == 0 and recovery._WRITER is None
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".json")]
