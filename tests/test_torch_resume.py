"""Checkpoint and resume, and the chunk re-read, of the port's
`revalidate` (obs/recovery.py, tools/db_analyser.py) on the 48-block
test chain, against the JAX package's sequential host fold: a replay
that dies after some windows retired and is resumed from its record
ends in the uninterrupted replay's state, whether it died at an epoch's
last window, inside an epoch, on the device backend, or by a real
SIGKILL in a child process; a record of another chain is ignored; and a
chunk read that fails once is read again (a recovery event), twice
raises."""

import os
import shutil
import signal
import subprocess
import sys

import pytest
import torch

from torch_port_chain import PARAMS, assert_same, forge, port_native, reference

from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB
from ouroboros_consensus_tpu_torch.testing import chaos
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("resume") / "db")
    lview = forge(path)
    return path, lview, reference(path, lview)


def _abort_at(monkeypatch, call: int):
    """The native verifier raises at its `call`th window (from 1)."""
    run = pbatch.run_batch_native
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == call:
            raise RuntimeError("the process died here")
        return run(*a, **kw)

    monkeypatch.setattr(pbatch, "run_batch_native", failing)


@pytest.mark.parametrize("window", [4, 5, 7], ids=["epoch-end", "mid-epoch", "next-epoch"])
def test_resume_across_an_epoch_boundary(chain, tmp_path, monkeypatch, window):
    """Windows of four: epoch 0 is windows 0-3, so dying at the 4th call
    resumes from the epoch's end, at the 5th from inside epoch 1."""
    path, lview, ref = chain
    ck = str(tmp_path / "ck.json")
    with monkeypatch.context() as mp:
        _abort_at(mp, window)
        with pytest.raises(RuntimeError, match="died here"):
            port_native(path, lview, max_batch=4, checkpoint=ck, recovery=False)
    doc = recovery.read_checkpoint(ck)
    assert doc["windows"] == window - 1 and not doc["complete"]
    got = port_native(path, lview, max_batch=4, checkpoint=ck, resume=True)
    assert got.resumed_headers == doc["headers"] > 0
    assert_same(ref, got)
    assert recovery.read_checkpoint(ck)["complete"]
    # a completed record is not resumed from
    again = port_native(path, lview, max_batch=4, checkpoint=ck, resume=True)
    assert again.resumed_headers == 0
    assert_same(ref, again)


def test_resume_on_the_device_backend(chain, tmp_path):
    path, lview, ref = chain
    ck = str(tmp_path / "ck.json")
    kw = dict(device="cpu", max_batch=16, pipeline_depth=1, checkpoint=ck)
    with pytest.raises(chaos.DeviceChaosError):
        pda.revalidate(path, carry.params_from_reference(PARAMS),
                       carry.lview_from_reference(lview), recovery=False,
                       chaos="device-error@dispatch:2", **kw)
    got = pda.revalidate(path, carry.params_from_reference(PARAMS),
                         carry.lview_from_reference(lview), resume=True, **kw)
    assert got.resumed_headers > 0
    assert_same(ref, got)


_REPLAY_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from fractions import Fraction
from ouroboros_consensus_tpu_torch.protocol.praos import PraosParams
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

params = PraosParams(slots_per_kes_period=20, max_kes_evolutions=62, security_param=2,
                     active_slot_coeff=Fraction(1, 2), epoch_length=32, kes_depth=3)
pool = synth.make_pool(0, kes_depth=3)
pda.revalidate(sys.argv[2], params, synth.make_ledger_view([pool]), backend="native",
               max_batch=4, checkpoint=sys.argv[3], chaos="sigkill@window:5")
"""


def test_resume_after_a_real_sigkill(chain, tmp_path):
    path, lview, ref = chain
    db = str(tmp_path / "db")
    shutil.copytree(path, db)
    ck = str(tmp_path / "ck.json")
    proc = subprocess.run([sys.executable, "-c", _REPLAY_CHILD, REPO, db, ck],
                          capture_output=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()[-2000:]
    doc = recovery.read_checkpoint(ck)
    assert doc["windows"] == 6 and not doc["complete"]  # the kill came after its record
    got = port_native(db, lview, max_batch=4, checkpoint=ck, resume=True)
    assert got.opened_dirty  # the killed writer left the store dirty
    assert got.resumed_headers == doc["headers"] > 0
    assert_same(ref, got)


def test_a_record_of_another_chain_is_ignored(chain, tmp_path):
    path, lview, ref = chain
    ck = str(tmp_path / "ck.json")
    st = carry.state_from_reference(ref.final_state)
    w = recovery.arm_writer(ck, recovery.chain_tag(str(tmp_path / "other"),
                                                   carry.params_from_reference(PARAMS)))
    w.note(st, 20)
    recovery.disarm_writer()
    got = port_native(path, lview, checkpoint=ck, resume=True)
    assert got.resumed_headers == 0
    assert_same(ref, got)
    with pytest.raises(ValueError, match="checkpoint"):
        port_native(path, lview, resume=True)


def test_a_chunk_read_that_fails_once_is_read_again(chain, monkeypatch):
    path, lview, ref = chain
    got = port_native(path, lview, chaos="chunk-corrupt@epoch:1")
    assert_same(ref, got)
    assert [(e.action, e.window, e.fault) for e in got.recoveries] == [
        ("chunk-reread", 1, "ChunkChaosError"), ("recovered", 1, "ChunkChaosError")]
    with pytest.raises(chaos.ChunkChaosError):
        port_native(path, lview, validate_all="stream", chaos="chunk-corrupt@epoch:1",
                    recovery=False)
    read = ImmutableDB.read_chunk
    reads = []

    def unreadable(self, n):
        reads.append(n)
        if n == 2:
            raise OSError("chunk 2 unreadable")
        return read(self, n)

    monkeypatch.setattr(ImmutableDB, "read_chunk", unreadable)
    with pytest.raises(OSError, match="unreadable"):
        port_native(path, lview, validate_all="stream")
    assert reads.count(2) == 2  # read, read again, then raised
