"""The port's store crash protocol (storage/guard.py, node/exit.py)
against the JAX package's: the lock excludes an open by the other
package in both directions (one `flock` on the same file), and the
reference's protocol cases (its tests/test_repair.py: stale and live
locks, a MockFS crash, a concurrent replay, the wrong magic, the triage
table, the dirty open that escalates and heals, the magic never stamped
on an unknown chain, the side-effect-free read of a virgin path, the
capped and the error-aborted dirty replays that stay dirty, the
unparseable marker) each run on twin copies of the 48-block test chain,
one replayed by each package, to the same verdicts, state, repairs,
dirty flag and directory bytes."""

import inspect
import os
import shutil

import pytest

from torch_port_chain import (N_BLOCKS, PARAMS, assert_same_store, forge, lview_of_chain,
                              port_native)

from ouroboros_consensus_tpu.storage import guard as rguard
from ouroboros_consensus_tpu.testing import fixtures as rfixtures
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu_torch.node import exit as node_exit
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import praos as ppraos
from ouroboros_consensus_tpu_torch.storage import guard as pguard
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDBError
from ouroboros_consensus_tpu_torch.storage.repair import QuarantineError
from ouroboros_consensus_tpu_torch.testing import chaos
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda
from ouroboros_consensus_tpu_torch.utils.fs import MockFS


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("guard") / "pristine")
    forge(path)
    return path


@pytest.fixture
def twins(pristine, tmp_path):
    """Two copies of the pristine chain: (the reference's, the port's)."""
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(pristine, a)
    shutil.copytree(pristine, b)
    return a, b


def _ref(path, lview=None, **kw):
    kw.setdefault("validate_all", False)
    return jda.revalidate(path, PARAMS, lview or lview_of_chain(), backend="host", **kw)


def _port(path, lview=None, **kw):
    kw.setdefault("validate_all", False)
    return port_native(path, lview or lview_of_chain(), **kw)


def _both(twins, **kw):
    a, b = twins
    ref, got = _ref(a, **kw), _port(b, **kw)
    assert_same_store(ref, got, a, b)
    return ref, got


def test_names_and_bytes_are_the_reference_s():
    assert (pguard.DB_LOCK, pguard.DB_MARKER, pguard.CLEAN_SHUTDOWN, pguard.DEFAULT_MAGIC) == \
        (rguard.DB_LOCK, rguard.DB_MARKER, rguard.CLEAN_SHUTDOWN, rguard.DEFAULT_MAGIC)


@pytest.mark.parametrize("holder", ["reference", "port"])
def test_lock_excludes_the_other_package(pristine, holder):
    """A guard held by either package makes the other's replay refuse."""
    held = (rguard if holder == "reference" else pguard).StoreGuard(pristine, writer=False)
    held.open()
    try:
        if holder == "reference":
            with pytest.raises(pguard.DbLocked):
                _port(pristine)
            with pytest.raises(pguard.DbLocked):
                pguard.DbLockFile(pristine).acquire()
        else:
            with pytest.raises(rguard.DbLocked):
                _ref(pristine)
            with pytest.raises(rguard.DbLocked):
                rguard.DbLockFile(pristine).acquire()
    finally:
        held.close()
    assert _port(pristine).n_valid == N_BLOCKS
    assert _ref(pristine).n_valid == N_BLOCKS


def test_live_lock_refuses_stale_lock_acquires(tmp_path):
    db = str(tmp_path / "db")
    os.makedirs(db)
    a = pguard.DbLockFile(db)
    a.acquire()
    b = pguard.DbLockFile(db)
    with pytest.raises(pguard.DbLocked):
        b.acquire()
    a.release()
    assert os.path.exists(os.path.join(db, pguard.DB_LOCK))  # stale, but no wedge
    b.acquire()
    b.release()


def test_mockfs_crash_releases_lock():
    fs = MockFS()
    fs.makedirs("db")
    pguard.DbLockFile("db", fs=fs).acquire()
    with pytest.raises(pguard.DbLocked):
        pguard.DbLockFile("db", fs=fs).acquire()
    fs.crash(0.0)
    pguard.DbLockFile("db", fs=fs).acquire()


def test_concurrent_revalidate_refuses_loudly(pristine):
    g = pguard.StoreGuard(pristine, writer=False).open()
    try:
        with pytest.raises(pguard.DbLocked):
            _port(pristine)
    finally:
        g.close()
    assert node_exit.triage(pguard.DbLocked("x")) is node_exit.Disposition.REFUSE
    assert not recovery.recoverable(pguard.DbLocked("x"))


def test_wrong_magic_refuses_loudly(pristine):
    assert pguard.read_db_marker(pristine) == pguard.DEFAULT_MAGIC
    with pytest.raises(pguard.DbMarkerMismatch):
        _port(pristine, network_magic=999)
    with pytest.raises(rguard.DbMarkerMismatch):
        _ref(pristine, network_magic=999)
    assert not recovery.recoverable(pguard.DbMarkerMismatch("x"))
    assert _port(pristine, network_magic=pguard.DEFAULT_MAGIC).error is None


def test_triage_dispositions():
    D = node_exit.Disposition
    assert node_exit.triage(ImmutableDBError("corrupt")) is D.REPAIR
    assert node_exit.triage(QuarantineError("full")) is D.REFUSE
    assert node_exit.triage(chaos.ChunkChaosError("io")) is D.RECOVER
    assert node_exit.triage(chaos.DeviceChaosError("dev")) is D.RECOVER
    assert node_exit.triage(OSError("io")) is D.RECOVER
    # a failed launch (ops/pk/kernels._raise_on) and a torch CUDA error
    assert node_exit.triage(RuntimeError("ed kernel launch failed: cudaError 700")) is D.RECOVER
    assert node_exit.triage(TypeError("bug")) is D.PROPAGATE
    # the reference's device path asserts: its AssertionError propagates
    assert node_exit.triage(AssertionError("nonce")) is D.PROPAGATE
    # a NotImplementedError, so a RuntimeError, but with a row of its own
    assert isinstance(pbatch.NotStagedError("kes-sig-len"), RuntimeError)
    assert node_exit.triage(pbatch.NotStagedError("kes-sig-len")) is D.PROPAGATE
    assert node_exit.triage(ppraos.VRFKeyBadProof(1, None)) is D.PROPAGATE
    assert node_exit.to_exit_reason(pguard.DbLocked("x")).name == "CONFIG_ERROR"
    assert node_exit.to_exit_reason(ImmutableDBError("x")).name == "DB_CORRUPTION"


def test_dirty_shutdown_escalates_and_heals(twins):
    a, b = twins
    for p in twins:
        pguard.clear_clean_marker(p)
    ref, got = _both(twins)
    assert got.opened_dirty and got.repairs == {"dirty-open-escalated": 1}
    assert got.n_valid == N_BLOCKS and pguard.was_clean_shutdown(b)
    ref2, got2 = _both(twins)
    assert not got2.opened_dirty and got2.repairs is None


def test_dirty_escalation_never_stamps_assumed_magic(twins):
    for p in twins:
        os.remove(os.path.join(p, pguard.DB_MARKER))
        pguard.clear_clean_marker(p)
    _ref_res, got = _both(twins)
    assert got.opened_dirty and pguard.read_db_marker(twins[1]) is None
    _both(twins, validate_all=True, network_magic=7)
    assert pguard.read_db_marker(twins[1]) == 7


def test_readonly_scan_of_virgin_path_is_side_effect_free(tmp_path):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    os.makedirs(a)
    os.makedirs(b)
    _both((a, b))
    assert not os.path.exists(os.path.join(b, "immutable"))
    assert pguard.read_db_marker(b) is None
    _ref2, got2 = _both((a, b))
    assert not got2.opened_dirty and got2.repairs is None
    # a writer's open of a virgin path refuses before any side effect
    with pytest.raises(FileNotFoundError):
        _port(b, validate_all=True)


def test_capped_dirty_replay_stays_dirty(twins):
    for p in twins:
        pguard.clear_clean_marker(p)
    _ref_res, got = _both(twins, validate_all="stream", max_headers=8)
    assert got.opened_dirty and got.n_valid == 8
    assert not pguard.was_clean_shutdown(twins[1])
    _ref2, got2 = _both(twins, validate_all="stream")
    assert got2.opened_dirty and got2.n_valid == N_BLOCKS
    assert pguard.was_clean_shutdown(twins[1])


def test_error_aborted_dirty_stream_stays_dirty(twins):
    """A ledger view without the chain's pool fails the first header:
    the stream proves nothing past it, so a dirty store stays dirty."""
    a, b = twins
    for p in twins:
        pguard.clear_clean_marker(p)
    wrong = rfixtures.make_ledger_view([rfixtures.make_pool(99, kes_depth=PARAMS.kes_depth)])
    ref = _ref(a, wrong, validate_all="stream")
    got = _port(b, wrong, validate_all="stream")
    assert_same_store(ref, got, a, b)
    assert got.opened_dirty and got.error is not None
    assert not pguard.was_clean_shutdown(b)
    _ref2, got2 = _both(twins, validate_all="stream")
    assert got2.error is None and pguard.was_clean_shutdown(b)


def test_unparseable_marker_refuses_loudly(twins):
    for p in twins:
        with open(os.path.join(p, pguard.DB_MARKER), "wb") as f:
            f.write(b"not-a-magic\n")
    b = twins[1]
    with pytest.raises(pguard.DbMarkerMismatch):
        pguard.read_db_marker(b)
    with pytest.raises(pguard.DbMarkerMismatch):
        _port(b)
    with pytest.raises(pguard.DbMarkerMismatch):
        _port(b, network_magic=pguard.DEFAULT_MAGIC)
    with pytest.raises(pguard.DbMarkerMismatch):
        pguard.StoreGuard(b, writer=True).open()
    with pytest.raises(rguard.DbMarkerMismatch):
        _ref(twins[0])


def test_reader_open_never_stamps_a_marker(twins):
    for p in twins:
        os.remove(os.path.join(p, pguard.DB_MARKER))
    _both(twins)
    assert pguard.read_db_marker(twins[1]) is None
    _both(twins, validate_all=True)
    assert pguard.read_db_marker(twins[1]) is None
    _both(twins, validate_all=True, network_magic=42)
    assert pguard.read_db_marker(twins[1]) == 42


def test_port_default_is_the_reference_s(twins):
    """revalidate's default validate_all is True, as the reference's: a
    writer's deep open."""
    a, b = twins
    lview = lview_of_chain()
    ref = jda.revalidate(a, PARAMS, lview, backend="host")
    got = _port(b, validate_all=True)
    assert_same_store(ref, got, a, b)
    assert inspect.signature(pda.revalidate).parameters["validate_all"].default is True
