"""The port's repair plane (storage/immutable.py, repair.py, open.py,
sidecar.py) against the JAX package's, on twin copies of the 48-block
test chain: each corrupted store is copied, the reference replays one
copy (`revalidate(backend="host")`) and the port the other (the native
backend), and the two must agree on n_valid, the error, the final state,
the repair counts and the dirty flag, and leave the two directories
byte-identical (chunks, indexes, sidecars, quarantine, markers).

The corruption matrix (the reference's tests/test_repair.py:565-605)
crosses the writer's faults, injected by the reference's synthesizer
(torn write, torn index, bit rot, a marker rename that died, a torn
sidecar build) or, for a real SIGKILL, by the port's own in a child
process, with every validation policy, and opens each store a second
time to see it healed. Beside it: the stream replay's write-back, the
read-only scans that touch nothing, the quarantine that refuses when it
cannot keep the bytes, the sidecar's invalidation, stale probe and
rebuild, and the sweeps of orphaned sidecars and of the tmp file a
killed sidecar build leaves."""

import os
import shutil

import pytest

from torch_port_chain import (N_BLOCKS, PARAMS, assert_same_store, forge, forge_faulted,
                              lview_of_chain, port_forge_child, port_native, tree)

from ouroboros_consensus_tpu.testing import chaos as rchaos
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu_torch.storage import guard as pguard
from ouroboros_consensus_tpu_torch.storage import sidecar
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB
from ouroboros_consensus_tpu_torch.storage.open import (default_check_integrity,
                                                        default_check_integrity_batch)
from ouroboros_consensus_tpu_torch.storage.repair import QuarantineError


N_CHUNKS = 5  # the test chain's 24-slot chunks


def _ref(path, **kw):
    return jda.revalidate(path, PARAMS, lview_of_chain(), backend="host", **kw)


def _both(a, b, **kw):
    ref, got = _ref(a, **kw), port_native(b, lview_of_chain(), **kw)
    assert_same_store(ref, got, a, b)
    return ref, got


def _twin(src: str, tmp_path) -> tuple[str, str]:
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return a, b


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("repair") / "pristine")
    forge(path)
    return path


def _corrupt_tail(db: str, chunk: int = 0, garbage: bytes = b"\x81\x18garbage-tail") -> int:
    with open(os.path.join(db, "immutable", f"{chunk:05d}.chunk"), "ab") as f:
        f.write(garbage)
    return len(garbage)


_MATRIX = [
    ("torn-write@append:10", [True, "stream", False]),
    ("index-truncate@epoch:1", [True, "stream", False]),
    ("bitflip@append:20", [True, "stream"]),  # mid-chain: a shallow open trusts it
    ("bitflip@append:47", [False]),  # in the last chunk: even the shallow open sees it
    ("partial-rename@marker", [True, "stream", False]),
    ("sidecar-torn@build:1", [True, "stream", False]),
    ("sigkill@append:15", [False, "stream"]),  # a real kill, in a child
    ("sigkill@build:1", ["stream"]),
]


@pytest.mark.parametrize("fault,policy", [(f, p) for f, ps in _MATRIX for p in ps])
def test_corruption_matrix(tmp_path, fault, policy):
    src = str(tmp_path / "src")
    if fault.startswith("sigkill"):
        port_forge_child(src, fault)
        assert not pguard.was_clean_shutdown(src)
    else:
        died = forge_faulted(src, fault)
        assert (died is None) == fault.startswith(("bitflip", "sidecar")), died
    a, b = _twin(src, tmp_path)
    ref, got = _both(a, b, validate_all=policy)
    assert got.error is None
    killed = fault.split("@")[0] in ("torn-write", "index-truncate", "partial-rename", "sigkill")
    assert got.opened_dirty == killed
    # the second open: healed (clean, same chain) wherever the first wrote
    _ref2, got2 = _both(a, b, validate_all=policy)
    assert not got2.opened_dirty or policy is False and not killed
    assert (got2.n_valid, got2.final_state) == (got.n_valid, got.final_state)


def test_stream_writeback_and_the_deep_open_after(tmp_path):
    """A read-only stream cuts only the verdict; with repair the same cut
    lands on disk (quarantined); the repaired store then opens deep and
    clean."""
    src = str(tmp_path / "src")
    assert forge_faulted(src, "bitflip@append:20") is None
    a, b = _twin(src, tmp_path)
    before = tree(b)
    _ref1, r1 = _both(a, b, validate_all="stream")
    assert r1.n_valid == 20 and r1.repairs is None and tree(b) == before
    _ref2, r2 = _both(a, b, validate_all="stream", repair=True)
    assert r2.n_valid == 20 and r2.repairs["truncate-chunk"] == 1
    assert os.listdir(os.path.join(b, "immutable", "quarantine"))
    _ref3, r3 = _both(a, b, validate_all=True)
    assert r3.n_valid == 20 and r3.repairs is None


def test_open_with_repair_quarantines_and_counts(pristine, tmp_path):
    a, b = _twin(pristine, tmp_path)
    n = _corrupt_tail(a)
    _corrupt_tail(b)
    _ref_res, got = _both(a, b, validate_all=True)
    assert got.repairs["rebuild-index"] == 1 and got.repairs["truncate-chunk"] == 1
    qdir = os.path.join(b, "immutable", "quarantine")
    assert any(f.startswith("00000.chunk.tail") for f in os.listdir(qdir))
    assert sum(os.path.getsize(os.path.join(qdir, f)) for f in os.listdir(qdir)) >= n


def test_stranded_drop_counts_the_on_disk_index(pristine, tmp_path):
    a, b = _twin(pristine, tmp_path)
    for p in (a, b):
        with open(os.path.join(p, "immutable", "00000.chunk"), "wb") as f:
            f.write(b"\xff" * 128)
        os.remove(os.path.join(p, "immutable", "00000.index"))
    _ref_res, got = _both(a, b, validate_all=True)
    assert got.n_valid == 0 and got.repairs["drop-chunk"] == N_CHUNKS - 1
    imm = ImmutableDB(os.path.join(pristine, "immutable"), chunk_size=24,
                      check_integrity=default_check_integrity, validate_all=True,
                      check_integrity_batch=default_check_integrity_batch)
    assert imm.repairs == []  # the pristine chain: nothing to repair


def test_unwritable_quarantine_refuses_before_any_change(pristine, tmp_path):
    a, b = _twin(pristine, tmp_path)
    for p in (a, b):
        _corrupt_tail(p)
        with open(os.path.join(p, "immutable", "quarantine"), "wb") as f:
            f.write(b"not a directory")
    before = tree(b)
    with pytest.raises(QuarantineError):
        port_native(b, lview_of_chain(), validate_all=True)
    assert {k: v for k, v in tree(b).items() if k != "clean"} == \
        {k: v for k, v in before.items() if k != "clean"}
    assert not pguard.was_clean_shutdown(b)  # the raise left it dirty
    for p in (a, b):
        os.remove(os.path.join(p, "immutable", "quarantine"))
    pguard.clear_clean_marker(a)
    _ref_res, got = _both(a, b, validate_all=True)
    assert got.repairs["truncate-chunk"] == 1


def test_dry_run_scan_touches_nothing(pristine, tmp_path):
    db = str(tmp_path / "db")
    shutil.copytree(pristine, db)
    _corrupt_tail(db)
    before = tree(db)
    imm = ImmutableDB(os.path.join(db, "immutable"), chunk_size=24,
                      check_integrity=default_check_integrity, validate_all=True,
                      check_integrity_batch=default_check_integrity_batch, repair=False)
    assert tree(db) == before
    assert "truncate-chunk" in {r["action"] for r in imm.repairs}
    assert not any(r["applied"] for r in imm.repairs)
    assert imm.n_blocks() < N_BLOCKS


def test_sidecar_stale_at_open_forces_the_scan(pristine, tmp_path):
    """sidecar-stale@open:0 on a fresh seal: the scan takes the chunk and
    no verdict changes (the reference's plan, and the port's keyword)."""
    a, b = _twin(pristine, tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OCT_CHAOS", "sidecar-stale@open:0")
        rchaos.reset()
        ref = _ref(a, validate_all="stream")
        mp.delenv("OCT_CHAOS")
        rchaos.reset()
    sidecar.reset_counters()
    got = port_native(b, lview_of_chain(), validate_all="stream",
                      chaos="sidecar-stale@open:0")
    assert sidecar.counters()["stale"] == 1 and sidecar.counters()["hit"] == N_CHUNKS - 1
    assert_same_store(ref, got, a, b)


def test_rotten_sidecar_is_never_trusted_and_a_writer_seals_it_again(pristine, tmp_path):
    a, b = _twin(pristine, tmp_path)
    for p in (a, b):
        f = os.path.join(p, "immutable", "00000.cols")
        blob = bytearray(open(f, "rb").read())
        blob[sidecar.HEADER_SIZE + 9] ^= 0x10
        open(f, "wb").write(bytes(blob))
    sidecar.reset_counters()
    _both(a, b, validate_all="stream")
    assert sidecar.counters()["stale"] == 1 and sidecar.counters()["rebuilt"] == 0
    sidecar.reset_counters()
    _both(a, b, validate_all="stream", repair=True)
    assert sidecar.counters()["rebuilt"] == 1
    sidecar.reset_counters()
    _both(a, b, validate_all="stream")
    assert sidecar.counters()["hit"] == N_CHUNKS


def test_orphan_sidecars_are_swept_by_a_writer(pristine, tmp_path):
    a, b = _twin(pristine, tmp_path)
    for p in (a, b):
        for name in ("00007.cols", "00000.cols.tmp"):
            with open(os.path.join(p, "immutable", name), "wb") as f:
                f.write(b"\x00junk")
    _ref1, r1 = _both(a, b, validate_all=False)  # a reader: noted, not applied
    assert r1.repairs is None and os.path.exists(os.path.join(b, "immutable", "00007.cols"))
    _ref2, r2 = _both(a, b, validate_all=True)
    assert r2.repairs == {"sweep-orphan-sidecar": 2}
    qfiles = os.listdir(os.path.join(b, "immutable", "quarantine"))
    assert {"00007.cols", "00000.cols.tmp"} <= set(qfiles)


def test_killed_sidecar_build_leaves_a_tmp_the_next_open_sweeps(tmp_path):
    src = str(tmp_path / "src")
    port_forge_child(src, "sigkill@build:1")
    assert os.path.exists(os.path.join(src, "immutable", "00001.cols.tmp"))
    a, b = _twin(src, tmp_path)
    sidecar.reset_counters()
    _ref_res, got = _both(a, b, validate_all="stream")
    assert got.opened_dirty and got.n_valid == N_BLOCKS
    assert got.repairs == {"dirty-open-escalated": 1, "sweep-orphan-sidecar": 1}
    assert sidecar.counters()["rebuilt"] == N_CHUNKS - 1  # the chunks the kill left unsealed
    assert pguard.was_clean_shutdown(b)
