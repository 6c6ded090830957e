"""The port's db_truncater and the synthesizer's resume against the JAX
package's, on twin copies of the 48-block test chain: truncation after a
slot, the repair to the last valid block (dry run first), the refusal of
a virgin path, the lock held throughout, the dirty store whose rewind
runs the full repair walk, and the sidecars a repair invalidates and
seals again, each to the same report and the same directory bytes. And a
forge killed mid-way (a torn append raised in process, a real SIGKILL in
a child) and resumed gives the chunk, index and sidecar bytes of the
reference's uninterrupted forge, under the same markers."""

import os
import shutil

import pytest

from torch_port_chain import (N_BLOCKS, PARAMS, forge, forge_faulted, lview_of_chain,
                              port_forge_child, port_native, tree)

from ouroboros_consensus_tpu.tools import db_truncater as rtrunc
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.storage import guard as pguard
from ouroboros_consensus_tpu_torch.storage import sidecar
from ouroboros_consensus_tpu_torch.testing import chaos, synth
from ouroboros_consensus_tpu_torch.tools import db_synthesizer as pds
from ouroboros_consensus_tpu_torch.tools import db_truncater as ptrunc


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trunc") / "pristine")
    forge(path)
    return path


def _twin(src: str, tmp_path) -> tuple[str, str]:
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return a, b


def _corrupt_tail(db: str, chunk: int) -> None:
    with open(os.path.join(db, "immutable", f"{chunk:05d}.chunk"), "ab") as f:
        f.write(b"\x81\x18garbage-tail")


@pytest.mark.parametrize("slot", [None, 0, 30, 61, 10 ** 9])
def test_truncate_after_slot(pristine, tmp_path, slot):
    a, b = _twin(pristine, tmp_path)
    assert ptrunc.truncate(b, slot) == rtrunc.truncate(a, slot)
    assert tree(b) == tree(a)
    assert pguard.was_clean_shutdown(b)


@pytest.mark.parametrize("chunk", [1, 4])
def test_repair_to_last_valid_dry_run_then_repair(pristine, tmp_path, chunk):
    a, b = _twin(pristine, tmp_path)
    for p in (a, b):
        _corrupt_tail(p, chunk)
    before = tree(b)
    dry = ptrunc.repair(b, dry_run=True)
    assert dry == rtrunc.repair(a, dry_run=True)
    assert not dry["applied"] and dry["actions"]["truncate-chunk"] == 1
    assert tree(b) == before
    rep = ptrunc.repair(b)
    assert rep == rtrunc.repair(a)
    assert rep["applied"] and tree(b) == tree(a)
    # the rewrite's stale seal went to quarantine, and the repair sealed
    # the chunk again: every chunk that is left a hit after it
    qdir = os.path.join(b, "immutable", "quarantine")
    assert any(f.startswith(f"{chunk:05d}.cols") for f in os.listdir(qdir))
    left = [f for f in os.listdir(os.path.join(b, "immutable")) if f.endswith(".chunk")]
    assert len(left) == chunk + 1  # the chunks past the cut were dropped
    sidecar.reset_counters()
    got = port_native(b, lview_of_chain(), validate_all="stream")
    assert got.error is None and sidecar.counters()["hit"] == len(left)


def test_refuses_a_virgin_path(tmp_path):
    db = str(tmp_path / "virgin")
    with pytest.raises(FileNotFoundError):
        ptrunc.repair(db)
    with pytest.raises(FileNotFoundError):
        ptrunc.truncate(db, 3)
    assert not os.path.exists(db)


def test_holds_the_lock(pristine, tmp_path):
    db = str(tmp_path / "db")
    shutil.copytree(pristine, db)
    g = pguard.StoreGuard(db, writer=False).open()
    try:
        with pytest.raises(pguard.DbLocked):
            ptrunc.truncate(db, 30)
        with pytest.raises(pguard.DbLocked):
            ptrunc.repair(db)
    finally:
        g.close()


def test_dirty_slot_truncate_runs_the_full_repair_walk(tmp_path):
    src = str(tmp_path / "src")
    assert forge_faulted(src, "bitflip@append:5") is None  # rot in chunk 0
    a, b = _twin(src, tmp_path)
    for p in (a, b):
        pguard.clear_clean_marker(p)
    assert ptrunc.truncate(b, 10 ** 9) == rtrunc.truncate(a, 10 ** 9) == 5
    assert tree(b) == tree(a) and pguard.was_clean_shutdown(b)


def test_cli(pristine, tmp_path, capsys):
    db = str(tmp_path / "db")
    shutil.copytree(pristine, db)
    _corrupt_tail(db, 2)
    ptrunc.main(["--db", db, "--to-last-valid", "--dry-run"])
    assert "would repair" in capsys.readouterr().out
    ptrunc.main(["--db", db, "--truncate-after-slot", "40"])
    assert "blocks remain" in capsys.readouterr().out


def _immutable(path: str) -> dict:
    """The chain's chunk, index and sidecar bytes."""
    return {k: v for k, v in tree(os.path.join(path, "immutable")).items()
            if not k.startswith("quarantine")}


def test_fresh_forge_speaks_the_protocol(pristine, tmp_path):
    db = str(tmp_path / "db")
    port_forge_child(db)
    assert tree(db) == tree(pristine)  # markers, lock, chunks, indexes, sidecars
    with pytest.raises(RuntimeError, match="non-empty"):
        pds.synthesize(db, carry.params_from_reference(PARAMS),
                       [synth.make_pool(0, kes_depth=3)],
                       carry.lview_from_reference(lview_of_chain()),
                       pds.ForgeLimit(blocks=N_BLOCKS), chunk_size=24, engine="host")
    assert tree(db) == tree(pristine)  # the refusal touched nothing


def test_torn_forge_resumed_converges(pristine, tmp_path):
    db = str(tmp_path / "db")
    pparams = carry.params_from_reference(PARAMS)
    pool = synth.make_pool(0, kes_depth=3)
    kw = dict(chunk_size=24, engine="host")
    with pytest.raises(chaos.TornWriteChaos):
        pds.synthesize(db, pparams, [pool], synth.make_ledger_view([pool]),
                       pds.ForgeLimit(blocks=N_BLOCKS), chaos="torn-write@append:30", **kw)
    assert not pguard.was_clean_shutdown(db)
    res = pds.synthesize(db, pparams, [pool], synth.make_ledger_view([pool]),
                         pds.ForgeLimit(blocks=N_BLOCKS), resume=True, **kw)
    assert res.n_blocks == N_BLOCKS - 30
    assert _immutable(db) == _immutable(pristine)
    assert pguard.was_clean_shutdown(db)
    assert os.listdir(os.path.join(db, "immutable", "quarantine"))


@pytest.mark.parametrize("fault", ["sigkill@append:20", "sigkill@append:47"])
def test_killed_forge_resumed_is_byte_identical(pristine, tmp_path, fault):
    db = str(tmp_path / "db")
    port_forge_child(db, fault)
    assert not pguard.was_clean_shutdown(db)
    port_forge_child(db, resume=True)
    assert _immutable(db) == _immutable(pristine)
    assert pguard.was_clean_shutdown(db)
