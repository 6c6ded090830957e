"""The port's VolatileDB (storage/volatile.py) against the JAX package's:
the same puts give byte-identical files, each package opens the other's
files to the same index (block info, successor map), GC removes the same
files, and a torn or corrupted tail is cut at the same record."""

import os
import struct

import pytest

from torch_ledger_common import forge_chain, port_block

from ouroboros_consensus_tpu.storage.volatile import VolatileDB as JVolatileDB
from ouroboros_consensus_tpu_torch.storage.volatile import VolatileDB as PVolatileDB

BLOCKS = forge_chain(8)
FORK = forge_chain(3, start_slot=20, start_bno=3, prev=BLOCKS[2].hash_, pool_ix=1)


def _files(path: str) -> dict:
    out = {}
    for f in sorted(os.listdir(path)):
        with open(os.path.join(path, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _index(db) -> dict:
    hashes = sorted(db.all_hashes())
    return {
        "info": [tuple(vars(db.get_block_info(h)).values()) for h in hashes],
        "bytes": [db.get_block_bytes(h) for h in hashes],
        "succ": {p: sorted(db.filter_by_predecessor(p))
                 for p in [None] + [db.get_block_info(h).hash_ for h in hashes]},
    }


def _fill(cls, path, blocks, per_file, conv=lambda b: b):
    db = cls(path, max_blocks_per_file=per_file)
    for b in blocks:
        db.put_block(conv(b))
        db.put_block(conv(b))  # idempotent
    return db


@pytest.mark.parametrize("per_file", [1, 3, 100])
def test_same_puts_give_the_same_files_and_index(tmp_path, per_file):
    blocks = BLOCKS + FORK
    j = _fill(JVolatileDB, str(tmp_path / "j"), blocks, per_file)
    p = _fill(PVolatileDB, str(tmp_path / "p"), blocks, per_file, port_block)
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "j"))
    assert _index(p) == _index(j)
    assert p.filter_by_predecessor(BLOCKS[2].hash_) == {BLOCKS[3].hash_, FORK[0].hash_}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    path = str(tmp_path / "vol")
    if writer == "jax":
        _fill(JVolatileDB, path, BLOCKS + FORK, 3)
    else:
        _fill(PVolatileDB, path, BLOCKS + FORK, 3, port_block)
    j, p = JVolatileDB(path, max_blocks_per_file=3), PVolatileDB(path, max_blocks_per_file=3)
    assert _index(p) == _index(j)
    assert {p.decode_block(p.get_block_bytes(b.hash_)).hash_ for b in BLOCKS} == \
        {b.hash_ for b in BLOCKS}


@pytest.mark.parametrize("gc_slot", [0, 4, 7, 30])
def test_gc_removes_the_same_files(tmp_path, gc_slot):
    j = _fill(JVolatileDB, str(tmp_path / "j"), BLOCKS + FORK, 3)
    p = _fill(PVolatileDB, str(tmp_path / "p"), BLOCKS + FORK, 3, port_block)
    j.garbage_collect(gc_slot)
    p.garbage_collect(gc_slot)
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "j"))
    assert _index(p) == _index(j)
    # and the stores go on the same way after it
    more = forge_chain(2, start_slot=40, start_bno=8, prev=BLOCKS[-1].hash_)
    for b in more:
        j.put_block(b)
        p.put_block(port_block(b))
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "j"))


def _tear(path: str, how: str) -> None:
    f = os.path.join(path, "blocks-0000.dat")
    with open(f, "rb") as fh:
        data = bytearray(fh.read())
    if how == "torn":
        data = data[:-5]
    elif how == "crc":
        data[-3] ^= 0xFF
    else:  # a length past the end
        size = struct.unpack_from("<I", data, 0)[0]
        struct.pack_into("<I", data, 0, size + 10_000)
    with open(f, "wb") as fh:
        fh.write(bytes(data))


@pytest.mark.parametrize("how", ["torn", "crc", "length"])
def test_damaged_tail_is_cut_at_the_same_record(tmp_path, how):
    for name in ("j", "p"):
        path = str(tmp_path / name)
        _fill(JVolatileDB, path, BLOCKS[:3], 100)
        _tear(path, how)
    j = JVolatileDB(str(tmp_path / "j"))
    p = PVolatileDB(str(tmp_path / "p"))
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "j"))
    assert _index(p) == _index(j)
    assert len(list(p.all_hashes())) == (0 if how == "length" else 2)


@pytest.mark.parametrize("field", ["kes_sig", "vrf_proof"])
def test_flipped_byte_keeps_the_record_under_a_new_hash(tmp_path, field):
    """testing/corrupt.flip_volatile_byte: the record's CRC re-sealed, so
    both packages reopen the block, its header changed (a new hash), its
    successor's link broken."""
    from ouroboros_consensus_tpu_torch.testing.corrupt import flip_volatile_byte

    path = str(tmp_path / "vol")
    _fill(PVolatileDB, path, BLOCKS[:4], 100, port_block)
    new = flip_volatile_byte(path, BLOCKS[2].hash_, field)
    j, p = JVolatileDB(path), PVolatileDB(path)
    assert _index(p) == _index(j)
    assert set(p.all_hashes()) == {b.hash_ for b in BLOCKS[:4]} - {BLOCKS[2].hash_} | {new}
    assert p.filter_by_predecessor(BLOCKS[1].hash_) == {new}
    assert p.filter_by_predecessor(new) == set()
