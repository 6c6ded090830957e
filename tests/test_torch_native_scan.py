"""The port's native chunk scan (ouroboros_consensus_tpu_torch/native_scan.py)
against the JAX package's (native_loader.py), on the chunks of a 48-block
chain forged by the JAX package: every column of `extract_headers`, the
index parse, `MalformedBlock.index` and `crc32_first_bad` on a truncated
block and a flipped byte, exactly equal; and a failed build raises."""

import dataclasses
import subprocess

import numpy as np
import pytest
import torch

from torch_port_chain import N_BLOCKS, forge

from ouroboros_consensus_tpu import native_loader as rnl
from ouroboros_consensus_tpu_torch import native_scan
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB, index_name

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["bc", "draft03"])
def chunks(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    forge(path, draft03=request.param == "draft03")
    imm = ImmutableDB(f"{path}/immutable")
    out = [(imm.read_chunk(n), entries) for n, entries in imm.chunk_entries()]
    assert sum(len(e) for _, e in out) == N_BLOCKS and len(out) > 1
    return imm, out


def _offsets(entries):
    return np.asarray([e.offset for e in entries], np.int64)


def test_extract_headers_matches_reference(chunks):
    _, chunk_list = chunks
    for data, entries in chunk_list:
        got = native_scan.extract_headers(data, _offsets(entries))
        ref = rnl.extract_headers(data, _offsets(entries))
        for f in dataclasses.fields(ref):
            want = getattr(ref, f.name)
            have = getattr(got, f.name)
            if isinstance(want, np.ndarray):
                assert have.dtype == want.dtype and np.array_equal(have, want), f.name
            else:
                assert have == want, f.name
        for name in ("ocert_sigma", "kes_sig", "signed_bytes"):
            assert getattr(got, name) == getattr(ref, name), name
            assert np.array_equal(getattr(got, name + "_mat"), getattr(ref, name + "_mat"))


def test_parse_index_matches_reference(chunks):
    imm, _ = chunks
    for n in imm._chunks:
        with open(f"{imm.path}/{index_name(n)}", "rb") as f:
            data = f.read()
        for buf in (data, data[:-7]):  # whole, and torn in its last entry
            got = native_scan.parse_index(buf)
            ref = rnl.parse_index(buf)
            assert len(got[0]) == len(ref[0]) == len(imm._entries[n]) - (buf is not data)
            for g, r in zip(got, ref):
                assert np.array_equal(g, r)


def test_malformed_block_index(chunks):
    _, chunk_list = chunks
    data, entries = chunk_list[0]
    offs = _offsets(entries)
    k = len(entries) // 2
    e = entries[k]
    truncated = data[: e.offset + e.size // 2]  # block k cut in half
    bad_head = bytearray(data)
    bad_head[e.offset] ^= 0x01  # the block's [header, txs] array head
    for buf, offsets in ((truncated, offs[: k + 1]), (bytes(bad_head), offs)):
        with pytest.raises(native_scan.MalformedBlock) as got:
            native_scan.extract_headers(buf, offsets)
        with pytest.raises(rnl.MalformedBlock) as ref:
            rnl.extract_headers(buf, offsets)
        assert got.value.index == ref.value.index == k


def test_crc32_first_bad_matches_reference(chunks):
    _, chunk_list = chunks
    data, entries = chunk_list[0]
    cols = ([e.offset for e in entries], [e.size for e in entries],
            [e.crc32 for e in entries])
    k = len(entries) // 2
    flipped = bytearray(data)
    flipped[entries[k].offset + 7] ^= 0x40
    truncated = data[: entries[k].offset + 3]
    for buf, want in ((data, -1), (bytes(flipped), k), (truncated, k)):
        assert native_scan.crc32_first_bad(buf, *cols) == rnl.crc32_first_bad(buf, *cols) \
            == want


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_scan, "_lib", None)
    monkeypatch.setattr(native_scan, "SRC", str(bad))
    monkeypatch.setattr(native_scan, "SO", str(tmp_path / "libbroken.so"))
    with pytest.raises(subprocess.CalledProcessError):
        native_scan.lib()
    assert not (tmp_path / "libbroken.so").exists()
