"""The port's columnar sidecar (ouroboros_consensus_tpu_torch/storage/
sidecar.py) against the JAX package's, on the CPU, over the 48-block
chain that the JAX synthesizer forges (it seals a walked `.cols` file for
every chunk): `build_bytes` gives the reference's bytes for every chunk,
uniform or not, walked or not; `load_sidecar` gives the reference's
outcome on the same files, each package's files read by both, clean and
mutated (missing, a chunk byte or a payload byte flipped, a wrong entry
count, a truncated file, a bad magic); `pieces` equals the scan's
`ViewColumns.pieces_from_header_columns` and the reference's pieces; the
body-hash hook stops where the reference's does on a body corrupted under
a good CRC; and `native.crc32` is zlib's."""

import os
import shutil
import zlib

import numpy as np
import pytest

from torch_port_chain import forge

from ouroboros_consensus_tpu import native_loader as rnl
from ouroboros_consensus_tpu.storage import sidecar as rsc
from ouroboros_consensus_tpu.utils.fs import REAL_FS
from ouroboros_consensus_tpu_torch import native, native_scan
from ouroboros_consensus_tpu_torch.protocol.views import ViewColumns
from ouroboros_consensus_tpu_torch.storage import sidecar as psc
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The forged chain's immutable directory and its chunks: (n, bytes,
    index entries)."""
    path = str(tmp_path_factory.mktemp("chain") / "db")
    forge(path)
    imm = ImmutableDB(os.path.join(path, "immutable"))
    chunks = [(n, imm.read_chunk(n), entries) for n, entries in imm.chunk_entries()]
    assert len(chunks) >= 3
    return imm.path, chunks


def _offsets(entries):
    return np.asarray([e.offset for e in entries], np.int64)


def test_crc32_is_zlibs():
    rng = np.random.default_rng(3)
    for n in (0, 1, 15, 16, 17, 63, 64, 65, 255, 4096, 65_537):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1, 0xFFFFFFFF, 0x1234_5678):
            assert native.crc32(data, seed) == zlib.crc32(data, seed), (n, seed)


@pytest.mark.parametrize("walked", [True, False], ids=["walked", "unwalked"])
def test_build_bytes_equals_reference(chain, walked):
    imm_path, chunks = chain
    flags = set()
    for n, data, entries in chunks:
        got = psc.build_bytes(native_scan.extract_headers(data, _offsets(entries)), data,
                              walked=walked)
        want = rsc.build_bytes(rnl.extract_headers(data, _offsets(entries)), data,
                               walked=walked)
        assert got is not None and got == want, n
        flags.add(psc._HEADER.unpack_from(got)[2])
        if walked:  # the forge's own file
            with open(os.path.join(imm_path, psc.sidecar_name(n)), "rb") as f:
                assert f.read() == got, n
    uniform = psc.FLAG_UNIFORM | (psc.FLAG_WALKED if walked else 0)
    assert {uniform, uniform & ~psc.FLAG_UNIFORM} <= flags  # uniform chunks and not


def test_layout_constants_equal_reference():
    assert (psc.MAGIC, psc.VERSION, psc.FLAG_UNIFORM, psc.FLAG_WALKED) == (
        rsc.MAGIC, rsc.VERSION, rsc.FLAG_UNIFORM, rsc.FLAG_WALKED)
    assert psc._HEADER.format == rsc._HEADER.format
    assert psc._FIXED_COLS == rsc._FIXED_COLS
    assert psc.LAYOUT_DIGEST == rsc.LAYOUT_DIGEST


def _mutate(path: str, n: int, data: bytes, entries: list, case: str):
    """One chunk's sidecar file (or the chunk bytes it is probed against)
    in the state `case` names -> (chunk bytes, entry count) to probe
    with."""
    p = os.path.join(path, psc.sidecar_name(n))
    raw = bytearray(open(p, "rb").read())
    count = len(entries)
    if case == "missing":
        os.remove(p)
        return data, count
    if case == "chunk_byte":
        mutated = bytearray(data)
        mutated[entries[-1].offset + 3] ^= 0x01
        return bytes(mutated), count
    if case == "payload_byte":
        raw[psc.HEADER_SIZE + 5] ^= 0x01
    elif case == "entry_count":
        count -= 1
    elif case == "truncated":
        raw = raw[: len(raw) - 7]
    elif case == "bad_magic":
        raw[:8] = b"OCTCOLS0"
    with open(p, "wb") as f:
        f.write(bytes(raw))
    return data, count


CASES = {"clean": "hit", "missing": "miss", "chunk_byte": "stale",
         "payload_byte": "stale", "entry_count": "stale", "truncated": "torn",
         "bad_magic": "torn"}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_load_sidecar_outcome_equals_reference(chain, tmp_path, writer, case):
    imm_path, chunks = chain
    d = str(tmp_path / "imm")
    shutil.copytree(imm_path, d)
    for n, data, entries in chunks:
        if writer == "port":  # the port's own file in place of the forge's
            os.remove(os.path.join(d, psc.sidecar_name(n)))
            hc = native_scan.extract_headers(data, _offsets(entries))
            assert psc.backfill(d, n, hc, data, walked=n % 2 == 0)
        probe, count = _mutate(d, n, data, entries, case)
        got, p_out = psc.load_sidecar(d, n, probe, count)
        want, r_out = rsc.load_sidecar(REAL_FS, d, n, probe, count)
        assert p_out == r_out == CASES[case], (n, p_out, r_out)
        assert (got is None) == (want is None) == (case != "clean")
        if got is not None:
            assert (got.n, got.uniform, got.walked) == (want.n, want.uniform, want.walked)
            for name, arr in got.arrays.items():
                assert np.array_equal(arr, want.arrays[name]), name
    assert sorted(f for f in os.listdir(d) if f.endswith(".tmp")) == []


def _fields(vc):
    return {f: np.asarray(getattr(vc, f)) for f in vc.__dataclass_fields__}


def test_pieces_equal_scan_pieces(chain):
    imm_path, chunks = chain
    widths = []
    for n, data, entries in chunks:
        sc, outcome = psc.load_sidecar(imm_path, n, data, len(entries))
        assert outcome == "hit" and sc.walked
        got = sc.pieces(data)
        want = ViewColumns.pieces_from_header_columns(
            native_scan.extract_headers(data, _offsets(entries)))
        rsc_cols, _ = rsc.load_sidecar(REAL_FS, imm_path, n, data, len(entries))
        ref = rsc_cols.pieces(data)
        assert len(got) == len(want) == len(ref) >= 1
        for g, w, r in zip(got, want, ref):
            gf, wf = _fields(g), _fields(w)
            assert gf.keys() == wf.keys()
            for f in gf:
                assert np.array_equal(gf[f], wf[f]), (n, f)
                assert np.array_equal(gf[f], np.asarray(getattr(r, f))), (n, f)
        widths.append(len(got))
    assert max(widths) > 1  # a chunk with width steps took the span gather


def test_integrity_hook_equals_reference_on_a_body_corrupted_under_a_good_crc(chain):
    """A flipped body byte (the CRC sweep, sealed to the index, would pass
    a re-sealed CRC): both hooks stop at that block; the hooks read the
    entries' spans only."""
    imm_path, chunks = chain
    n, data, entries = chunks[1]
    sc, _ = psc.load_sidecar(imm_path, n, data, len(entries))
    ref_sc, _ = rsc.load_sidecar(REAL_FS, imm_path, n, data, len(entries))
    assert psc.integrity_batch_hook(sc)(data, entries) == len(entries)
    for k in (0, len(entries) // 2, len(entries) - 1):
        bad = bytearray(data)
        bad[int(sc.arrays["header_end"][k])] ^= 0x01  # the body's first byte
        got = psc.integrity_batch_hook(sc)(bytes(bad), entries)
        want = rsc.integrity_batch_hook(ref_sc)(bytes(bad), entries)
        assert got == want == k
