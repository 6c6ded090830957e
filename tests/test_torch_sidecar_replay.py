"""The port's replay on the sidecar's tier 1, on the CPU, against the JAX
package: `revalidate` with the sidecar on and off (device="cpu" and the
native backend) on the bc, draft-03 and mixed 48-block chains, each held
to the reference's sequential host fold, with the outcome counters
(every chunk a `hit` on the forge's walked seals, none read without the
sidecar) and the directory's files unchanged by the replay (it never
writes a sidecar). A header corrupted and then sealed again unwalked
rides the hit path to the reference's error; an unusable seal (stale,
torn or missing) falls back to the scan. And the probe of a walked
seal's trust: an index entry whose CRC changed while the chunk bytes did
not is not read on the hit path, in the port as in the reference's
`_stream_windows`; the scan path ends the chain there, in both."""

import hashlib
import os
import shutil

import pytest
import torch

from torch_port_chain import (MID, N_BLOCKS, PARAMS, assert_same_replay, corrupt_copy,
                              forge, reference)

from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu_torch import carry, native_scan
from ouroboros_consensus_tpu_torch.storage import sidecar
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB, index_name
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda
from ouroboros_consensus_tpu_torch.utils import cbor

torch.set_num_threads(1)

PPARAMS = carry.params_from_reference(PARAMS)
SWITCH = 24  # the mixed chain's first batch-compatible block


def counted(path: str, lview, backend: str, **kw):
    """The port's read-only replay (validate_all="stream", unless `kw`
    says otherwise), with the sidecar outcomes it counted."""
    kw.setdefault("validate_all", "stream")
    sidecar.reset_counters()
    res = pda.revalidate(path, PPARAMS, carry.lview_from_reference(lview), backend=backend,
                         max_batch=16, device="cpu" if backend == "device" else None, **kw)
    return res, {k: v for k, v in sidecar.counters().items() if v}


def chunk_count(path: str) -> int:
    return len(list(ImmutableDB(os.path.join(path, "immutable")).chunk_entries()))


def files(path: str) -> dict:
    """Every file under `path` with the digest of its bytes."""
    out = {}
    for root, _dirs, names in os.walk(path):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = hashlib.sha256(f.read()).hexdigest()
    return out


def chunk_of(path: str, index: int) -> tuple[int, int]:
    """(chunk number, position in it) of the chain's header `index`."""
    for n, entries in ImmutableDB(os.path.join(path, "immutable")).chunk_entries():
        if index < len(entries):
            return n, index
        index -= len(entries)
    raise IndexError(index)


@pytest.fixture(scope="module", params=["bc", "draft03", "mixed"])
def chain(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    if request.param == "mixed":
        _, lview = jds.make_credentials(1, kes_depth=PARAMS.kes_depth)
        synth.synthesize(path, PPARAMS, [synth.make_pool(0, kes_depth=PARAMS.kes_depth)],
                         carry.lview_from_reference(lview), N_BLOCKS, chunk_size=24,
                         proof_format=lambda n: 80 if n < SWITCH else 128)
    else:
        lview = forge(path, draft03=request.param == "draft03")
    ref = reference(path, lview)
    assert ref.n_valid == N_BLOCKS and ref.error is None
    return path, lview, ref


@pytest.fixture(scope="module")
def bc_chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bc") / "db")
    return path, forge(path)


@pytest.mark.parametrize("use_sidecar", [True, False], ids=["sidecar", "scan"])
@pytest.mark.parametrize("backend", ["device", "native"])
def test_replay_matches_host_fold_with_and_without_the_sidecar(chain, backend, use_sidecar):
    path, lview, ref = chain
    before = files(path)
    got, counts = counted(path, lview, backend, sidecar=use_sidecar)
    assert_same_replay(ref, got)
    assert counts == ({"hit": chunk_count(path)} if use_sidecar else {})
    assert files(path) == before


def reseal(path: str, n: int, walked: bool) -> None:
    """Seal chunk n's sidecar again from its live bytes."""
    imm = ImmutableDB(os.path.join(path, "immutable"))
    entries = dict(imm.chunk_entries())[n]
    data = imm.read_chunk(n)
    hc = native_scan.extract_headers(data, [e.offset for e in entries])
    assert sidecar.backfill(imm.path, n, hc, data, walked=walked)


# field -> (the error the replay stops with, whether the header is KES-signed again)
RESEALED = {
    "kes_sig": ("InvalidKesSignatureOCERT", False),
    "vrf_proof": ("VRFKeyBadProof", True),
}


@pytest.mark.parametrize("field", sorted(RESEALED))
def test_corrupt_header_sealed_again_unwalked_rides_the_hit_path(bc_chain, tmp_path, field):
    path, lview = bc_chain
    dst = str(tmp_path / "db")
    expect, resign = RESEALED[field]
    corrupt_copy(path, dst, field, resign=resign)
    n, _k = chunk_of(dst, MID)
    reseal(dst, n, walked=False)
    got, counts = counted(dst, lview, "device")
    assert set(counts) == {"hit"}  # the reseal is fresh; the others are the forge's
    ref = reference(dst, lview)
    assert ref.n_valid == MID and type(ref.error).__name__ == expect
    assert_same_replay(ref, got)


def _spoil(path: str, n: int, case: str) -> None:
    p = os.path.join(path, "immutable", sidecar.sidecar_name(n))
    if case == "miss":
        os.remove(p)
        return
    raw = bytearray(open(p, "rb").read())
    if case == "stale":
        raw[sidecar.HEADER_SIZE + 9] ^= 0x01  # the payload no longer matches its seal
    else:
        raw = raw[: sidecar.HEADER_SIZE + 3]
    with open(p, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("case,backend", [("stale", "device"), ("stale", "native"),
                                          ("torn", "native"), ("miss", "native")])
def test_unusable_seal_falls_back_to_the_scan(bc_chain, tmp_path, case, backend):
    path, lview = bc_chain
    dst = str(tmp_path / "db")
    shutil.copytree(path, dst)
    _spoil(dst, 1, case)
    before = files(dst)
    got, counts = counted(dst, lview, backend)
    assert counts == {"hit": chunk_count(dst) - 1, case: 1}
    assert files(dst) == before  # read-only: nothing rebuilt
    ref = reference(dst, lview)
    assert ref.n_valid == N_BLOCKS
    assert_same_replay(ref, got)


def _reference_blocks(path: str, monkeypatch, use_sidecar: bool) -> int:
    """The blocks the reference's read-only stream-deep `_stream_windows`
    yields (its OCT_SIDECAR=0 lever for the scan path)."""
    with monkeypatch.context() as mp:
        if not use_sidecar:
            mp.setenv("OCT_SIDECAR", "0")
        imm = jda.open_immutable(path, validate_all="stream")
        res = jda.ValidationResult()
        for _win in jda._stream_windows(imm, res):
            pass
    return res.n_blocks


def test_index_crc_change_under_a_walked_seal_follows_the_reference(bc_chain, tmp_path,
                                                                    monkeypatch):
    path, lview = bc_chain
    dst = str(tmp_path / "db")
    shutil.copytree(path, dst)
    n, k = chunk_of(dst, MID)
    imm = ImmutableDB(os.path.join(dst, "immutable"))
    rows = [e.to_cbor_obj() for e in dict(imm.chunk_entries())[n]]
    rows[k][5] ^= 0x01  # the chunk's bytes, and so its walked seal, unchanged
    with open(os.path.join(imm.path, index_name(n)), "wb") as f:
        f.write(b"".join(cbor.encode(r) for r in rows))
    before = files(dst)
    hit, counts = counted(dst, lview, "native")
    assert counts == {"hit": chunk_count(dst)}
    scan, _ = counted(dst, lview, "native", sidecar=False)
    assert (hit.n_blocks, hit.n_valid, hit.error) == (N_BLOCKS, N_BLOCKS, None)
    assert (scan.n_blocks, scan.n_valid, scan.error) == (MID, MID, None)
    assert _reference_blocks(dst, monkeypatch, True) == hit.n_blocks
    assert _reference_blocks(dst, monkeypatch, False) == scan.n_blocks
    assert files(dst) == before
