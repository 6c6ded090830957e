"""The port's `revalidate` keywords that bench.py's replay protocol uses
(tools/db_analyser.py of the port against the JAX package's, :577-606):
`max_headers`, `validate_all` (True, the default, "stream" and False),
`collect_phases` and `trace`, on the 48-block test chain the JAX
synthesizer forges."""

import os
import shutil
from itertools import accumulate

import pytest
import torch

from torch_port_chain import CHUNK, N_BLOCKS, PARAMS, forge

from ouroboros_consensus_tpu.protocol import batch as rbatch
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB, chunk_name
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

MAX_BATCH = 16


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    torch.set_num_threads(1)
    path = str(tmp_path_factory.mktemp("surface") / "db")
    return path, forge(path)


def _port(path, lview, backend="device", **kw):
    return pda.revalidate(path, carry.params_from_reference(PARAMS),
                          carry.lview_from_reference(lview), backend=backend,
                          max_batch=MAX_BATCH,
                          device="cpu" if backend == "device" else None, **kw)


def _ref(path, lview, **kw):
    return jda.revalidate(path, PARAMS, lview, backend="host", **kw)


def _same(ref, got, blocks: bool = True) -> None:
    assert got.n_valid == ref.n_valid
    assert carry.error_to_plain(got.error) == carry.error_to_plain(ref.error)
    assert carry.state_to_plain(got.final_state) == carry.state_to_plain(ref.final_state)
    if blocks:
        assert got.n_blocks == ref.n_blocks


def _reference_windows(path: str, max_headers=None) -> list[int]:
    """The JAX package's own window cut of its replay: its window stream
    (capped as its revalidate caps it), cut into epoch segments, each cut
    at max_batch and at a proof-format change -> the windows' lengths."""
    imm = jda.open_immutable(path, validate_all="stream")
    wins = jda._stream_windows(imm, jda.ValidationResult())
    if max_headers is not None:
        wins = jda._cap_windows(wins, max_headers)
    out = []
    for seg in jda._epoch_window_segments(PARAMS, wins):
        for _e, i, end in rbatch._epoch_segments_idx(PARAMS, seg):
            while i < end:
                j = rbatch._proof_break(seg, i, min(i + MAX_BATCH, end))
                out.append(j - i)
                i = j
    return out


def _cases(path):
    ends = list(accumulate(_reference_windows(path)))
    return {"window_edge": ends[1], "mid_window": ends[2] - 3, "past_chain": N_BLOCKS + 100}


@pytest.mark.parametrize("where", ["window_edge", "mid_window", "past_chain"])
def test_max_headers_matches_reference(chain, where):
    path, lview = chain
    cap = _cases(path)[where]
    ref = _ref(path, lview, validate_all="stream", max_headers=cap)
    assert ref.n_blocks == min(cap, N_BLOCKS) and ref.error is None
    _same(ref, _port(path, lview, backend="native", max_headers=cap))
    if where != "past_chain":  # the device replay past the chain: below
        _same(ref, _port(path, lview, max_headers=cap))


def test_max_headers_collects_the_reference_cut(chain):
    path, lview = chain
    cap = _cases(path)["mid_window"]
    got = _port(path, lview, max_headers=cap, collect_phases=True)
    want = _reference_windows(path, cap)
    assert sum(want) == cap
    assert (got.n_windows, got.packed_windows) == (len(want), len(want))


def test_collect_phases_counts_the_reference_windows(chain):
    """The whole chain on the device path, its cap past the chain's end:
    the reference's result, and its window cut counted."""
    path, lview = chain
    got = _port(path, lview, collect_phases=True, max_headers=N_BLOCKS + 100)
    _same(_ref(path, lview, validate_all="stream", max_headers=N_BLOCKS + 100), got)
    want = _reference_windows(path)
    assert got.n_valid == N_BLOCKS and got.error is None
    assert got.n_windows == len(want) and got.packed_windows == len(want)
    assert set(got.phases) == {"read", "stage", "dispatch", "materialize", "epilogue"}
    assert all(v >= 0 for v in got.phases.values())
    # each window's packed columns up, its verdict words and carry back
    assert got.h2d_bytes > N_BLOCKS * 500
    assert got.d2h_bytes >= len(want) * (5 * 8 + 66)
    native = _port(path, lview, backend="native", collect_phases=True)
    assert native.n_windows == 0 and set(native.phases) == {"read"}
    assert _port(path, lview, backend="native").phases is None


def test_trace_is_called_per_segment(chain):
    path, lview = chain
    lines = []
    got = _port(path, lview, backend="native", trace=lines.append)
    assert lines and lines[-1] == f"validated {N_BLOCKS} headers"
    assert got.n_valid == N_BLOCKS


def test_open_is_timed_inside_the_read(chain):
    """`open_s`, the store's open (every index loaded), lies inside
    `read_s` and the wall; bench.py's prefix baseline leaves it out."""
    path, lview = chain
    got = _port(path, lview, backend="native", max_headers=10)
    assert 0 < got.open_s <= got.read_s <= got.wall_s


def test_validate_all_unknown_value_raises(chain):
    path, lview = chain
    with pytest.raises(ValueError, match="validate_all"):
        _port(path, lview, validate_all="deep")


def _flip_unsealed(src: str, dst: str, index: int) -> None:
    """Copy the chain and flip a byte near the end of block `index`'s
    header (a KES sibling key) without updating its index CRC: a
    storage check catches it, a replay that skips the check fails the
    header's KES signature. (The read is the same on both backends; the
    native one replays.)"""
    shutil.copytree(src, dst)
    imm = ImmutableDB(os.path.join(dst, "immutable"), chunk_size=CHUNK)
    k = 0
    for n, entries in imm.chunk_entries():
        if k + len(entries) > index:
            e = entries[index - k]
            p = os.path.join(imm.path, chunk_name(n))
            data = bytearray(open(p, "rb").read())
            data[e.offset + e.size - 5] ^= 0x01
            open(p, "wb").write(bytes(data))
            return
        k += len(entries)
    raise AssertionError("index past the chain")


@pytest.mark.parametrize("validate_all", [True, "stream", False])
def test_validate_all_clean_chain(chain, validate_all):
    path, lview = chain
    ref = _ref(path, lview, validate_all=validate_all)
    assert ref.n_valid == N_BLOCKS
    _same(ref, _port(path, lview, backend="native", validate_all=validate_all))


@pytest.mark.parametrize("validate_all", [True, "stream", False])
@pytest.mark.parametrize("where", ["middle", "last"])
def test_validate_all_on_an_unsealed_flip(chain, tmp_path, validate_all, where):
    """In a middle chunk: the deep open's and the stream's CRC sweeps end
    the chain before the block (the deep open cuts the store there on
    disk), a shallow read replays it and fails its KES signature. In the
    most recent chunk all three end the chain there. Each package
    replays a twin copy."""
    path, lview = chain
    bad = 20 if where == "middle" else N_BLOCKS - 2
    db, twin = str(tmp_path / "db"), str(tmp_path / "twin")
    _flip_unsealed(path, db, bad)
    shutil.copytree(db, twin)
    ref = _ref(db, lview, validate_all=validate_all)
    got = _port(twin, lview, backend="native", validate_all=validate_all)
    assert ref.n_valid == bad
    assert (ref.error is None) == (validate_all in (True, "stream") or where == "last")
    _same(ref, got, blocks=ref.error is None)
    assert got.repairs == ref.repairs
