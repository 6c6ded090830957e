"""The port's window pipeline and segment prefetch, on the CPU (device=
"cpu": the same loop and staging thread, no pinned memory), against the
JAX package's sequential host fold. `validate_chain` at pipeline_depth 1
(the serial loop) and 3 over the 48-block chain's HeaderViews with a run
of stand-in-body headers in the middle (generic windows between packed
ones; the chain's first windows step in body width and are generic
too), clean and with a KES signature flipped in the first, a generic, a
middle and the last window; `revalidate` with the prefetch on and off,
clean and corrupted. An exception raised on the staging thread or on
the prefetch thread reaches the caller, and no thread of either outlives
a replay that stops early."""

import dataclasses
import re
import threading

import numpy as np
import pytest
import torch

from torch_port_chain import (MID, N_BLOCKS, PARAMS, assert_same_replay, corrupt_copy,
                              forge, ref_view, reference)

from ouroboros_consensus_tpu.protocol import batch as rbatch
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu_torch import native_scan
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol.praos import PraosState
from ouroboros_consensus_tpu_torch.protocol.views import ViewColumns
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB
from ouroboros_consensus_tpu_torch.testing import corrupt, synth
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)

PPARAMS = carry.params_from_reference(PARAMS)
STANDIN = range(29, 37)  # one window of stand-in bodies: staged generically
THREADS = ("validate-stage", "revalidate-prefetch")
ETA = b"\x07" * 32


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    return path, forge(path)


@pytest.fixture(scope="module")
def views(chain):
    path, lview = chain
    hvs = pda.read_header_views(path)
    pool = synth.make_pool(0, kes_depth=PARAMS.kes_depth)
    hvs[STANDIN.start: STANDIN.stop] = corrupt.standin_views(
        hvs[STANDIN.start: STANDIN.stop], PPARAMS, pool)
    return hvs, lview


def _host_fold(hvs, lview):
    st = rpraos.PraosState()
    for i, hv in enumerate(hvs):
        ticked = rpraos.tick(PARAMS, lview, hv.slot, st)
        try:
            st = rpraos.update(PARAMS, hv, hv.slot, ticked)
        except rpraos.PraosValidationError as e:
            return i, e, st
    return len(hvs), None, st


def _ours() -> set:
    return {t for t in threading.enumerate() if t.name.startswith(THREADS)}


@pytest.mark.parametrize("lo,hi,cols", [(40, 48, False), (40, 45, False), (37, 48, False),
                                        (37, 48, True)],
                         ids=["full-bucket", "padded", "wider-bucket", "columns"])
def test_staging_matches_reference_padding(chain, views, lo, hi, cols):
    """prepare_window's padding into the staging buffer, the card's and
    the CPU's one path, equals the reference's pad_packed_to of the same
    staged columns; pad_packed_to equals it too, and upload_staged puts
    the same columns on the device."""
    hvs, lview = views
    plview = carry.lview_from_reference(lview)
    window = hvs[lo:hi]
    if cols:
        path, _ = chain
        imm = ImmutableDB(f"{path}/immutable")
        pieces = []
        for n, entries in imm.chunk_entries():
            offs = np.asarray([e.offset for e in entries], np.int64)
            pieces += ViewColumns.pieces_from_header_columns(
                native_scan.extract_headers(imm.read_chunk(n), offs))
        width = pieces[-1].signed_bytes.shape[1]
        tail = ViewColumns.concat([p for p in pieces if p.signed_bytes.shape[1] == width])
        window = tail[len(tail) - (hi - lo):]
    buf = pbatch.staging_buffer(PPARAMS, window, torch.device("cpu"))
    sw = pbatch.prepare_window(PPARAMS, plview, ETA, window, buf)
    assert sw.layout is not None and sw.buf is buf
    pre = pbatch.host_prechecks(PPARAMS, plview, window)
    if cols:
        _, packed = pbatch.stage_packed_columns(PPARAMS, plview, ETA, window, pre)
    else:
        _, packed = pbatch.stage_packed(PPARAMS, plview, ETA, window)
    size = pbatch.bucket_size(len(window))
    want = rbatch.pad_packed_to(rbatch.PraosPacked(*packed), size)
    loose = pbatch.pad_packed_to(packed, size)
    up = pbatch.upload_staged(sw.packed, buf, torch.device("cpu"))
    for name, w, staged, lp, u in zip(pbatch.Packed._fields, want, sw.packed, loose, up):
        assert staged.dtype == w.dtype and np.array_equal(staged, w), name
        assert np.shares_memory(staged, buf.numpy()), name
        assert lp.dtype == w.dtype and np.array_equal(lp, w), name
        assert torch.equal(u, torch.from_numpy(np.ascontiguousarray(w))), name


@pytest.mark.parametrize("bad", [None, 1, 20, 31, 46],
                         ids=["clean", "first", "middle", "generic", "last"])
@pytest.mark.parametrize("depth", [1, 3])
def test_validate_chain_matches_host_fold(views, monkeypatch, depth, bad):
    hvs, lview = views
    hvs = list(hvs)
    if bad is not None:
        sig = bytearray(hvs[bad].kes_sig)
        sig[-1] ^= 0x01
        hvs[bad] = dataclasses.replace(hvs[bad], kes_sig=bytes(sig))
    seen = []
    dispatch = pbatch.dispatch_prepared

    def spy(sw, device, carry_in=None):
        v = dispatch(sw, device, carry_in)
        seen.append(v.carried)
        return v

    monkeypatch.setattr(pbatch, "dispatch_prepared", spy)
    got = pbatch.validate_chain(PPARAMS, lambda _e: carry.lview_from_reference(lview),
                                PraosState(), hvs, max_batch=8, device="cpu",
                                pipeline_depth=depth)
    n, err, st = _host_fold([ref_view(h) for h in hvs], lview)
    assert got.n_valid == n == (N_BLOCKS if bad is None else bad)
    assert carry.error_to_plain(got.error) == carry.error_to_plain(err)
    assert carry.state_to_plain(got.state) == carry.state_to_plain(
        carry.state_from_reference(st))
    if bad is None:  # a generic window (no carry) between packed ones
        assert re.search("pg+p", "".join("p" if c else "g" for c in seen))
    assert _ours() == set()


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "inline"])
@pytest.mark.parametrize("field", [None, "kes_sig"], ids=["clean", "kes_sig"])
def test_revalidate_matches_host_fold(chain, tmp_path, prefetch, field):
    path, lview = chain
    if field is not None:
        dst = str(tmp_path / "db")
        corrupt_copy(path, dst, field)
        path = dst
    got = pda.revalidate(path, PPARAMS, carry.lview_from_reference(lview),
                         max_batch=16, device="cpu", prefetch=prefetch)
    ref = reference(path, lview)
    assert ref.n_valid == (N_BLOCKS if field is None else MID)
    assert_same_replay(ref, got)
    assert got.read_s > 0 and got.wait_s > 0 and got.validate_s > 0
    assert got.wall_s >= got.validate_s + got.wait_s
    assert _ours() == set()


def test_staging_thread_exception_reaches_the_caller(views, monkeypatch):
    hvs, lview = views
    calls = []
    prepare = pbatch.prepare_window

    def failing(*args, **kw):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise RuntimeError("staging failed")
        return prepare(*args, **kw)

    monkeypatch.setattr(pbatch, "prepare_window", failing)
    # with the recovery ladder off: on, it would validate the window again
    with pytest.raises(RuntimeError, match="staging failed"):
        pbatch.validate_chain(PPARAMS, lambda _e: carry.lview_from_reference(lview),
                              PraosState(), hvs[:16], max_batch=4, device="cpu",
                              pipeline_depth=3,
                              supervisor=recovery.RecoverySupervisor(enabled=False))
    assert calls and all(name.startswith("validate-stage") for name in calls)
    assert _ours() == set()


def test_prefetch_thread_exception_reaches_the_caller(chain, monkeypatch):
    path, lview = chain
    read = ImmutableDB.read_chunk
    readers = []

    def failing(self, n):
        readers.append(threading.current_thread().name)
        if n == 2:
            raise OSError("chunk unreadable")
        return read(self, n)

    monkeypatch.setattr(ImmutableDB, "read_chunk", failing)
    with pytest.raises(OSError, match="chunk unreadable"):
        pda.revalidate(path, PPARAMS, carry.lview_from_reference(lview), max_batch=16,
                       device="cpu", prefetch=True)
    assert readers and all(name == "revalidate-prefetch" for name in readers)
    assert _ours() == set()


def test_prefetch_iter_stops_early_without_blocking():
    """The consumer takes one item of a long stream and stops: the pump
    (blocked on the full queue) is stopped and joined."""
    produced = []

    def stream():
        for i in range(1000):
            produced.append(i)
            yield i

    it = pda._prefetch_iter(stream(), depth=2)
    assert next(it) == 0
    it.close()
    assert _ours() == set()
    assert len(produced) < 10
