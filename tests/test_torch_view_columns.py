"""The port's ViewColumns (protocol/views.py) against the JAX package's,
on the chunk scans of 48-block chains forged by the JAX package (bc and
draft-03 proofs): `from_header_columns`, `pieces_from_header_columns`,
`views()`, `concat`, `from_views` and indexing, column for column and
view for view; and `views()` against the port's own per-block parse
(`Block.from_bytes(...).header.to_view()`)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_chain import N_BLOCKS, forge, ref_view

from ouroboros_consensus_tpu import native_loader as rnl
from ouroboros_consensus_tpu.protocol import views as rviews
from ouroboros_consensus_tpu_torch import native_scan
from ouroboros_consensus_tpu_torch.block.praos_block import Block
from ouroboros_consensus_tpu_torch.protocol.views import ViewColumns
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["bc", "draft03"])
def scans(request, tmp_path_factory):
    """[(chunk bytes, entries, the port's HeaderColumns, the reference's)]."""
    path = str(tmp_path_factory.mktemp("chain") / "db")
    forge(path, draft03=request.param == "draft03")
    out = []
    imm = ImmutableDB(f"{path}/immutable")
    for n, entries in imm.chunk_entries():
        data = imm.read_chunk(n)
        offs = np.asarray([e.offset for e in entries], np.int64)
        out.append((data, entries, native_scan.extract_headers(data, offs),
                    rnl.extract_headers(data, offs)))
    assert sum(len(e) for _, e, _, _ in out) == N_BLOCKS
    return out


def assert_same_columns(got: ViewColumns, ref) -> None:
    for f in dataclasses.fields(ref):
        want, have = getattr(ref, f.name), getattr(got, f.name)
        assert have.shape == want.shape and np.array_equal(have, want), f.name


def test_from_header_columns_matches_reference(scans):
    for _, _, hc, rhc in scans:
        for lo, hi in ((0, None), (1, 5), (3, 4)):
            got = ViewColumns.from_header_columns(hc, lo, hi)
            ref = rviews.ViewColumns.from_header_columns(rhc, lo, hi)
            assert (got is None) == (ref is None)
            if ref is not None:
                assert_same_columns(got, ref)


def test_pieces_match_reference_and_cut_at_width_steps(scans):
    cuts = 0
    for _, _, hc, rhc in scans:
        got = ViewColumns.pieces_from_header_columns(hc)
        ref = rviews.ViewColumns.pieces_from_header_columns(rhc)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_same_columns(g, r)
        assert sum(len(p) for p in got) == hc.n
        cuts += len(got) - 1
        for p in got:
            assert len({len(hv.signed_bytes) for hv in p.views()}) == 1
    assert cuts > 0  # the chain's body width steps (its genesis header has no prev hash)


def test_views_match_reference_and_block_parse(scans):
    for data, entries, hc, rhc in scans:
        for got_vc, ref_vc in zip(ViewColumns.pieces_from_header_columns(hc),
                                  rviews.ViewColumns.pieces_from_header_columns(rhc)):
            views = got_vc.views()
            assert [ref_view(hv) for hv in views] == ref_vc.views()
            assert [got_vc[i] for i in range(len(got_vc))] == views
        parsed = [Block.from_bytes(data[e.offset: e.offset + e.size]).header.to_view()
                  for e in entries]
        pieces = ViewColumns.pieces_from_header_columns(hc)
        assert [hv for p in pieces for hv in p.views()] == parsed


def test_concat_and_from_views_match_reference(scans):
    parts = [p for _, _, hc, _ in scans for p in ViewColumns.pieces_from_header_columns(hc)]
    rparts = [p for _, _, _, rhc in scans
              for p in rviews.ViewColumns.pieces_from_header_columns(rhc)]
    by_width: dict = {}
    for k, p in enumerate(parts):
        by_width.setdefault(p.signed_bytes.shape[1], []).append(k)
    same = max(by_width.values(), key=len)
    assert len(same) > 1
    got = ViewColumns.concat([parts[k] for k in same])
    ref = rviews.ViewColumns.concat([rparts[k] for k in same])
    assert_same_columns(got, ref)
    assert got.views() == [hv for k in same for hv in parts[k].views()]
    # widths that differ do not concatenate
    other = next(k for ks in by_width.values() for k in ks if k not in same)
    assert ViewColumns.concat([parts[same[0]], parts[other]]) is None
    assert rviews.ViewColumns.concat([rparts[same[0]], rparts[other]]) is None
    # from_views round-trips a window, and refuses ragged lists
    views = got.views()
    back = ViewColumns.from_views(views)
    assert_same_columns(back, rviews.ViewColumns.from_views([ref_view(hv) for hv in views]))
    assert back.views() == views
    ragged = views[:1] + parts[other].views()[:1]
    assert ViewColumns.from_views(ragged) is None
    assert ViewColumns.from_views([]) is None
    # a slice shares the columns
    sl = got[1:3]
    assert len(sl) == 2 and sl.views() == views[1:3]
    assert np.shares_memory(sl.signed_bytes, got.signed_bytes)
