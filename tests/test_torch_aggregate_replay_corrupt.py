"""Dirty windows of the window aggregate on the CPU: a KES signature
flipped in the first, a middle and the last window of the 48-block
batch-compatible chain re-dispatches exactly that window to the per-lane
stages (AGG_REDISPATCH counts 1) and gives the JAX package's exact error
and state, and its device loop's count of blocks read, through
`revalidate` and (in a packed window of the third epoch) through
`validate_chain` over the chain's views at pipeline_depth 1 and 3; with
the dedupe tables cut to one slot every window overflows, re-dispatches
and still equals the fold. The slow tier holds the port's
aggregate_window to the JAX package's on one window."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_chain import (MID, N_BLOCKS, PARAMS, assert_same, assert_same_replay,
                              corrupt_copy, forge, ref_view, reference)

from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol.praos import PraosState
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)

PPARAMS = carry.params_from_reference(PARAMS)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    return path, forge(path)


def _revalidate(path, lview, **kw):
    return pda.revalidate(path, PPARAMS, carry.lview_from_reference(lview),
                          max_batch=16, device="cpu", **kw)


@pytest.mark.parametrize("bad", [2, MID, N_BLOCKS - 2], ids=["first", "middle", "last"])
def test_dirty_window_redispatches_once(chain, tmp_path, bad):
    path, lview = chain
    dst = str(tmp_path / "db")
    corrupt_copy(path, dst, "kes_sig", index=bad)
    ref = reference(dst, lview)
    assert ref.n_valid == bad and type(ref.error).__name__ == "InvalidKesSignatureOCERT"
    before = pbatch.AGG_REDISPATCH
    got = _revalidate(dst, lview)
    assert pbatch.AGG_REDISPATCH - before == 1
    # the blocks read: the reference's device loop's, not its host fold's
    # (which streams a header at a time and, for an error in the first
    # epoch, stops earlier)
    assert got.n_blocks == _reference_read_prefix(dst, bad)
    if bad == 2:
        assert_same(ref, got)
    else:
        assert_same_replay(ref, got)


def _reference_read_prefix(path: str, bad: int) -> int:
    """The blocks the JAX package's device replay has read when it stops
    at an error in block `bad`: its window stream (`_stream_windows`) cut
    into epoch segments (`_epoch_window_segments`), pulled inline (its
    OCT_STAGE_THREAD=0 loop; its prefetch thread may read further) up to
    the segment that holds the bad block."""
    imm = jda.open_immutable(path, validate_all="stream")
    res = jda.ValidationResult()
    seen = 0
    for seg in jda._epoch_window_segments(PARAMS, jda._stream_windows(imm, res)):
        seen += len(seg)
        if seen > bad:
            break
    return res.n_blocks


def _host_fold(hvs, lview):
    st = rpraos.PraosState()
    for i, hv in enumerate(hvs):
        ticked = rpraos.tick(PARAMS, lview, hv.slot, st)
        try:
            st = rpraos.update(PARAMS, hv, hv.slot, ticked)
        except rpraos.PraosValidationError as e:
            return i, e, st
    return len(hvs), None, st


@pytest.mark.parametrize("depth", [1, 3])
def test_validate_chain_redispatch_matches_host_fold(chain, depth):
    path, lview = chain
    hvs = pda.read_header_views(path)
    bad = 35  # in the third epoch, whose window is packed (one body width)
    sig = bytearray(hvs[bad].kes_sig)
    sig[40] ^= 0x01  # the KES leaf signature's s: its equation fails
    hvs[bad] = dataclasses.replace(hvs[bad], kes_sig=bytes(sig))
    before = pbatch.AGG_REDISPATCH
    got = pbatch.validate_chain(PPARAMS, lambda _e: carry.lview_from_reference(lview),
                                PraosState(), hvs, max_batch=16, device="cpu",
                                pipeline_depth=depth)
    n, err, st = _host_fold([ref_view(h) for h in hvs], lview)
    assert got.n_valid == n == bad
    assert type(err).__name__ == "InvalidKesSignatureOCERT"
    assert carry.error_to_plain(got.error) == carry.error_to_plain(err)
    assert carry.state_to_plain(got.state) == carry.state_to_plain(
        carry.state_from_reference(st))
    assert pbatch.AGG_REDISPATCH - before == 1


def test_overflowing_dedupe_tables_redispatch(chain, monkeypatch):
    """One slot a table: the chain's windows hold more than one KES leaf
    key (a KES period is 20 slots), so their tables overflow, agg_ok is
    false, and each such window takes the per-lane stages."""
    path, lview = chain
    monkeypatch.setattr(pa, "_DEDUPE_CAP", 1)
    before = pbatch.AGG_REDISPATCH
    got = _revalidate(path, lview)
    assert pbatch.AGG_REDISPATCH - before >= 2
    ref = reference(path, lview)
    assert_same_replay(ref, got)


@pytest.mark.slow
def test_aggregate_window_matches_jax(chain):
    """aggregate_window of the port and of the JAX package on the same
    window of first-epoch headers (one body width, the neutral epoch
    nonce), clean and with one lane's KES s flipped: flags, eta, leader
    value, agg_ok, pre_ok."""
    from jax import numpy as jnp

    from ouroboros_consensus_tpu.ops.pk import aggregate as jagg

    path, lview = chain
    hvs = pda.read_header_views(path)[1:14]
    layout, packed = pbatch.stage_packed(PPARAMS, carry.lview_from_reference(lview), None, hvs)
    clean = [c.contiguous() for c in
             K.staged_to_limb_first_bc(*pbatch.unpack_packed(layout, packed, "cpu"))]
    dirty = list(clean)
    dirty[8] = clean[8].clone()
    dirty[8][0, 3] ^= 1
    for cols, ok in ((clean, True), (dirty, False)):
        got = pa.aggregate_window(*cols, kes_depth=PARAMS.kes_depth)
        want = jagg.aggregate_window(*(jnp.asarray(c.numpy()) for c in cols),
                                     kes_depth=PARAMS.kes_depth)
        assert bool(got.agg_ok) == bool(want.agg_ok) == ok
        assert bool(got.pre_ok) == bool(want.pre_ok)
        assert np.array_equal(got.flags.numpy(), np.asarray(want.flags))
        assert np.array_equal(got.eta.numpy(), np.asarray(want.eta))
        assert np.array_equal(got.leader_value.numpy(), np.asarray(want.leader_value))
