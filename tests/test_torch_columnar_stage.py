"""The port's columnar host stages (protocol/batch.py) against the JAX
package's functions of the same names, on ViewColumns windows built from
the chunk scans of 48-block chains forged by the JAX package (bc and
draft-03 proofs):

- host_prechecks_columns on a clean window and on windows with KES-window,
  unknown-pool and wrong-VRF-key lanes: kes_evolution, uniq_inv, clean
  and every lane's error object, by type and fields (and against the
  port's own list prechecks);
- stage_packed_columns lane for lane through the table indices, against
  the reference's and against the port's list stage_packed, under the
  neutral and a set epoch nonce, and the decline reasons on windows that
  each gate refuses;
- stage_columns byte for byte against the reference's and the port's
  list `stage`."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_chain import PARAMS, forge, ref_view

from ouroboros_consensus_tpu import native_loader as rnl
from ouroboros_consensus_tpu.protocol import batch as rbatch
from ouroboros_consensus_tpu.protocol import views as rviews
from ouroboros_consensus_tpu_torch import carry, native_scan
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import views as pviews
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB

torch.set_num_threads(1)

ETA = b"\x07" * 32
PPARAMS = carry.params_from_reference(PARAMS)


@pytest.fixture(scope="module", params=["bc", "draft03"])
def window(request, tmp_path_factory):
    """(the port's ViewColumns, the reference's, the reference LedgerView):
    the chain's widest run of same-width pieces, concatenated."""
    path = str(tmp_path_factory.mktemp("chain") / "db")
    lview = forge(path, draft03=request.param == "draft03")
    got, ref = [], []
    imm = ImmutableDB(f"{path}/immutable")
    for n, entries in imm.chunk_entries():
        data = imm.read_chunk(n)
        offs = np.asarray([e.offset for e in entries], np.int64)
        got += pviews.ViewColumns.pieces_from_header_columns(
            native_scan.extract_headers(data, offs))
        ref += rviews.ViewColumns.pieces_from_header_columns(rnl.extract_headers(data, offs))
    width = max({p.signed_bytes.shape[1] for p in got},
                key=lambda w: sum(len(p) for p in got if p.signed_bytes.shape[1] == w))
    keep = [k for k, p in enumerate(got) if p.signed_bytes.shape[1] == width]
    vc = pviews.ViewColumns.concat([got[k] for k in keep])
    rvc = rviews.ViewColumns.concat([ref[k] for k in keep])
    assert len(vc) >= 8
    return vc, rvc, lview


def _edit(vc, rvc, **cols):
    """Both windows with the given columns replaced (copies)."""
    return (dataclasses.replace(vc, **{k: v.copy() for k, v in cols.items()}),
            dataclasses.replace(rvc, **{k: v.copy() for k, v in cols.items()}))


def _errors(pre):
    return ([carry.error_to_plain(e) for e in pre.kes_window_errors],
            [carry.error_to_plain(e) for e in pre.vrf_lookup_errors])


def _prechecks_cases(vc, rvc, lview):
    """(name, port window, reference window, reference LedgerView)."""
    slot = vc.slot.copy()
    c0 = vc.ocert_kes_period.copy()
    c0[1] = slot[1] // PARAMS.slots_per_kes_period + 1  # KES period before the OCert's
    slot[2] = (c0[2] + PARAMS.max_kes_evolutions) * PARAMS.slots_per_kes_period + 3  # after
    cold = vc.vk_cold.copy()
    cold[3] = 0x11  # a key no pool has
    (hk, entry), = lview.pool_distr.items()
    wrong = rviews.LedgerView(pool_distr={hk: dataclasses.replace(
        entry, vrf_key_hash=bytes(32))})
    return [
        ("clean", vc, rvc, lview),
        ("kes-window", *_edit(vc, rvc, slot=slot, ocert_kes_period=c0), lview),
        ("unknown-pool-lane", *_edit(vc, rvc, vk_cold=cold), lview),
        ("no-pools", vc, rvc, rviews.LedgerView(pool_distr={})),
        ("wrong-vrf-key", vc, rvc, wrong),
        ("all", *_edit(vc, rvc, slot=slot, ocert_kes_period=c0, vk_cold=cold), wrong),
    ]


def test_host_prechecks_columns_matches_reference(window):
    for name, vc, rvc, lview in _prechecks_cases(*window):
        plview = carry.lview_from_reference(lview)
        got = pbatch.host_prechecks(PPARAMS, plview, vc)
        assert isinstance(got, pbatch.ColumnChecks), name
        ref = rbatch.host_prechecks_columns(PARAMS, lview, rvc)
        assert np.array_equal(got.kes_evolution, ref.kes_evolution), name
        assert np.array_equal(got.uniq_inv, ref.uniq_inv), name
        assert got.uniq_hk == ref.uniq_hk and got.clean == ref.clean, name
        assert got.clean == (name == "clean")
        assert _errors(got) == _errors(ref), name
        listed = pbatch.host_prechecks(PPARAMS, plview, vc.views())
        assert _errors(listed) == _errors(got), name
        assert np.array_equal(listed.kes_evolution, got.kes_evolution), name


def _lanes(packed):
    """A packed window lane by lane, the table rows gathered."""
    return {
        "body": packed.body, "kes_rs": packed.kes_rs,
        "tail": np.asarray(packed.kes_tail_tab)[np.asarray(packed.kes_tail_idx)],
        "slot": packed.slot, "counter": packed.counter, "c0": packed.c0,
        "thr": np.asarray(packed.thr_tab)[np.asarray(packed.thr_idx)],
        "nonce": packed.nonce, "within": packed.within,
    }


@pytest.mark.parametrize("nonce", [None, ETA], ids=["neutral", "set"])
def test_stage_packed_columns_matches_reference_and_list(window, nonce):
    vc, rvc, lview = window
    plview = carry.lview_from_reference(lview)
    pre = pbatch.host_prechecks_columns(PPARAMS, plview, vc)
    layout, packed = pbatch.stage_packed_columns(PPARAMS, plview, nonce, vc, pre)
    rlayout, rpacked = rbatch.stage_packed_columns(
        PARAMS, lview, nonce, rvc, rbatch.host_prechecks_columns(PARAMS, lview, rvc))
    llayout, lpacked = pbatch.stage_packed(PPARAMS, plview, nonce, vc.views())
    assert tuple(layout) == tuple(rlayout) == tuple(llayout)
    got, ref, lst = _lanes(packed), _lanes(rpacked), _lanes(lpacked)
    for k in got:
        assert np.array_equal(got[k], ref[k]) and np.array_equal(got[k], lst[k]), k
        assert got[k].dtype == lst[k].dtype, k
    for a in packed:  # the upload takes every column as it is
        assert a.flags.c_contiguous and a.flags.writeable


def _decline_cases(vc, rvc):
    zero_body = np.zeros_like(vc.signed_bytes)
    vrf_vk = vc.vrf_vk.copy()
    vrf_vk[1, 5] ^= 0x01  # lane 1's key no longer the one its body embeds
    slot = vc.slot.copy()
    slot[0] = 2**31
    plen = vc.vrf_proof_len.copy()
    plen[1] = 80 if plen[1] == 128 else 128
    return {
        "field-offsets": _edit(vc, rvc, signed_bytes=zero_body),
        "field-mismatch": _edit(vc, rvc, vrf_vk=vrf_vk),
        "int32-range": _edit(vc, rvc, slot=slot),
        "kes-sig-len": _edit(vc, rvc, kes_sig=vc.kes_sig[:, :-32]),
        "proof-format": _edit(vc, rvc, vrf_proof_len=plen),
    }


def test_stage_packed_columns_declines_as_reference(window):
    vc0, rvc0, lview = window
    plview = carry.lview_from_reference(lview)
    for reason, (vc, rvc) in _decline_cases(vc0, rvc0).items():
        pre = pbatch.host_prechecks_columns(PPARAMS, plview, vc)
        with pytest.raises(pbatch.NotStagedError) as got:
            pbatch.stage_packed_columns(PPARAMS, plview, None, vc, pre)
        rbatch._LAST_DECLINE = None
        assert rbatch.stage_packed_columns(
            PARAMS, lview, None, rvc, rbatch.host_prechecks_columns(PARAMS, lview, rvc)) is None
        assert got.value.reason == rbatch._LAST_DECLINE == reason
        with pytest.raises(pbatch.NotStagedError) as listed:
            pbatch.stage_packed(PPARAMS, plview, None, vc.views())
        assert listed.value.reason == reason


def _flat(batch, words_ref: bool):
    out = {}
    for part in ("ed", "kes", "vrf"):
        t = getattr(batch, part)
        out[part + ".type"] = type(t).__name__
        for name in t._fields:
            a = np.asarray(getattr(t, name))
            if name == "hblocks" and words_ref:  # [B, NB, 16, 2] (hi, lo) words
                a = a.astype(">u4").view(np.uint8).reshape(a.shape[0], a.shape[1], 128)
            out[f"{part}.{name}"] = a
    for name in ("beta", "thr_lo", "thr_hi"):
        out[name] = np.asarray(getattr(batch, name))
    return out


@pytest.mark.parametrize("nonce", [None, ETA], ids=["neutral", "set"])
def test_stage_columns_matches_reference_and_list(window, nonce):
    vc, rvc, lview = window
    plview = carry.lview_from_reference(lview)
    pre = pbatch.host_prechecks_columns(PPARAMS, plview, vc)
    rpre = rbatch.host_prechecks_columns(PARAMS, lview, rvc)
    got = _flat(pbatch.stage_columns(PPARAMS, plview, nonce, vc, pre.kes_evolution, pre),
                False)
    ref = _flat(rbatch.stage_columns(PARAMS, lview, nonce, rvc, rpre.kes_evolution, rpre),
                True)
    lst = _flat(pbatch.stage(PPARAMS, plview, nonce, vc.views(), pre.kes_evolution), False)
    anyf = _flat(pbatch.stage_any(PPARAMS, plview, nonce, vc, pre), False)
    assert got.keys() == ref.keys() == lst.keys()
    for k in got:
        if k.endswith(".type"):
            assert got[k] == ref[k] == lst[k] == anyf[k], k
            continue
        for other in (ref, lst, anyf):
            assert got[k].shape == other[k].shape, k
            assert np.array_equal(got[k].astype(np.int64), other[k].astype(np.int64)), k
    assert [ref_view(hv) for hv in vc.views()] == rvc.views()


# counter columns of a window (each the pool's OCert issue numbers, lane
# by lane), from a state that last saw counter 1 for the window's pool:
# the fast path takes a run that starts at m or m + 1 and steps by 0 or 1
COUNTERS = {
    "steady": [1, 1, 1, 2, 2, 2, 2, 2],
    "start-next": [2, 2, 3, 3, 3, 3, 3, 3],
    "jump-by-two": [1, 1, 3, 3, 3, 3, 3, 3],
    "falls-back": [2, 2, 1, 1, 1, 1, 1, 1],
    "start-too-high": [3, 3, 3, 3, 3, 3, 3, 3],
    "start-too-low": [0, 1, 1, 1, 1, 1, 1, 1],
}


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_columns_epilogue_matches_reference(window, name):
    """_epilogue_columns_fast of both packages on one clean window with
    all-pass verdicts (a host fold of seeded eta bytes): the same final
    state, or the same decline (None) where a counter gate trips."""
    from ouroboros_consensus_tpu.protocol import praos as rpraos
    from ouroboros_consensus_tpu_torch.protocol import praos as ppraos

    vc, rvc, lview = window
    n = 8
    counter = np.asarray(COUNTERS[name], np.int64)
    vc, rvc = _edit(vc[:n], rvc[:n], ocert_counter=counter)
    plview = carry.lview_from_reference(lview)
    (hk, _), = lview.pool_distr.items()
    rng = np.random.default_rng(5)
    eta = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    ones, zeros = np.ones(n, bool), np.zeros(n, bool)
    lv = np.zeros((n, 32), np.uint8)
    rst = rpraos.PraosState(ocert_counters={hk: 1}, evolving_nonce=b"\x01" * 32,
                            candidate_nonce=b"\x02" * 32)
    slot0 = int(vc.slot[0])
    rticked = rpraos.tick(PARAMS, lview, slot0, rst)
    pticked = ppraos.tick(PPARAMS, plview, slot0, carry.state_from_reference(rst))
    ref = rbatch._epilogue_columns_fast(
        PARAMS, rticked, rvc, rbatch.host_prechecks_columns(PARAMS, lview, rvc),
        rbatch.Verdicts(ones, ones, ones, ones, zeros, eta, lv))
    got = pbatch._epilogue_columns_fast(
        PPARAMS, pticked, vc, pbatch.host_prechecks_columns(PPARAMS, plview, vc),
        pbatch.Verdicts(ones, ones, ones, ones, zeros, eta, lv))
    assert (got is None) == (ref is None) == (name not in ("steady", "start-next"))
    if ref is not None:
        assert got.n_valid == ref.n_valid == n
        assert carry.state_to_plain(got.state) == carry.state_to_plain(ref.state)
