"""The port's generic staging (ouroboros_consensus_tpu_torch
protocol/batch.stage) and the device path it feeds, against the JAX
package: the staged columns equal the reference's `stage` byte for byte,
and windows the packed staging declines (stand-in bodies that embed no
header field) validate through the port's `validate_chain(backend=
"device", device="cpu")` exactly as through the reference's
`validate_chain` and its sequential host fold."""

import dataclasses
import hashlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.protocol import batch as rbatch
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu.testing import fixtures
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import views as pviews

torch.set_num_threads(1)

DEPTH = 3
PARAMS = rpraos.PraosParams(
    slots_per_kes_period=100, max_kes_evolutions=62, security_param=4,
    active_slot_coeff=Fraction(1, 2), epoch_length=100_000, kes_depth=DEPTH,
)
ETA0 = b"\x09" * 32


def port_view(hv) -> pviews.HeaderView:
    oc = hv.ocert
    return pviews.HeaderView(
        prev_hash=hv.prev_hash, vk_cold=hv.vk_cold, vrf_vk=hv.vrf_vk,
        vrf_output=hv.vrf_output, vrf_proof=hv.vrf_proof,
        ocert=pviews.OCert(oc.vk_hot, oc.counter, oc.kes_period, oc.sigma),
        slot=hv.slot, signed_bytes=hv.signed_bytes, kes_sig=hv.kes_sig)


def forge_views(n: int, body, draft03: bool = False, counters: bool = False):
    """n leader views of 3 pools; body(i) is view i's stand-in body. With
    `counters`, each pool's OCert issue number counts up per header."""
    with pytest.MonkeyPatch.context() as mp:
        if draft03:
            mp.setenv("OCT_VRF_BATCH", "0")
        pools = [fixtures.make_pool(i, kes_depth=DEPTH) for i in range(3)]
        lview = fixtures.make_ledger_view(pools)
        hvs, slot, prev = [], 1, None
        while len(hvs) < n:
            pool = fixtures.find_leader(PARAMS, pools, lview, slot, ETA0)
            if pool is not None:
                hvs.append(fixtures.forge_header_view(
                    PARAMS, pool, slot=slot, epoch_nonce=ETA0, prev_hash=prev,
                    body_bytes=body(len(hvs))))
                prev = hashlib.blake2b(b"%d" % slot, digest_size=32).digest()
            slot += 1
    return hvs, lview


def _words_to_bytes(w: np.ndarray) -> np.ndarray:
    """The reference's SHA-512 word blocks [B, NB, 16, 2] (hi, lo) ->
    [B, NB, 128] bytes."""
    b, nb = w.shape[:2]
    return np.asarray(w).astype(">u4").view(np.uint8).reshape(b, nb, 128)


@pytest.mark.parametrize("fmt", ["bc", "draft03"])
def test_stage_columns_equal_reference(fmt):
    # body lengths straddle SHA-512 block edges: per-lane block counts differ
    lens = [0, 45, 46, 47, 173, 174, 175, 301, 302]
    hvs, lview = forge_views(len(lens), lambda i: b"s" * lens[i], fmt == "draft03")
    pre = rbatch.host_prechecks(PARAMS, lview, hvs)
    ref = rbatch.stage(PARAMS, lview, ETA0, hvs, pre.kes_evolution)
    got = pbatch.stage(carry.params_from_reference(PARAMS),
                       carry.lview_from_reference(lview), ETA0,
                       [port_view(h) for h in hvs], np.asarray(pre.kes_evolution))
    assert len(set(got.kes.hnblocks.tolist())) > 1
    assert type(got.vrf).__name__ == type(ref.vrf).__name__
    for part in ("ed", "kes", "vrf"):
        r, g = getattr(ref, part), getattr(got, part)
        assert r._fields == g._fields
        for name in r._fields:
            want = np.asarray(getattr(r, name))
            if name == "hblocks":
                want = _words_to_bytes(want)
            have = getattr(g, name)
            assert have.shape == want.shape, (part, name)
            assert np.array_equal(have.astype(np.int64), want.astype(np.int64)), (part, name)
    for name in ("beta", "thr_lo", "thr_hi"):
        assert np.array_equal(getattr(got, name), np.asarray(getattr(ref, name))), name


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


STANDIN_N = 6
BAD = 3
# corruption of view BAD -> the error both packages must stop with
CORRUPT = {
    None: None,
    "kes_sig": "InvalidKesSignatureOCERT",
    "vrf_proof": "VRFKeyBadProof",
    "ocert_sigma": "InvalidSignatureOCERT",
}


@pytest.fixture(scope="module")
def standin():
    return forge_views(STANDIN_N, lambda i: b"")


def _corrupt(hv, field):
    rep = dataclasses.replace
    if field == "kes_sig":
        return rep(hv, kes_sig=_flip(hv.kes_sig, len(hv.kes_sig) - 1))
    if field == "vrf_proof":
        return rep(hv, vrf_proof=_flip(hv.vrf_proof, 40))
    return rep(hv, ocert=rep(hv.ocert, sigma=_flip(hv.ocert.sigma, 63)))


def _host_fold(hvs, lview):
    """The reference's sequential fold: tick, update, stop at the first
    error."""
    st = rpraos.PraosState(epoch_nonce=ETA0)
    for i, hv in enumerate(hvs):
        ticked = rpraos.tick(PARAMS, lview, hv.slot, st)
        try:
            st = rpraos.update(PARAMS, hv, hv.slot, ticked)
        except rpraos.PraosValidationError as e:
            return i, e, st
    return len(hvs), None, st


@pytest.mark.parametrize("field", list(CORRUPT), ids=lambda f: f or "valid")
def test_standin_views_validate_as_reference(standin, field):
    hvs, lview = standin
    hvs = list(hvs)
    if field is not None:
        hvs[BAD] = _corrupt(hvs[BAD], field)
    pviews_ = [port_view(h) for h in hvs]
    params = carry.params_from_reference(PARAMS)
    plview = carry.lview_from_reference(lview)
    with pytest.raises(pbatch.NotStagedError, match="field-offsets"):
        pbatch.stage_packed(params, plview, ETA0, pviews_)
    before = pbatch.DECLINES.get("field-offsets", 0)
    got = pbatch.validate_chain(params, lambda _e: plview,
                                carry.state_from_reference(rpraos.PraosState(epoch_nonce=ETA0)),
                                pviews_, max_batch=8, backend="device", device="cpu")
    assert pbatch.DECLINES["field-offsets"] > before
    ref = rbatch.validate_chain(PARAMS, lambda _e: lview,
                                rpraos.PraosState(epoch_nonce=ETA0), hvs,
                                max_batch=8, backend="native")
    n, err, st = _host_fold(hvs, lview)
    want_n = STANDIN_N if field is None else BAD
    assert ref.n_valid == n == got.n_valid == want_n
    assert carry.error_to_plain(got.error) == carry.error_to_plain(ref.error) \
        == carry.error_to_plain(err)
    if field is not None:
        assert type(got.error).__name__ == CORRUPT[field]
    assert carry.state_to_plain(got.state) == carry.state_to_plain(ref.state) \
        == carry.state_to_plain(st)


def test_other_declines_still_raise(standin):
    """A window whose proofs differ in length (validate_chain never hands
    one over: it cuts at a format switch) or whose KES signature does not
    match the depth is not staged generically: dispatch_window raises.
    (A window of several body widths is: see
    test_torch_columnar_replay.py.)"""
    hvs, lview = standin
    params = carry.params_from_reference(PARAMS)
    plview = carry.lview_from_reference(lview)
    for reason, field, value in (("proof-format", "vrf_proof", bytes(80)),
                                 ("kes-sig-len", "kes_sig", bytes(64))):
        pv = [port_view(h) for h in hvs[:2]]
        pv[1] = dataclasses.replace(pv[1], **{field: value})
        pre = pbatch.host_prechecks(params, plview, pv)
        with pytest.raises(pbatch.NotStagedError, match=reason):
            pbatch.dispatch_window(params, plview, ETA0, pv, pre, torch.device("cpu"))
