"""The window nonce fold and its carry across windows.

`nonce_fold` (ouroboros_consensus_tpu_torch ops/pk/kernels.py) folds the
lanes' eta, which it derives from the declared VRF outputs β: its kernel
body (csrc/wire.cuh: the producers fill a ring slot, then the chain
folds it, chunk by chunk, compiled as host C++), its plain version, the
JAX package's `nonce_fold_scan` over `nonces.vrf_nonce_value(β)` and a
loop of the port's `nonces.combine` agree byte for byte from neutral and
set carry-ins, with `within` set, clear and mixed, bucket-padding lanes
that must not fold, across a ring slot's boundary and around the ring;
on a forged window it equals the fold over finish's eta column. Then the
device path on the CPU: a replay that crosses epoch boundaries with a
generically staged (stand-in body) window in the middle ends in the
reference host fold's PraosState, the carry going on the card from
packed window to packed window and seeded again from the host state
after the generic one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.ops import blake2b as rb2b
from ouroboros_consensus_tpu.protocol import nonces as rnonces
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import nonces
from ouroboros_consensus_tpu_torch.testing import corrupt, synth
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda
from torch_port_chain import N_BLOCKS, PARAMS, forge, ref_view

torch.set_num_threads(1)

B = 37  # two ring slots of 32 lanes
RING = 7 * 32 + 5  # past the ring's six slots
RNG = np.random.default_rng(23)
BETA = RNG.integers(0, 256, (64, RING)).astype(np.int32)
CARRIES = {
    "neutral": (None, None),
    "evolving": (RNG.bytes(32), None),
    "both": (RNG.bytes(32), RNG.bytes(32)),
}
WITHIN_RING = (RNG.random(RING) < 0.5).astype(np.uint8)
WITHIN = {
    "clear": np.zeros(B, np.uint8),
    "set": np.ones(B, np.uint8),
    "mixed": WITHIN_RING[:B],
}
# the reference's eta of every lane: vrfNonceValue of its declared output
ETA = np.stack([np.frombuffer(rnonces.vrf_nonce_value(bytes(BETA[:, i].astype(np.uint8))),
                              np.uint8) for i in range(RING)], 1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_scan():
    return jax.jit(rb2b.nonce_fold_scan)


def _combine_loop(n_real, within, ev, cand, eta=ETA):
    for i in range(n_real):
        ev = nonces.combine(ev, bytes(eta[:, i].astype(np.uint8)))
        if within[i]:
            cand = ev
    return ev, cand


def _emu_fold(beta, within, n_real, cin):
    return K._nonce_fold_launch(build.build_host_emu().pk_nonce_fold, None, beta,
                                within, n_real, cin)


def _check_fold(jax_scan, b, within, ev0, cand0, n_real):
    """The β-fed fold over the first b lanes, as plain twin, host-built
    kernel and the reference's scan over its etas, against the loop."""
    cin = torch.from_numpy(nonces.pack_carry(ev0, cand0))
    beta = torch.from_numpy(np.ascontiguousarray(BETA[:, :b]))
    win = torch.from_numpy(within)
    want = nonces.pack_carry(*_combine_loop(n_real, within, ev0, cand0))
    assert np.array_equal(K.nonce_fold(beta, win, n_real, cin).numpy(), want)
    assert np.array_equal(_emu_fold(beta, win, n_real, cin).numpy(), want)

    def arr(n):
        return jnp.asarray(np.frombuffer(n or bytes(32), np.uint8).astype(np.int32))

    ev, evs, cand, cands = jax_scan(
        jnp.asarray(ETA[:, :b].T), jnp.asarray(within != 0), jnp.arange(b) < n_real,
        arr(ev0), jnp.asarray(ev0 is not None), arr(cand0), jnp.asarray(cand0 is not None))
    ref = nonces.pack_carry(bytes(np.asarray(ev).astype(np.uint8)) if evs else None,
                            bytes(np.asarray(cand).astype(np.uint8)) if cands else None)
    assert np.array_equal(ref, want)


@pytest.mark.parametrize("n_real", [B, B - 5, 1, 0, 31, 33])
@pytest.mark.parametrize("w", list(WITHIN))
@pytest.mark.parametrize("c", list(CARRIES))
def test_fold_matches_reference_and_twin(jax_scan, c, w, n_real):
    _check_fold(jax_scan, B, WITHIN[w], *CARRIES[c], n_real)


@pytest.mark.parametrize("n_real", [6 * 32, 6 * 32 + 1, RING])
@pytest.mark.parametrize("c", ["neutral", "both"])
def test_fold_around_the_ring(jax_scan, c, n_real):
    """Past FOLD_SLOTS ring slots the producers refill slot 0: the host
    build walks the same slots, and the carry stays the reference's."""
    _check_fold(jax_scan, RING, WITHIN_RING, *CARRIES[c], n_real)


def test_carry_round_trips_and_refuses_bad_inputs():
    for ev, cand in CARRIES.values():
        assert nonces.unpack_carry(nonces.pack_carry(ev, cand)) == (ev, cand)
    cin = torch.from_numpy(nonces.pack_carry(None, None))
    beta, win = torch.from_numpy(BETA[:, :B].copy()), torch.from_numpy(WITHIN["set"])
    with pytest.raises(ValueError, match="n_real"):
        K.nonce_fold(beta, win, B + 1, cin)
    with pytest.raises(TypeError, match="within"):
        K.nonce_fold(beta, win.to(torch.int32), B, cin)
    with pytest.raises(ValueError, match="beta"):  # an eta column is not β
        K.nonce_fold(torch.from_numpy(ETA[:, :B].copy()), win, B, cin)


def test_reduce_forms_agree():
    """verdict_reduce's two forms: the same mask words; the joined fold's
    carry (launched by nonce_fold_beside from β) is the host fold of the
    other form's eta bytes."""
    rng = np.random.default_rng(3)
    flags = torch.from_numpy((rng.random((5, B)) < 0.9).astype(np.int32))
    eta, win = torch.from_numpy(ETA[:, :B].copy()), torch.from_numpy(WITHIN["mixed"])
    beta = torch.from_numpy(BETA[:, :B].copy())
    cin = torch.from_numpy(nonces.pack_carry(*CARRIES["both"]))
    fold = K.nonce_fold_beside(beta, win, B - 2, cin)
    assert fold[1] is None  # on the CPU the fold ran at once
    m1, cout = pbatch.verdict_reduce(flags, eta, B - 2, fold)
    m2, eta_u8 = pbatch.verdict_reduce(flags, eta, B - 2)
    assert torch.equal(m1, m2) and eta_u8.shape == (B - 2, 32)
    bits = np.unpackbits(m1.numpy().astype(np.uint32).view(np.uint8), axis=1,
                         bitorder="little")[:, :B]
    assert np.array_equal(bits, flags.numpy() != 0)
    ev, cand = CARRIES["both"]
    for i in range(B - 2):
        ev = nonces.combine(ev, eta_u8[i].numpy().tobytes())
        if WITHIN["mixed"][i]:
            cand = ev
    assert nonces.unpack_carry(cout.numpy()) == (ev, cand)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The 48-block test chain's views with the headers of the middle
    epoch-crossing stretch [16, 28) on stand-in bodies."""
    path = str(tmp_path_factory.mktemp("chain") / "db")
    lview = forge(path)
    hvs = pda.read_header_views(path)
    assert len(hvs) == N_BLOCKS
    params = carry.params_from_reference(PARAMS)
    pool = synth.make_pool(0, kes_depth=PARAMS.kes_depth)
    hvs[16:28] = corrupt.standin_views(hvs[16:28], params, pool)
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


@pytest.mark.parametrize("bad", [None, 40], ids=["valid", "kes_sig_at_40"])
def test_carried_replay_matches_host_fold(chain, monkeypatch, bad):
    """validate_chain(device="cpu") over packed windows, generic windows
    and packed windows again equals the reference's sequential fold; a
    packed window after a packed one takes its carry tensor, the first
    packed window of the chain and the first after a generic window a
    host seed from the state (and a corrupted header late in the chain
    stops both at the same place with the same state). The windows hold
    4 headers: the chain's first windows step in body width (its genesis
    header, then its slots' CBOR width), which validate_chain does not
    cut at, so they are staged generically."""
    hvs, lview = chain
    hvs = list(hvs)
    if bad is not None:
        sig = bytearray(hvs[bad].kes_sig)
        sig[-1] ^= 1
        hvs[bad] = dataclasses.replace(hvs[bad], kes_sig=bytes(sig))
    seen = []
    dispatch = pbatch.dispatch_prepared  # once a window, in window order

    def spy(sw, device, carry_in=None):
        v = dispatch(sw, device, carry_in)
        seen.append((sw.hvs[0].slot, type(carry_in).__name__, v.carried))
        return v

    monkeypatch.setattr(pbatch, "dispatch_prepared", spy)
    params = carry.params_from_reference(PARAMS)
    plview = carry.lview_from_reference(lview)
    got = pbatch.validate_chain(params, lambda _e: plview, pbatch.PraosState(), hvs,
                                max_batch=4, backend="device", device="cpu")
    n, err, st = _host_fold([ref_view(h) for h in hvs], lview)
    assert got.n_valid == n == (N_BLOCKS if bad is None else bad)
    assert carry.error_to_plain(got.error) == carry.error_to_plain(err)
    assert carry.state_to_plain(got.state) == carry.state_to_plain(
        carry.state_from_reference(st))
    epoch = [s // PARAMS.epoch_length for s, _k, _c in seen]
    kinds = [(k, c) for _s, k, c in seen]
    generic = [i for i, (_k, c) in enumerate(kinds) if not c]
    assert generic and generic[-1] + 1 < len(kinds)
    assert any(c for _k, c in kinds[: generic[-1]])  # packed windows before a generic one
    for i, (k, c) in enumerate(kinds):
        if c and (i == 0 or not kinds[i - 1][1]):
            assert k == "ndarray"  # the chain's seed, and seeded again after a generic window
    after = generic[-1] + 1
    assert kinds[after] == ("ndarray", True)  # seeded again from the state
    carried = [i for i, (k, c) in enumerate(kinds) if k == "Tensor"]
    assert carried and all(kinds[i - 1][1] for i in carried)
    # the carry went on the card across an epoch boundary
    assert any(epoch[i] != epoch[i - 1] for i in carried)


def test_packed_verdicts_hold_the_fold_and_the_eta_column(chain):
    """A packed window's PackedVerdicts: the carry-out on the device, its
    two nonces read back, no eta bytes shipped (the column stays on the
    device for full()); the nonces are the host fold of that column from the seed."""
    hvs, lview = chain
    params = carry.params_from_reference(PARAMS)
    plview = carry.lview_from_reference(lview)
    window = [h for h in hvs[:16] if len(h.signed_bytes) == len(hvs[8].signed_bytes)]
    assert len(window) >= 4
    seed = (RNG.bytes(32), None)
    pre = pbatch.host_prechecks(params, plview, window)
    v = pbatch.dispatch_window(params, plview, None, window, pre, torch.device("cpu"),
                               nonces.pack_carry(*seed))
    assert v.carried and v.eta_bytes() is None and tuple(v.carry.shape) == (66,)
    etas = v.full().eta
    assert etas.shape == (len(window), 32)
    ev, cand = seed
    for hv, eta in zip(window, etas):
        ev = nonces.combine(ev, eta.tobytes())
        if hv.slot + params.stability_window < params.first_slot_of(
                params.epoch_of(hv.slot) + 1):
            cand = ev
    assert v.nonces == (ev, cand) == nonces.unpack_carry(v.carry.numpy())


@pytest.fixture(scope="module")
def forged_window(chain):
    """The chain's first packed window on the CPU: its β rows (unpack's
    beta segment), `within`, finish's eta column (the stage twins) and
    its real lanes."""
    hvs, lview = chain
    params = carry.params_from_reference(PARAMS)
    window = [h for h in hvs[:16] if len(h.signed_bytes) == len(hvs[8].signed_bytes)]
    layout, packed = pbatch.stage_packed(params, carry.lview_from_reference(lview),
                                         None, window)
    packed = pbatch.pad_packed_to(packed, pbatch.bucket_size(len(window)))
    cols = pbatch.upload_packed(packed, torch.device("cpu"))
    limb = K.unpack_limb_first(layout, cols, "cpu")
    _flags, eta, _lv = K._tiles(limb, layout.vrf_proof_len == 128, layout.kes_depth)
    return limb[K.UNPACK_BETA], cols.within, eta, len(window)


@pytest.mark.parametrize("cut", [0, 3, -1], ids=["all", "all_but_3", "one"])
@pytest.mark.parametrize("c", ["neutral", "both"])
def test_beta_fold_equals_fold_over_finish_eta(forged_window, c, cut):
    """On forged headers the β-fed fold (twin and host-built kernel)
    gives, byte for byte, the carry of the fold over the eta that finish
    computes, so it can run before the stages."""
    beta, within, eta, n = forged_window
    n_real = 1 if cut < 0 else n - cut
    ev0, cand0 = CARRIES[c]
    cin = torch.from_numpy(nonces.pack_carry(ev0, cand0))
    want = nonces.pack_carry(*_combine_loop(n_real, within.numpy(), ev0, cand0,
                                            eta=eta.numpy()))
    assert np.array_equal(K.nonce_fold(beta, within, n_real, cin).numpy(), want)
    assert np.array_equal(_emu_fold(beta, within, n_real, cin).numpy(), want)
