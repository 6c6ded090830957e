"""The window nonce fold and its carry across windows.

`nonce_fold` (ouroboros_consensus_tpu_torch ops/pk/kernels.py): its
lane body (csrc/wire.cuh, compiled as host C++), its plain version, the
JAX package's `nonce_fold_scan` and a loop of the port's
`nonces.combine` agree byte for byte from neutral and set carry-ins,
with `within` set, clear and mixed and bucket-padding lanes that must
not fold. Then the device path on the CPU: a replay that crosses epoch
boundaries with a generically staged (stand-in body) window in the
middle ends in the reference host fold's PraosState, the carry going on
the card from packed window to packed window and seeded again from the
host state after the generic one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.ops import blake2b as rb2b
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

B = 37
RNG = np.random.default_rng(23)
ETA = RNG.integers(0, 256, (32, B)).astype(np.int32)
CARRIES = {
    "neutral": (None, None),
    "evolving": (RNG.bytes(32), None),
    "both": (RNG.bytes(32), RNG.bytes(32)),
}
WITHIN = {
    "clear": np.zeros(B, np.uint8),
    "set": np.ones(B, np.uint8),
    "mixed": (RNG.random(B) < 0.5).astype(np.uint8),
}


@pytest.fixture(scope="module")
def jax_scan():
    return jax.jit(rb2b.nonce_fold_scan)


def _combine_loop(n_real, within, ev, cand):
    for i in range(n_real):
        ev = nonces.combine(ev, bytes(ETA[:, i].astype(np.uint8)))
        if within[i]:
            cand = ev
    return ev, cand


@pytest.mark.parametrize("n_real", [B, B - 5, 1, 0])
@pytest.mark.parametrize("w", list(WITHIN))
@pytest.mark.parametrize("c", list(CARRIES))
def test_fold_matches_reference_and_twin(jax_scan, c, w, n_real):
    ev0, cand0 = CARRIES[c]
    within = WITHIN[w]
    cin = torch.from_numpy(nonces.pack_carry(ev0, cand0))
    eta, win = torch.from_numpy(ETA), torch.from_numpy(within)
    want = nonces.pack_carry(*_combine_loop(n_real, within, ev0, cand0))
    plain = K.nonce_fold(eta, win, n_real, cin)
    emu = K._nonce_fold_launch(build.build_host_emu().pk_nonce_fold, None, eta, win,
                               n_real, cin)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(emu.numpy(), want)

    def arr(n):
        return jnp.asarray(np.frombuffer(n or bytes(32), np.uint8).astype(np.int32))

    ev, evs, cand, cands = jax_scan(
        jnp.asarray(ETA.T), jnp.asarray(within != 0), jnp.arange(B) < n_real,
        arr(ev0), jnp.asarray(ev0 is not None), arr(cand0), jnp.asarray(cand0 is not None))
    ref = nonces.pack_carry(bytes(np.asarray(ev).astype(np.uint8)) if evs else None,
                            bytes(np.asarray(cand).astype(np.uint8)) if cands else None)
    assert np.array_equal(ref, want)


def test_carry_round_trips_and_refuses_bad_inputs():
    for ev, cand in CARRIES.values():
        assert nonces.unpack_carry(nonces.pack_carry(ev, cand)) == (ev, cand)
    cin = torch.from_numpy(nonces.pack_carry(None, None))
    eta, win = torch.from_numpy(ETA), torch.from_numpy(WITHIN["set"])
    with pytest.raises(ValueError, match="n_real"):
        K.nonce_fold(eta, win, B + 1, cin)
    with pytest.raises(TypeError, match="within"):
        K.nonce_fold(eta, win.to(torch.int32), B, cin)


def test_reduce_forms_agree():
    """verdict_reduce's two forms: the same mask words; the scan's carry
    is the host fold of the other form's eta bytes."""
    rng = np.random.default_rng(3)
    flags = torch.from_numpy((rng.random((5, B)) < 0.9).astype(np.int32))
    eta, win = torch.from_numpy(ETA), torch.from_numpy(WITHIN["mixed"])
    cin = torch.from_numpy(nonces.pack_carry(*CARRIES["both"]))
    m1, cout = pbatch.verdict_reduce(flags, eta, B - 2, win, cin, scan=True)
    m2, eta_u8 = pbatch.verdict_reduce(flags, eta, B - 2, scan=False)
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
    """validate_chain(device="cpu") over packed windows, a generic window
    and packed windows again equals the reference's sequential fold; the
    packed windows after the first take the previous window's carry
    tensor, the first after the generic window a host seed from the state
    (and a corrupted header late in the chain stops both at the same
    place with the same state)."""
    hvs, lview = chain
    hvs = list(hvs)
    if bad is not None:
        sig = bytearray(hvs[bad].kes_sig)
        sig[-1] ^= 1
        hvs[bad] = dataclasses.replace(hvs[bad], kes_sig=bytes(sig))
    seen = []
    dispatch = pbatch.dispatch_window

    def spy(params, lv, eta0, whvs, pre, device, carry_in=None):
        v = dispatch(params, lv, eta0, whvs, pre, device, carry_in)
        seen.append((whvs[0].slot, type(carry_in).__name__, v.carried))
        return v

    monkeypatch.setattr(pbatch, "dispatch_window", spy)
    params = carry.params_from_reference(PARAMS)
    plview = carry.lview_from_reference(lview)
    got = pbatch.validate_chain(params, lambda _e: plview, pbatch.PraosState(), hvs,
                                max_batch=8, backend="device", device="cpu")
    n, err, st = _host_fold([ref_view(h) for h in hvs], lview)
    assert got.n_valid == n == (N_BLOCKS if bad is None else bad)
    assert carry.error_to_plain(got.error) == carry.error_to_plain(err)
    assert carry.state_to_plain(got.state) == carry.state_to_plain(
        carry.state_from_reference(st))
    epoch = [s // PARAMS.epoch_length for s, _k, _c in seen]
    kinds = [(k, c) for _s, k, c in seen]
    generic = [i for i, (_k, c) in enumerate(kinds) if not c]
    assert generic and generic[0] > 0 and generic[-1] + 1 < len(kinds)
    assert kinds[0] == ("ndarray", True)  # the chain's seed
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
