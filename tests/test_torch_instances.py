"""The port's protocol instances (ouroboros_consensus_tpu_torch
protocol/instances.py) against the JAX package's on the same inputs:
PBFT (the signing-window threshold, each rejection, slot monotonicity,
the delegation map, boundary views, `reupdate`), BFT and the leader
schedule, folded header by header; states and errors compared as plain
values (carry.state_to_plain, carry.error_to_plain)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.protocol import instances as J
from ouroboros_consensus_tpu_torch import carry, native
from ouroboros_consensus_tpu_torch.protocol import instances as P

torch.set_num_threads(1)

SEEDS = [bytes([0x30 + i]) * 32 for i in range(4)]
KEYS = [native.ed25519_public(s) for s in SEEDS]


def _view(mod, seed: bytes, slot: int, sig_ok: bool = True):
    msg = b"byron-header-%d" % slot
    sig = native.ed25519_sign(seed, msg)
    if not sig_ok:
        sig = bytes([sig[0] ^ 1]) + sig[1:]
    return mod.PBftView(native.ed25519_public(seed), msg, sig)


def _pbft(mod, window=5, threshold=Fraction(3, 5), n=3):
    return mod.PBftProtocol(mod.PBftParams(num_genesis_keys=n, threshold=threshold,
                                           window=window, security_param=window), KEYS[:n])


def _fold(mod, proto, steps, ledger_view=None, reupdate=False):
    """steps: (seed | "ebb", slot, sig_ok) -> (plain state, n folded, plain error)."""
    st = proto.initial_state()
    for i, (seed, slot, ok) in enumerate(steps):
        view = mod.PBFT_BOUNDARY_VIEW if seed == "ebb" else _view(mod, seed, slot, ok)
        ticked = proto.tick(ledger_view, slot, st)
        try:
            st = (proto.reupdate if reupdate else proto.update)(view, slot, ticked)
        except Exception as e:  # noqa: BLE001 — the fold's error is the result
            return carry.state_to_plain(st), i, carry.error_to_plain(e)
    return carry.state_to_plain(st), len(steps), None


def _both(steps, reupdate=False, dlg=None, **kw):
    out = []
    for mod in (J, P):
        lv = None if dlg is None else mod.PBftLedgerView(dlg)
        out.append(_fold(mod, _pbft(mod, **kw), steps, lv, reupdate))
    assert out[0] == out[1]
    return out[1]


def _round_robin(n, start=1, keys=3):
    return [(SEEDS[s % keys], s, True) for s in range(start, start + n)]


def test_round_robin_window_slides():
    st, n, err = _both(_round_robin(23))
    assert err is None and n == 23 and len(st["signers"]) == 5


def test_boundary_views_change_nothing():
    steps = [("ebb", 0, True)] + _round_robin(6) + [("ebb", 7, True)] + _round_robin(4, 7)
    st, n, err = _both(steps)
    assert err is None and n == len(steps)


@pytest.mark.parametrize("reupdate", [False, True])
def test_threshold_exceeded(reupdate):
    steps = _round_robin(4) + [(SEEDS[0], 5 + k, True) for k in range(4)]
    st, n, err = _both(steps, reupdate=reupdate)
    if reupdate:  # no checks: the window only
        assert err is None and n == len(steps)
    else:
        assert err[0] == "PBftExceededSignThreshold" and n == 6


def test_invalid_signature():
    steps = _round_robin(5) + [(SEEDS[0], 6, False)] + _round_robin(3, 7)
    _st, n, err = _both(steps)
    assert err[0] == "PBftInvalidSignature" and n == 5


def test_slot_must_not_go_back():
    steps = _round_robin(5) + [(SEEDS[1], 3, True)]
    _st, n, err = _both(steps)
    assert err[0] == "PBftInvalidSlot" and n == 5


def test_issuer_must_be_a_delegate():
    steps = _round_robin(3) + [(SEEDS[3], 4, True)]
    _st, n, err = _both(steps)
    assert err[0] == "PBftNotGenesisDelegate" and n == 3


def test_delegation_map():
    """A delegate key stands for genesis key 1 in the ledger view's map;
    the genesis key itself is then no delegate."""
    dlg = {KEYS[0]: 0, KEYS[3]: 1, KEYS[2]: 2}
    steps = [(SEEDS[[0, 3, 2][s % 3]], s, True) for s in range(1, 10)]
    st, n, err = _both(steps, dlg=dlg)
    assert err is None and {g for _s, g in st["signers"]} == {0, 1, 2}
    _st, n, err = _both(steps + [(SEEDS[1], 10, True)], dlg=dlg)
    assert err[0] == "PBftNotGenesisDelegate" and n == 9


def test_window_counts_stay_equal_to_a_recount():
    """The per-key counts kept beside the window equal a walk of the
    window after every append (random issuers, windows of 1 to 7)."""
    rng = np.random.default_rng(5)
    for window in range(1, 8):
        proto = _pbft(P, window=window, threshold=Fraction(1))
        st = proto.initial_state()
        for slot in range(40):
            gk = int(rng.integers(3))
            st = proto._append_signer(st, slot, gk)
            walked = P.PBftState(st.signers)
            assert all(st.count_signed_by(g) == walked.count_signed_by(g) for g in range(3))
        assert st == walked


def _bft_fold(mod, steps):
    proto = mod.BftProtocol(3, KEYS[:3])
    st = proto.initial_state()
    for i, (node, slot, ok) in enumerate(steps):
        msg = b"bft-%d" % slot
        sig = native.ed25519_sign(SEEDS[node % 3], msg)
        if not ok:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        try:
            st = proto.update(mod.BftView(node, msg, sig), slot, proto.tick(None, slot, st))
        except Exception as e:  # noqa: BLE001
            return carry.state_to_plain(st), i, carry.error_to_plain(e)
    return carry.state_to_plain(st), len(steps), None


@pytest.mark.parametrize("steps", [
    [(s % 3, s, True) for s in range(7)],
    [(s % 3, s, True) for s in range(4)] + [(2, 4, True)],
    [(s % 3, s, True) for s in range(4)] + [(1, 4, False)],
], ids=["clean", "wrong-leader", "bad-signature"])
def test_bft_matches_reference(steps):
    assert _bft_fold(J, steps) == _bft_fold(P, steps)


def test_leader_schedule_matches_reference():
    schedule = {1: [0], 2: [1, 2], 4: [0]}
    out = []
    for mod in (J, P):
        proto = mod.LeaderScheduleProtocol(schedule)
        st = proto.initial_state()
        rows = []
        for node, slot in ((0, 1), (2, 2), (1, 3), (0, 4)):
            rows.append(proto.check_is_leader(node, slot, None))
            try:
                st = proto.update(node, slot, proto.tick(None, slot, st))
                rows.append(carry.state_to_plain(st))
            except Exception as e:  # noqa: BLE001
                rows.append(carry.error_to_plain(e))
        out.append(rows)
    assert out[0] == out[1]
    assert out[1][5] == ("NotScheduledLeader", {"slot": 3, "node_id": 1})


def test_chain_order_matches_reference():
    for mod in (J, P):
        proto = _pbft(mod)
        assert [proto.compare_candidates(a, b) for a, b in ((None, 3), (3, None), (4, 3), (3, 3))] \
            == [1, -1, -1, 0]


def test_reference_pbft_objects_carry_across():
    jp = _pbft(J)
    assert carry.pbft_params_from_reference(jp.params) == _pbft(P).params
    st = jp.initial_state()
    for s in range(1, 9):
        st = jp.reupdate(_view(J, SEEDS[s % 3], s), s, jp.tick(None, s, st))
    ours = carry.pbft_state_from_reference(st)
    assert carry.state_to_plain(ours) == carry.state_to_plain(st)
    assert [ours.count_signed_by(g) for g in range(3)] == [st.count_signed_by(g)
                                                            for g in range(3)]
