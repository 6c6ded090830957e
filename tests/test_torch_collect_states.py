"""`PraosProtocol.validate_batch(collect_states=True)` (the LedgerDB's
batched push) against the JAX instance's host fold on the same views:
the state after every valid header, the first error and the final state,
on the port's device path (the plain twins, `device="cpu"`) and its C++
verifier ("native"), for batch-compatible, draft-03 and mixed runs (the
mixed run is cut where the proof format changes and its states
concatenated), clean and with a flipped KES-signature byte at the first,
a middle and the last lane."""

from dataclasses import replace

import numpy as np
import pytest

from torch_ledger_common import (CRYPTO, LVIEW, P_LVIEW, P_PARAMS, PARAMS, forge_chain,
                                 port_block, state_after)

from ouroboros_consensus_tpu.protocol.instances import PraosProtocol as JPraosProtocol
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import nonces
from ouroboros_consensus_tpu_torch.protocol.instances import PraosProtocol

N = 8  # one run inside epoch 0: slots 2..9 of 16, after the genesis block
# (whose null prev-hash would give the packed staging a body-width step)
FORMATS = {"bc": lambda i: False, "draft03": lambda i: True, "mixed": lambda i: i <= N // 2}
BAD = {"clean": None, "first": 0, "middle": N // 2 + 1, "last": N - 1}
FIRST = forge_chain(1)
START = state_after(FIRST)


def _views(fmt: str, bad):
    blocks = forge_chain(N, start_slot=2, start_bno=1, prev=FIRST[0].hash_, state=START,
                         draft03=lambda i: FORMATS[fmt](i + 1))
    jv = [b.header.to_view() for b in blocks]
    pv = [port_block(b).header.to_view() for b in blocks]
    if bad is not None:
        sig = bytearray(jv[bad].kes_sig)
        sig[40] ^= 0x01
        jv[bad] = replace(jv[bad], kes_sig=bytes(sig))
        pv[bad] = replace(pv[bad], kes_sig=bytes(sig))
    return jv, pv


def _reference(jv):
    proto = JPraosProtocol(PARAMS, crypto=CRYPTO, use_device_batch=False)
    return proto.validate_batch(proto.tick(LVIEW, jv[0].slot, START), jv, collect_states=True)


def _port(pv, backend: str, collect_states: bool = True):
    proto = PraosProtocol(P_PARAMS, device="cpu")
    st = carry.state_from_reference(START)
    return proto.validate_batch(proto.tick(P_LVIEW, pv[0].slot, st), pv,
                                collect_states=collect_states, backend=backend)


def _plain(res):
    return (res.n_valid, carry.error_to_plain(res.error), carry.state_to_plain(res.state),
            None if res.states is None else [carry.state_to_plain(s) for s in res.states])


@pytest.mark.parametrize("bad", list(BAD))
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("backend", ["device", "native"])
def test_states_and_first_error_equal_the_host_fold(backend, fmt, bad):
    jv, pv = _views(fmt, BAD[bad])
    ref = _reference(jv)
    got = _port(pv, backend)
    assert _plain(got) == _plain(ref)
    n_bad = BAD[bad]
    assert got.n_valid == (N if n_bad is None else n_bad) == len(got.states)
    if n_bad is not None:
        assert type(got.error).__name__ == "InvalidKesSignatureOCERT"


@pytest.mark.parametrize("fmt", ["bc", "mixed"])
def test_collected_window_folds_its_eta_column_beside_the_carry(fmt):
    """A packed window that collects states takes the exact fold (no
    carry fast path): its final state equals the fast path's, and its
    device nonce carry equals the folded nonces."""
    _jv, pv = _views(fmt, None)
    fast = _port(pv, "device", collect_states=False)
    slow = _port(pv, "device")
    assert fast.states is None and len(slow.states) == N
    assert carry.state_to_plain(slow.state) == carry.state_to_plain(fast.state) \
        == carry.state_to_plain(slow.states[-1])
    ev, cand = nonces.unpack_carry(np.asarray(slow.carry))
    assert (ev, cand) == (slow.state.evolving_nonce, slow.state.candidate_nonce)


def test_collect_states_skips_the_packed_fast_path(monkeypatch):
    calls = []
    real = pbatch._epilogue_packed_fast
    monkeypatch.setattr(pbatch, "_epilogue_packed_fast",
                        lambda *a: calls.append(1) or real(*a))
    _jv, pv = _views("bc", None)
    _port(pv, "device")
    assert calls == []
    _port(pv, "device", collect_states=False)
    assert calls == [1]


def test_empty_run_collects_an_empty_list():
    proto = PraosProtocol(P_PARAMS, device="cpu")
    st = carry.state_from_reference(START)
    res = proto.validate_batch(proto.tick(P_LVIEW, 2, st), [], collect_states=True)
    assert (res.n_valid, res.error, res.states) == (0, None, [])
