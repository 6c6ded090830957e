"""The port's HeaderStateHistory (ledger/header_history.py) against the
JAX package's, after the reference's `tests/test_header_history.py`: the
same folds, rewinds, rollbacks, trims (with and without the settled
gate) and lookups give the same states; and a ChainDB of each package
keeps the same k-deep history through growth, copy to the ImmutableDB
and a fork switch, on the port's C++ verifier and on its batched push."""

import pytest

from torch_ledger_common import (LVIEW, P_LVIEW, chaindb_plain, forge_after, forge_chain, j_ext,
                                 p_ext, port_block)

from ouroboros_consensus_tpu.ledger.header_history import HeaderStateHistory as JHistory
from ouroboros_consensus_tpu.storage.open import open_chaindb as j_open
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.block.abstract import Point
from ouroboros_consensus_tpu_torch.ledger.header_history import HeaderStateHistory as PHistory
from ouroboros_consensus_tpu_torch.storage.open import open_chaindb as p_open

BLOCKS = forge_chain(12)


def _both(k=None, n=8):
    (je, jg), (pe, pg) = j_ext(), p_ext()
    jh = JHistory.from_chain(je.protocol, lambda _s: LVIEW, jg.header_state.chain_dep_state,
                             [b.header for b in BLOCKS[:n]], k=k)
    ph = PHistory.from_chain(pe.protocol, lambda _s: P_LVIEW, pg.header_state.chain_dep_state,
                             [port_block(b).header for b in BLOCKS[:n]], k=k)
    return jh, ph


def _plain(h):
    return ([(x.point.slot, x.point.hash_) for x in h.headers],
            [carry.state_to_plain(s) for s in h.states], h.trimmed)


def test_from_chain_equals_the_sequential_fold():
    jh, ph = _both()
    assert _plain(ph) == _plain(jh)
    assert len(ph.states) == len(ph.headers) + 1 == 9
    assert carry.state_to_plain(ph.current()) == carry.state_to_plain(jh.current())
    assert ph.tip_point() == Point(BLOCKS[7].slot, BLOCKS[7].hash_)


@pytest.mark.parametrize("op", ["truncate-mid", "truncate-anchor", "truncate-unknown",
                                "rollback-2", "rollback-too-far", "rollback-0"])
def test_rewind_and_rollback(op):
    jh, ph = _both(n=6)
    out = []
    for h, conv in ((jh, lambda b: b.point), (ph, lambda b: Point(b.slot, b.hash_))):
        if op == "truncate-mid":
            r = h.truncate_to(conv(BLOCKS[3]))
        elif op == "truncate-anchor":
            r = h.truncate_to(None)
        elif op == "truncate-unknown":
            r = h.truncate_to(conv(BLOCKS[9]))
        else:
            r = h.rollback_n({"rollback-2": 2, "rollback-too-far": 99, "rollback-0": 0}[op])
        out.append((r, _plain(h)))
    assert out[1] == out[0]


def test_trim_to_k_and_the_settled_gate():
    jh, ph = _both(k=4, n=10)
    assert _plain(ph) == _plain(jh) and len(ph.headers) == 4 and ph.trimmed
    assert ph.truncate_to(None) is jh.truncate_to(None) is False
    out = []
    for cls, ext, lv, conv in ((JHistory, j_ext, LVIEW, lambda b: b),
                               (PHistory, p_ext, P_LVIEW, port_block)):
        e, g = ext()
        settled = set()
        h = cls(k=4, settled=lambda p, settled=settled: (p.slot, p.hash_) in settled)
        h.reset(g.header_state.chain_dep_state)
        for b in BLOCKS[:10]:
            hd = conv(b).header
            h.extend(hd, e.protocol.update(hd.to_view(), hd.slot,
                                           e.protocol.tick(lv, hd.slot, h.current())))
        n_before = len(h.headers)
        settled.update((b.slot, b.hash_) for b in BLOCKS[:8])
        h.trim()
        out.append((n_before, _plain(h)))
    assert out[1] == out[0] and out[1][0] == 10 and len(out[1][1][0]) == 4


def test_state_at_lookup():
    jh, ph = _both(n=6)
    for b in BLOCKS[:6]:
        assert carry.state_to_plain(ph.state_at(Point(b.slot, b.hash_))) == \
            carry.state_to_plain(jh.state_at(b.point))
    assert ph.state_at(Point(BLOCKS[11].slot, BLOCKS[11].hash_)) is None


def _dbs(tmp_path, use_device_batch):
    (je, jg), (pe, pg) = j_ext(), p_ext(use_device_batch)
    k = 5
    return (j_open(str(tmp_path / "j"), je, jg, k),
            p_open(str(tmp_path / "p"), pe, pg, k), k)


@pytest.mark.parametrize("mode", ["native", "device"])
def test_chaindb_keeps_the_same_history(tmp_path, mode):
    j, p, k = _dbs(tmp_path, mode == "device")
    for b in BLOCKS:
        j.add_block(b)
        p.add_block(port_block(b))
    assert chaindb_plain(p) == chaindb_plain(j)
    assert len(p.header_history.headers) <= k
    for b in BLOCKS:
        hp, hj = p.header_state_at(Point(b.slot, b.hash_)), j.header_state_at(b.point)
        assert (hp is None) == (hj is None)
        if hp is not None:
            assert (hp.tip, carry.state_to_plain(hp.chain_dep_state)) == \
                (carry.header_state_from_reference(hj).tip,
                 carry.state_to_plain(hj.chain_dep_state))
    assert p.header_state_at(Point(BLOCKS[0].slot, BLOCKS[0].hash_)) is None


@pytest.mark.parametrize("mode", ["native", "device"])
def test_chaindb_history_follows_a_fork_switch(tmp_path, mode):
    j, p, _k = _dbs(tmp_path, mode == "device")
    trunk = BLOCKS[:4]
    fork = forge_after(trunk[:2], 4, trunk[1].slot + 5)
    for b in trunk + fork[1:] + fork[:1]:
        j.add_block(b)
        p.add_block(port_block(b))
    assert chaindb_plain(p) == chaindb_plain(j)
    hh = p.header_history
    assert hh.states[-1].tip.hash_ == fork[-1].hash_
    assert hh.state_at(Point(trunk[3].slot, trunk[3].hash_)) is None
    assert all(hh.states[i + 1].tip.hash_ == h.hash_ for i, h in enumerate(hh.headers))
