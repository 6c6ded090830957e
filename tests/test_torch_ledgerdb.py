"""The port's LedgerDB (storage/ledgerdb.py) against the JAX package's:
push, prune to k, rollback and switch; snapshot files (names and bytes)
and the replay from them (`init_from_snapshots`, its fall back past an
unreadable snapshot); the batched push (`push_many` with
`use_device_batch`, the port on the plain twins) against the JAX host
fold: the states of the valid prefix and the first error, for a clean run
across an epoch boundary and for a body, an envelope and a header failure
in either segment; runs of previously applied blocks reapplied with no
window; no fall back when a window fails to launch."""

import os

import pytest

from torch_ledger_common import (K, forge_after, forge_chain, j_ext, p_ext, port_block,
                                 state_after, states_plain)

from ouroboros_consensus_tpu.block.praos_block import Block as JBlock
from ouroboros_consensus_tpu.block.praos_block import Header as JHeader
from ouroboros_consensus_tpu.ledger import mock as j_mock
from ouroboros_consensus_tpu.storage.immutable import ImmutableDB as JImmutableDB
from ouroboros_consensus_tpu.storage.ledgerdb import InvalidBlock as JInvalidBlock
from ouroboros_consensus_tpu.storage.ledgerdb import LedgerDB as JLedgerDB
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB as PImmutableDB
from ouroboros_consensus_tpu_torch.storage.ledgerdb import InvalidBlock as PInvalidBlock
from ouroboros_consensus_tpu_torch.storage.ledgerdb import LedgerDB as PLedgerDB
from ouroboros_consensus_tpu_torch.utils import trace as T

CHAIN = forge_chain(24)  # slots 1..24: epoch 0 to slot 15, epoch 1 from 16


def _dbs(k=K, use_device_batch=False):
    (je, jg), (pe, pg) = j_ext(), p_ext(use_device_batch)
    return JLedgerDB(je, k, jg), PLedgerDB(pe, k, pg)


def _files(path):
    out = {}
    for f in sorted(os.listdir(path)):
        with open(os.path.join(path, f), "rb") as fh:
            out[f] = fh.read()
    return out


def test_push_rollback_switch_and_snapshots(tmp_path):
    j, p = _dbs()
    for b in CHAIN[:5]:
        j.push(b)
        p.push(port_block(b))
    assert states_plain(p) == states_plain(j) and p.volatile_length() == K
    assert p.rollback(2) == j.rollback(2) is True
    assert p.rollback(5) == j.rollback(5) is False
    assert states_plain(p) == states_plain(j)
    fork = forge_after(CHAIN[:3], 3, 20, pool_ix=1)
    assert p.switch(0, [port_block(b) for b in fork]) == j.switch(0, fork) is True
    assert states_plain(p) == states_plain(j)
    names = [db.take_snapshot(str(tmp_path / name)) for name, db in (("j", j), ("p", p))]
    assert names[1] == names[0] == f"snapshot-{p.anchor().header_state.tip.slot}"
    assert p.take_snapshot(str(tmp_path / "p")) is None  # it exists
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "j"))


def test_snapshots_keep_two(tmp_path):
    j, p = _dbs(k=1)
    for b in CHAIN[:6]:
        j.push(b)
        p.push(port_block(b))
        j.take_snapshot(str(tmp_path / "j"))
        p.take_snapshot(str(tmp_path / "p"))
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "j"))
    assert sorted(PLedgerDB.list_snapshots(str(tmp_path / "p"))) == [4, 5]


def _immutable(path, n, cls=JImmutableDB):
    imm = cls(path, chunk_size=8, repair=True) if cls is PImmutableDB else cls(path, chunk_size=8)
    for b in CHAIN[:n]:
        imm.append_block(b.slot, b.block_no, b.hash_, b.bytes_)
    return imm


@pytest.mark.parametrize("snap", ["none", "jax", "port", "corrupt"])
def test_init_from_snapshots_replays_the_same(tmp_path, snap):
    """The replay of a JAX-written ImmutableDB of 20 blocks from genesis,
    or from a snapshot taken after block 8 by either package, or past a
    corrupted newest snapshot (removed, the older one used): the same
    tip state, the same trace lines and the same files left."""
    _immutable(str(tmp_path / "imm"), 20)
    for name in ("j", "p"):
        (tmp_path / name).mkdir()
    if snap != "none":
        writer = _dbs()[1 if snap == "port" else 0]
        for b in CHAIN[:9]:
            writer.push(b if snap != "port" else port_block(b), apply=False)
            if b.block_no in (4, 8):
                writer._seq = writer._seq[-1:]
                for name in ("j", "p"):
                    writer.take_snapshot(str(tmp_path / name))
        if snap == "corrupt":
            for name in ("j", "p"):
                f = tmp_path / name / f"snapshot-{CHAIN[8].slot}"
                data = bytearray(f.read_bytes())
                data[-2] ^= 0xFF
                f.write_bytes(bytes(data))
    out = []
    for cls, imm_cls, ext, name in ((JLedgerDB, JImmutableDB, j_ext, "j"),
                                     (PLedgerDB, PImmutableDB, p_ext, "p")):
        e, g = ext()
        lines = []
        db = cls.init_from_snapshots(e, K, str(tmp_path / name), g,
                                     imm_cls(str(tmp_path / "imm"), chunk_size=8),
                                     trace=lines.append)
        out.append((states_plain(db), lines, sorted(_files(str(tmp_path / name)))))
    assert out[1] == out[0]
    assert out[1][0][-1][0] == (CHAIN[19].slot, CHAIN[19].hash_)


# -- the batched push ----------------------------------------------------------


def _bad_tx(b):
    return JBlock(b.header, (j_mock.encode_tx([(b"\x05" * 32, 0)], [(b"x", 1)]),))


def _bad_sig(b):
    sig = bytearray(b.header.kes_sig)
    sig[40] ^= 0x01
    return JBlock(JHeader(b.header.body, bytes(sig)), b.txs)


def _bad_envelope(b):
    base = [x for x in CHAIN if x.block_no < b.block_no]
    return forge_chain(1, start_slot=b.slot, start_bno=b.block_no + 2, prev=b.prev_hash,
                       state=state_after(base))[0]


# (what breaks, where): the run is CHAIN[3:24] (slots 4..24), its epoch
# segments CHAIN[3:15] and CHAIN[15:24]
RUNS = {
    "clean": None,
    "body-first-segment": (_bad_tx, 9),
    "header-first-segment": (_bad_sig, 9),
    "envelope-second-segment": (_bad_envelope, 19),
    "header-second-segment": (_bad_sig, 19),
    "header-first-lane": (_bad_sig, 3),
    "header-relinked": (_bad_sig, 9),  # the chain forged on from the bad block
    # epoch 1's first header: its window starts from the ticked state (the
    # epoch nonce rotated), where the reference's replay fold keeps the
    # state before the tick (ROADMAP §C); the LedgerDB pushes no state for
    # a failing header, so the checkpoints agree
    "header-epoch-first": (_bad_sig, 15),
}


def _push_many(db, blocks, package):
    invalid = PInvalidBlock if package == "p" else JInvalidBlock
    try:
        db.push_many(blocks)
        return None
    except invalid as e:
        return (e.point.slot, e.point.hash_, carry.error_to_plain(e.reason))


@pytest.mark.parametrize("case", list(RUNS))
def test_batched_push_equals_the_host_fold(case):
    blocks = list(CHAIN)
    if RUNS[case] is not None:
        make, at = RUNS[case]
        blocks[at] = make(blocks[at])
        if case == "header-relinked":
            blocks[at + 1:] = forge_after(blocks[:at + 1], len(blocks) - at - 1,
                                          blocks[at].slot + 1)
    j, p = _dbs(k=30, use_device_batch=True)
    events = []
    p.tracer = events.append
    for b in blocks[:3]:
        j.push(b)
        p.push(port_block(b))
    ref = _push_many(j, blocks[3:], "j")
    got = _push_many(p, [port_block(b) for b in blocks[3:]], "p")
    assert got == ref
    assert states_plain(p) == states_plain(j)
    assert all(isinstance(ev, T.ValidatedBatch) for ev in events)
    seen = [(ev.n_headers, ev.n_valid) for ev in events]
    # a flipped signature changes the block's hash, so the next block's
    # envelope fails and the segment ends at the bad block
    want = {"clean": [(12, 12), (9, 9)], "body-first-segment": [(6, 6)],
            "header-first-segment": [(7, 6)], "envelope-second-segment": [(12, 12), (4, 4)],
            "header-second-segment": [(12, 12), (5, 4)], "header-first-lane": [(1, 0)],
            "header-relinked": [(12, 6)], "header-epoch-first": [(12, 12), (1, 0)]}[case]
    assert seen == want


def test_reapplied_runs_launch_no_window(monkeypatch):
    """push_many over a run the LedgerDB validated before (a switch back)
    reapplies it with no window, then batches the fresh run after it."""
    j, p = _dbs(k=30, use_device_batch=True)
    windows = []
    dispatch = pbatch.dispatch_prepared
    monkeypatch.setattr(pbatch, "dispatch_prepared",
                        lambda sw, *a, **kw: windows.append(sw.b) or dispatch(sw, *a, **kw))
    for b in CHAIN[:3]:
        j.push(b)
        p.push(port_block(b))
    for db, conv in ((j, lambda b: b), (p, port_block)):
        db.push_many([conv(b) for b in CHAIN[3:10]])
        assert db.rollback(5)
    assert windows == [7]
    for db, conv in ((j, lambda b: b), (p, port_block)):
        db.push_many([conv(b) for b in CHAIN[5:14]])
    assert windows == [7, 4]  # CHAIN[5:10] reapplied, CHAIN[10:14] fresh
    assert states_plain(p) == states_plain(j)
    for db in (j, p):
        db.gc_prev_applied(CHAIN[8].slot)
    assert sorted(p._prev_applied.items()) == sorted(j._prev_applied.items())


def test_a_window_that_fails_to_launch_raises(monkeypatch):
    """No fall back: the failure leaves push_many as it is, and the C++
    verifier a header is never asked."""
    _j, p = _dbs(k=30, use_device_batch=True)
    p.push(port_block(CHAIN[0]))

    def boom(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(pbatch, "dispatch_prepared", boom)
    monkeypatch.setattr(type(p.ext.protocol), "update", boom)
    before = states_plain(p)
    with pytest.raises(RuntimeError, match="launch failed"):
        p.push_many([port_block(b) for b in CHAIN[1:6]])
    assert states_plain(p) == before


def test_single_block_and_apply_false_take_the_fold(monkeypatch):
    """A run of one block goes through `update` (the C++ verifier), and
    apply=False reapplies: neither opens a window."""
    j, p = _dbs(k=30, use_device_batch=True)
    monkeypatch.setattr(pbatch, "dispatch_prepared",
                        lambda *a, **kw: (_ for _ in ()).throw(AssertionError("a window")))
    j.push_many(CHAIN[:1])
    p.push_many([port_block(CHAIN[0])])
    j.push_many(CHAIN[1:6], apply=False)
    p.push_many([port_block(b) for b in CHAIN[1:6]], apply=False)
    assert states_plain(p) == states_plain(j)


def test_malformed_proof_length_raises_not_staged_on_the_device_path():
    """A header whose VRF proof is neither 80 nor 128 bytes: the host fold
    (the JAX package's, and the port's C++ verifier a header) marks it
    invalid after pushing the states before it; the port's device batch
    raises NotStagedError("proof-format") out of push_many, as the
    reference's device path raises AssertionError (ROADMAP §C), before
    any state of the segment is pushed."""
    from ouroboros_consensus_tpu.block import forge_block
    from ouroboros_consensus_tpu.protocol import praos as j_praos

    from torch_ledger_common import LVIEW, PARAMS, POOLS

    base = CHAIN[:9]
    st = j_praos.tick(PARAMS, LVIEW, 10, state_after(base))
    good = CHAIN[9]
    odd = forge_block(PARAMS, POOLS[9 % 2], slot=10, block_no=9, prev_hash=base[-1].hash_,
                      epoch_nonce=st.state.epoch_nonce,
                      is_leader=j_praos.PraosIsLeader(good.header.body.vrf_output,
                                                      good.header.body.vrf_proof + bytes(20)))
    blocks = base + [odd]
    j, p = _dbs(k=30, use_device_batch=True)
    _jn, pn = _dbs(k=30)
    for db in (j, p, pn):
        db.push(blocks[0] if db is j else port_block(blocks[0]))
    ref = _push_many(j, blocks[1:], "j")
    assert ref is not None and ref[:2] == (odd.slot, odd.hash_)
    assert _push_many(pn, [port_block(b) for b in blocks[1:]], "p") == ref
    assert states_plain(pn) == states_plain(j)
    with pytest.raises(pbatch.NotStagedError) as info:
        p.push_many([port_block(b) for b in blocks[1:]])
    assert info.value.reason == "proof-format"
    assert p.volatile_length() == 1
