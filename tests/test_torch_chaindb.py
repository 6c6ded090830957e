"""The port's ChainDB (storage/chaindb.py, storage/open.py) against the JAX
package's, after the reference's `tests/test_storage.py` ChainDB cases:
the same blocks in the same order go to both, and the tip, the whole
chain, the volatile fragment, the invalid map, every LedgerDB state, the
header history, the followers' updates, the typed tracer's event
sequence and the files on disk must be equal. The port runs with the C++
verifier a header ("native") and with its batched push on the plain twins
("device", `use_device_batch=True, device="cpu"`); the JAX package with
its host fold."""

import os

import pytest

from torch_ledger_common import (K, chaindb_plain, event_plain, forge_after, forge_chain, j_ext,
                                 p_ext, port_block)

from ouroboros_consensus_tpu.block.praos_block import Block as JBlock
from ouroboros_consensus_tpu.block.praos_block import Header as JHeader
from ouroboros_consensus_tpu.storage import chaindb as j_chaindb
from ouroboros_consensus_tpu.storage.open import open_chaindb as j_open
from ouroboros_consensus_tpu.utils import sim as j_sim
from ouroboros_consensus_tpu.utils import trace as j_trace
from ouroboros_consensus_tpu_torch.block.abstract import Point
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol.instances import PraosProtocol
from ouroboros_consensus_tpu_torch.storage import chaindb as p_chaindb
from ouroboros_consensus_tpu_torch.storage.ledgerdb import LedgerDB as PLedgerDB
from ouroboros_consensus_tpu_torch.storage.open import open_chaindb as p_open
from ouroboros_consensus_tpu_torch.utils import sim as p_sim
from ouroboros_consensus_tpu_torch.utils import trace as p_trace

MODES = ["native", "device"]


class Pair:
    """A JAX ChainDB and a port ChainDB under tmp_path/<name>-{j,p}, fed
    the same blocks; each with a ListTracer of its typed events."""

    def __init__(self, tmp_path, mode="native", name="db", chunk_size=100, **kw):
        self.tmp, self.mode, self.name, self.chunk, self.kw = tmp_path, mode, name, chunk_size, kw
        self.open()

    def path(self, side):
        return str(self.tmp / f"{self.name}-{side}")

    def open(self, **kw):
        (je, jg), (pe, pg) = j_ext(), p_ext(self.mode == "device")
        self.jt, self.pt = j_trace.ListTracer(), p_trace.ListTracer()
        args = {"chunk_size": self.chunk, **self.kw, **kw}
        self.j = j_open(self.path("j"), je, jg, K, tracer=self.jt, **args)
        self.p = p_open(self.path("p"), pe, pg, K, tracer=self.pt, **args)

    def add(self, blocks):
        out = []
        for b in blocks:
            rj, rp = self.j.add_block(b), self.p.add_block(port_block(b))
            assert (rp.added, rp.selected) == (rj.added, rj.selected)
            out.append(rp)
        return out

    def check(self):
        assert chaindb_plain(self.p) == chaindb_plain(self.j)
        assert [event_plain(e) for e in self.pt.events] == \
            [event_plain(e) for e in self.jt.events]

    def files(self, side):
        out = {}
        root = self.path(side)
        for d, _subs, fs in os.walk(root):
            for f in fs:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
        return out

    def same_files(self):
        assert self.files("p") == self.files("j")


@pytest.mark.parametrize("mode", MODES)
def test_linear_growth_copies_to_immutable(tmp_path, mode):
    db = Pair(tmp_path, mode)
    blocks = forge_chain(7)
    assert all(r.selected for r in db.add(blocks))
    db.check()
    assert db.p.immutable.n_blocks() == 4 and len(db.p.current_chain) == 3
    db.p.close()
    db.j.close()
    db.same_files()


@pytest.mark.parametrize("mode", MODES)
def test_prefers_the_longer_fork(tmp_path, mode):
    db = Pair(tmp_path, mode)
    main = forge_chain(4)
    db.add(main)
    fork = forge_after(main[:2], 5, main[1].slot + 1, pool_ix=1, slot_step=2)
    db.add(fork)
    db.check()
    assert db.p.tip_point().hash_ == fork[-1].hash_


@pytest.mark.parametrize("mode", MODES)
def test_out_of_order_arrival(tmp_path, mode):
    """Nothing is selectable until the chain connects; then the whole
    suffix is one push_many (one window in device mode)."""
    db = Pair(tmp_path, mode)
    blocks = forge_chain(5)
    assert not any(r.selected for r in db.add(list(reversed(blocks[1:]))))
    assert db.add(blocks[:1])[0].selected
    db.check()
    assert db.p.tip_point().hash_ == blocks[-1].hash_


@pytest.mark.parametrize("mode", MODES)
def test_invalid_block_marked_and_prefix_adopted(tmp_path, mode):
    db = Pair(tmp_path, mode)
    blocks = forge_chain(4)
    bad = JBlock(blocks[2].header, (b"not-a-valid-tx-cbor",))
    db.add([blocks[0], blocks[1], bad])
    db.check()
    assert db.p.tip_point().hash_ == blocks[1].hash_
    assert db.p.get_is_invalid_block(bad.hash_) is not None
    more = forge_after(blocks[:2], 2, 10, pool_ix=1)
    db.add(more)
    db.check()
    assert db.p.tip_point().hash_ == more[-1].hash_


@pytest.mark.parametrize("mode", MODES)
def test_restart_recovers(tmp_path, mode):
    db = Pair(tmp_path, mode)
    blocks = forge_chain(7)
    db.add(blocks)
    db.open()  # snapshot + immutable replay + volatile reparse, selection
    db.check()
    assert [b.hash_ for b in db.p.stream_all()] == [b.hash_ for b in blocks]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_opens_the_others_store(tmp_path, writer):
    """A store written and closed by one package (chunks, volatile files,
    snapshots) opens in the other to the same chain and states."""
    blocks = forge_chain(9)
    (je, jg), (pe, pg) = j_ext(), p_ext()
    path = str(tmp_path / "db")
    if writer == "jax":
        w = j_open(path, je, jg, K, chunk_size=8)
        for b in blocks:
            w.add_block(b)
    else:
        w = p_open(path, pe, pg, K, chunk_size=8)
        for b in blocks:
            w.add_block(port_block(b))
    w.close()
    j = j_open(path, j_ext()[0], jg, K, chunk_size=8)
    p = p_open(path, p_ext()[0], pg, K, chunk_size=8)
    assert chaindb_plain(p) == chaindb_plain(j)
    assert p.tip_point().hash_ == blocks[-1].hash_


@pytest.mark.parametrize("tentative", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_follower_updates(tmp_path, mode, tentative):
    db = Pair(tmp_path, mode)
    fj, fp = db.j.new_follower(tentative), db.p.new_follower(tentative)
    main = forge_chain(4)
    db.add(main)
    fork = forge_after(main[:1], 4, main[0].slot + 1, pool_ix=1, slot_step=2)
    db.add(fork)

    def plain(ups):
        return [(kind, None if x is None else (x.slot, x.hash_)) for kind, x in ups]

    assert plain(fp.take_updates()) == plain(fj.take_updates())
    db.check()
    fp.close()
    assert fp not in db.p.followers


def _counting(monkeypatch):
    """The port's crypto calls: `update` (the C++ verifier a header) and
    the device windows (`dispatch_prepared`)."""
    calls = {"update": 0, "windows": []}
    real_update, dispatch = PraosProtocol.update, pbatch.dispatch_prepared

    def update(self, *a):
        calls["update"] += 1
        return real_update(self, *a)

    def window(sw, *a, **kw):
        calls["windows"].append(sw.b)
        return dispatch(sw, *a, **kw)

    monkeypatch.setattr(PraosProtocol, "update", update)
    monkeypatch.setattr(pbatch, "dispatch_prepared", window)
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_fork_switch_reapplies_prev_validated(tmp_path, mode, monkeypatch):
    """A switch back across blocks validated before does not verify them
    again (LgrDB's prev-applied set, Impl/LgrDB.hs:86, :330): only the two
    fresh blocks pay (two C++ verifications, or one window of 2)."""
    calls = _counting(monkeypatch)
    db = Pair(tmp_path, mode)
    chain_a = forge_chain(2, start_slot=2, slot_step=2)
    db.add(chain_a)
    chain_b = forge_chain(3, start_slot=1, pool_ix=1, slot_step=2)
    db.add(chain_b)
    assert db.p.tip_point().hash_ == chain_b[-1].hash_
    ext_a = forge_after(chain_a, 2, chain_a[-1].slot + 2, slot_step=2)
    before = (calls["update"], list(calls["windows"]))
    db.add(ext_a)
    db.check()
    assert db.p.tip_point().hash_ == ext_a[-1].hash_
    if mode == "native":
        assert calls["update"] - before[0] == 2 and calls["windows"] == []
    else:
        # the add of ext_a[0] switches with chain_a reapplied and one
        # fresh block (a run of 3: one window of 1); ext_a[1] extends
        assert calls["windows"][len(before[1]):] == [1]
        assert calls["update"] - before[0] == 1


@pytest.mark.parametrize("mode", MODES)
def test_ranged_stream_is_gc_safe(tmp_path, mode):
    db = Pair(tmp_path, mode)
    blocks = forge_chain(8)
    db.add(blocks)
    for side in ("j", "p"):
        d = getattr(db, side)
        conv = (lambda p: p) if side == "j" else (lambda p: Point(p.slot, p.hash_))
        assert [b.hash_ for b in d.stream()] == [b.hash_ for b in blocks]
        got = list(d.stream(conv(blocks[1].point), conv(blocks[5].point)))
        assert [b.hash_ for b in got] == [b.hash_ for b in blocks[2:6]]
    it = db.p.stream(Point(blocks[1].slot, blocks[1].hash_), Point(blocks[5].slot, blocks[5].hash_))
    db.add(forge_after(blocks, 3, 9))
    assert [b.hash_ for b in it] == [b.hash_ for b in blocks[2:6]]
    with pytest.raises(p_chaindb.MissingBlockError):
        db.p.stream(Point(999, b"x" * 32), None)
    db.check()


def test_init_selection_not_shadowed_by_an_invalid_candidate(tmp_path):
    """A corrupted sibling that outranks the valid tip (same length, a
    better VRF tie-break) is tried first and rejected; the valid chain
    stays, also after a reopen (the invalid set wiped)."""
    db = Pair(tmp_path)
    main = forge_chain(2)
    db.add(main)
    proto = db.j.ext.protocol
    bad = None
    for slot in range(3, 40, 2):
        cand = forge_after(main[:1], 1, slot, pool_ix=1)[0]
        if proto.compare_candidates(proto.select_view(main[1].header),
                                    proto.select_view(cand.header)) > 0:
            bad = JBlock(JHeader(cand.header.body, bytes([cand.header.kes_sig[0] ^ 0xFF])
                                 + cand.header.kes_sig[1:]), cand.txs)
            break
    assert bad is not None
    db.add([bad])
    db.check()
    assert db.p.tip_point().hash_ == main[1].hash_
    db.j.close()
    db.p.close()
    db.open()
    db.check()
    assert db.p.tip_point().hash_ == main[1].hash_


@pytest.mark.parametrize("mode", MODES)
def test_async_mode_equals_sync_mode(tmp_path, mode):
    """The decoupled add-block queue and background copy/GC on the sim
    give the chain (and the events' kinds) the synchronous path gives,
    in both packages."""
    blocks = forge_chain(8)
    fork = forge_after(blocks[:3], 3, 2 + 3, pool_ix=1, slot_step=7)
    sequence = blocks[:4] + fork + blocks[4:]
    sync = Pair(tmp_path, mode, name="sync")
    sync.add(sequence)
    dec = Pair(tmp_path, mode, name="async")
    for db, sim_mod, conv in ((dec.j, j_sim, lambda b: b), (dec.p, p_sim, port_block)):
        sim = sim_mod.Sim()
        for i, r in enumerate(db.start_decoupled(sim)):
            sim.spawn(r, f"runner{i}")

        def feeder(db=db, sim_mod=sim_mod, conv=conv):
            for b in sequence:
                p = db.add_block_async(conv(b))
                if p.result is None:
                    yield sim_mod.Wait(p.processed)
                yield sim_mod.Sleep(0.01)

        sim.spawn(feeder(), "feeder")
        sim.run(until=60.0)
    dec.check()
    assert [b.hash_ for b in dec.p.stream_all()] == [b.hash_ for b in sync.p.stream_all()]
    assert dec.p.tip_point() == sync.p.tip_point()


def test_disk_policy_matches():
    for k, interval in ((2160, None), (4, 100.0)):
        j, p = j_chaindb.DiskPolicy(k, interval), p_chaindb.DiskPolicy(k, interval)
        assert p.interval_s == j.interval_s
        cases = [(0, 0.0), (k - 1, 1e9), (k, 0.0), (10, 4319.0), (0, 4320.0),
                 (50_000, 359.0), (50_000, 360.0), (49_999, 360.0), (1, 100.0)]
        assert [p.should_take_snapshot(n, t) for n, t in cases] == \
            [j.should_take_snapshot(n, t) for n, t in cases]
        j.snapshot_taken(1000.0)
        p.snapshot_taken(1000.0)
        cases = [(n, t + 1000.0) for n, t in cases]
        assert [p.should_take_snapshot(n, t) for n, t in cases] == \
            [j.should_take_snapshot(n, t) for n, t in cases]


def test_time_based_snapshots_on_the_sim_clock(tmp_path):
    class FakeRuntime:
        now = 0.0

        def fire(self, ev):
            pass

    db = Pair(tmp_path, chunk_size=21600)
    for side, mod in (("j", j_chaindb), ("p", p_chaindb)):
        d = getattr(db, side)
        d.runtime = FakeRuntime()
        d.disk_policy = mod.DiskPolicy(k=K, requested_interval_s=60.0)
    blocks = forge_chain(20)
    for lo, hi, now in ((0, 8, 0.0), (8, 14, 30.0), (14, 20, 100.0)):
        for side in ("j", "p"):
            getattr(db, side).runtime.now = now
        db.add(blocks[lo:hi])
        assert PLedgerDB.list_snapshots(db.p.snap_dir) and \
            sorted(PLedgerDB.list_snapshots(db.p.snap_dir)) == \
            sorted(PLedgerDB.list_snapshots(db.j.snap_dir))
    db.check()
    db.same_files()


def test_events_and_files_of_a_busy_sequence(tmp_path):
    """Growth past k (copies, GC, snapshots every 2 copied blocks), an
    older-than-k block, a duplicate, an invalid block, a fork switch and
    a block arriving before its parent: the same typed events, in order,
    and the same files."""
    db = Pair(tmp_path, "device", chunk_size=8)
    for d in (db.j, db.p):
        d.snapshot_interval = 2
    main = forge_chain(10)
    db.add(main[:6])
    db.add([main[0], main[5]])  # older than k; a duplicate of the tip
    bad = JBlock(main[6].header, (b"junk",))
    db.add([bad, bad])  # invalid, then ignored as invalid
    fork = forge_after(main[:5], 3, main[4].slot + 2, pool_ix=1, slot_step=3)
    db.add(fork[1:] + fork[:1])
    more = forge_after(fork, 2, fork[-1].slot + 1)
    db.add(list(reversed(more)))
    db.check()
    kinds = {type(e).__name__ for e in db.pt.events}
    assert {"IgnoreBlockOlderThanK", "IgnoreInvalidBlock", "InvalidBlockEvent",
            "SwitchedToAFork", "CopiedToImmutableDB", "TookSnapshot", "PerformedGC",
            "StoreButDontChange", "ValidCandidate"} <= kinds
    db.j.close()
    db.p.close()
    db.same_files()


def test_header_state_queries_match(tmp_path):
    db = Pair(tmp_path, "device")
    blocks = forge_chain(6)
    db.add(blocks[1:] + blocks[:1])
    for b in blocks:
        hp = db.p.header_state_at(Point(b.slot, b.hash_))
        hj = db.j.header_state_at(b.point)
        assert (hp is None) == (hj is None)
        if hp is not None:
            assert (hp.tip.slot, hp.tip.hash_) == (hj.tip.slot, hj.tip.hash_)
    assert db.p.tip_block_no() == db.j.tip_block_no()
    assert db.p.get_block(Point(blocks[0].slot, blocks[0].hash_)).hash_ == blocks[0].hash_
    assert db.p.get_past_ledger(None) is db.p.ledgerdb.past_state(None)
