"""A hypothesis state machine over the port's ChainDB on the port's MockFS,
held step by step to the JAX package's ChainDB on its MockFS (after the
reference's `tests/test_model_storage.py` ChainDB machine): random adds
from a fixed block tree, corrupted blocks, clean reopens (with and
without the all-chunks validation) and torn-write crashes with a
validating reopen. After every step both stores must hold the same
chain, volatile fragment, invalid map, LedgerDB states and header
history."""

import pytest

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from hypothesis.stateful import RuleBasedStateMachine, initialize, invariant, rule  # noqa: E402

from torch_ledger_common import (chaindb_plain, forge_after, forge_chain, j_ext,  # noqa: E402
                                 p_ext, port_block)

from ouroboros_consensus_tpu.block.praos_block import Block as JBlock  # noqa: E402
from ouroboros_consensus_tpu.block.praos_block import Header as JHeader  # noqa: E402
from ouroboros_consensus_tpu.storage.open import open_chaindb as j_open  # noqa: E402
from ouroboros_consensus_tpu.utils.fs import MockFS as JMockFS  # noqa: E402
from ouroboros_consensus_tpu_torch.storage.open import open_chaindb as p_open  # noqa: E402
from ouroboros_consensus_tpu_torch.utils.fs import MockFS as PMockFS  # noqa: E402

K = 4
CHUNK = 4


def _tree():
    """A 10-block main chain (even slots) with 2-block branches off
    heights 2, 5 and 8 (odd slots)."""
    main = forge_chain(10, start_slot=2, slot_step=2)
    branches = []
    for h in (2, 5, 8):
        b1 = forge_after(main[:h + 1], 1, main[h].slot + 1, pool_ix=1)
        b2 = forge_after(main[:h + 1] + b1, 1, b1[0].slot + 2)
        branches += b1 + b2
    return main + branches


TREE = _tree()


class ChainDBPair(RuleBasedStateMachine):
    @initialize()
    def setup(self):
        self.jfs, self.pfs = JMockFS(), PMockFS()
        self._open(False)

    def _open(self, validate_all):
        (je, jg), (pe, pg) = j_ext(), p_ext()
        self.j = j_open("chain", je, jg, K, chunk_size=CHUNK, validate_all=validate_all,
                        fs=self.jfs)
        self.p = p_open("chain", pe, pg, K, chunk_size=CHUNK, validate_all=validate_all,
                        fs=self.pfs)

    def _same(self):
        assert chaindb_plain(self.p) == chaindb_plain(self.j)

    @rule(data=st.data())
    def add_block(self, data):
        b = data.draw(st.sampled_from(TREE))
        rj, rp = self.j.add_block(b), self.p.add_block(port_block(b))
        assert (rp.added, rp.selected) == (rj.added, rj.selected)
        self._same()

    @rule(data=st.data())
    def add_invalid_block(self, data):
        parent = data.draw(st.sampled_from(TREE))
        good = forge_chain(1, start_slot=parent.slot + 1, start_bno=parent.block_no + 1,
                           prev=parent.hash_)[0]
        bad = JBlock(JHeader(good.header.body, bytes([good.header.kes_sig[0] ^ 0xFF])
                             + good.header.kes_sig[1:]), good.txs)
        self.j.add_block(bad)
        self.p.add_block(port_block(bad))
        self._same()

    @rule(validate_all=st.booleans())
    def reopen(self, validate_all):
        self.j.close()
        self.p.close()
        self._open(validate_all)
        self._same()

    @rule(keep=st.sampled_from([0.0, 0.3, 0.7, 1.0]))
    def crash_and_reopen(self, keep):
        self.jfs.crash(keep)
        self.pfs.crash(keep)
        assert sorted(self.pfs.files()) == sorted(self.jfs.files())
        self._open(True)
        self._same()

    @invariant()
    def same_tip(self):
        if hasattr(self, "p"):
            tj, tp = self.j.tip_point(), self.p.tip_point()
            assert (tp is None) == (tj is None)
            if tp is not None:
                assert (tp.slot, tp.hash_) == (tj.slot, tj.hash_)


TestChainDBPair = ChainDBPair.TestCase
TestChainDBPair.settings = settings(
    max_examples=10, stateful_step_count=20, deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)
