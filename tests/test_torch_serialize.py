"""The port's snapshot codecs (storage/serialize.py, the framing of
storage/ledgerdb.py) against the JAX package's: the golden files
(`tests/golden/ext_ledger_state.hex`, `praos_block.hex`, read only) byte
for byte, the v2 tagged format for every ledger and chain-dep state the
port has (mock and hard-fork ledgers; Praos, TPraos, PBFT and hard-fork
chain-dep states) byte for byte, each package decoding the other's
bytes, and the era tags the port does not have yet refused."""

import os
from fractions import Fraction

import pytest

from torch_ledger_common import ETA0, j_ext

from ouroboros_consensus_tpu.hardfork.combinator import HFState as JHFState
from ouroboros_consensus_tpu.ledger.extended import ExtLedgerState as JExt
from ouroboros_consensus_tpu.ledger.header_validation import AnnTip as JAnnTip
from ouroboros_consensus_tpu.ledger.header_validation import HeaderState as JHeaderState
from ouroboros_consensus_tpu.ledger.mock import MockState as JMockState
from ouroboros_consensus_tpu.protocol import praos as j_praos
from ouroboros_consensus_tpu.protocol.instances import PBftState as JPBftState
from ouroboros_consensus_tpu.protocol.tpraos import TPraosState as JTPraosState
from ouroboros_consensus_tpu.storage import ledgerdb as j_ledgerdb
from ouroboros_consensus_tpu.storage import serialize as j_ser
from ouroboros_consensus_tpu.testing import fixtures
from ouroboros_consensus_tpu.utils import cbor as j_cbor
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.block.forge import forge_block
from ouroboros_consensus_tpu_torch.block.praos_block import Block
from ouroboros_consensus_tpu_torch.ledger.extended import ExtLedgerState
from ouroboros_consensus_tpu_torch.ledger.header_validation import AnnTip, HeaderState
from ouroboros_consensus_tpu_torch.ledger.mock import MockState
from ouroboros_consensus_tpu_torch.protocol.praos import PraosParams, PraosState
from ouroboros_consensus_tpu_torch.storage import ledgerdb as p_ledgerdb
from ouroboros_consensus_tpu_torch.storage import serialize as p_ser
from ouroboros_consensus_tpu_torch.testing import synth

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the golden files' configuration (tests/test_golden.py)
G_PARAMS = PraosParams(slots_per_kes_period=100, max_kes_evolutions=62, security_param=4,
                       active_slot_coeff=Fraction(1), epoch_length=500, kes_depth=3)
G_POOL = synth.make_pool(7, kes_depth=3)
G_ETA0 = bytes(range(32))


def _golden(name: str) -> bytes:
    with open(os.path.join(GOLDEN, name)) as f:
        return bytes.fromhex(f.read().strip())


def test_praos_block_golden_bytes():
    b = forge_block(G_PARAMS, G_POOL, slot=42, block_no=7, prev_hash=b"\x11" * 32,
                    epoch_nonce=G_ETA0, txs=(b"tx-a", b"tx-b"))
    assert b.bytes_ == _golden("praos_block.hex")
    assert Block.from_bytes(_golden("praos_block.hex")).bytes_ == b.bytes_


def _golden_ext_state() -> ExtLedgerState:
    st = PraosState(last_slot=42, ocert_counters={G_POOL.pool_id: 3},
                    evolving_nonce=b"\x01" * 32, candidate_nonce=b"\x02" * 32,
                    epoch_nonce=G_ETA0, lab_nonce=b"\x03" * 32,
                    last_epoch_block_nonce=b"\x04" * 32)
    return ExtLedgerState(MockState({(bytes(32), 0): (b"alice", 100)}, 42),
                          HeaderState(AnnTip(42, 7, b"\x05" * 32), st))


def test_ext_ledger_state_golden_bytes():
    golden = _golden("ext_ledger_state.hex")
    assert p_ser.encode_ext_state(_golden_ext_state()) == golden
    assert carry.ext_state_to_plain(p_ser.decode_ext_state(golden)) == \
        carry.ext_state_to_plain(_golden_ext_state())


def _praos(**kw):
    base = dict(last_slot=77, ocert_counters={b"\x0a" * 28: 2, b"\x0b" * 28: 0},
                evolving_nonce=b"\x01" * 32, candidate_nonce=None, epoch_nonce=ETA0,
                lab_nonce=b"\x03" * 32, last_epoch_block_nonce=None)
    base.update(kw)
    return base


def _mock():
    return JMockState({(bytes(32), 0): (b"alice", 100), (b"\x07" * 32, 3): (b"bob", 5)}, 77)


CHAIN_DEP = {
    "praos": lambda: j_praos.PraosState(**_praos()),
    "tpraos": lambda: JTPraosState(**_praos()),
    "pbft": lambda: JPBftState(((3, 0), (4, 1), (6, 0))),
    "hf-praos": lambda: JHFState(2, j_praos.PraosState(**_praos())),
    "hf-tpraos": lambda: JHFState(1, JTPraosState(**_praos(candidate_nonce=b"\x09" * 32))),
    "hf-pbft": lambda: JHFState(0, JPBftState(((1, 2),))),
    "genesis": lambda: j_praos.PraosState(),
}
LEDGER = {"mock": _mock, "hf-mock": lambda: JHFState(2, _mock())}


def _ref_state(ledger: str, chain_dep: str, tip=True) -> JExt:
    t = JAnnTip(77, 12, b"\x05" * 32) if tip else None
    return JExt(LEDGER[ledger](), JHeaderState(t, CHAIN_DEP[chain_dep]()))


@pytest.mark.parametrize("tip", [True, False], ids=["tip", "origin"])
@pytest.mark.parametrize("chain_dep", list(CHAIN_DEP))
@pytest.mark.parametrize("ledger", list(LEDGER))
def test_tagged_states_both_ways(ledger, chain_dep, tip):
    ref = _ref_state(ledger, chain_dep, tip)
    ported = carry.ext_state_from_reference(ref)
    data = j_ser.encode_ext_state(ref)
    assert p_ser.encode_ext_state(ported) == data
    untagged = ledger == "mock" and chain_dep in ("praos", "genesis")
    assert (j_cbor.decode(data)[0] == "v2") != untagged
    back = p_ser.decode_ext_state(data)
    assert carry.ext_state_to_plain(back) == carry.ext_state_to_plain(ref)
    assert carry.ext_state_to_plain(j_ser.decode_ext_state(p_ser.encode_ext_state(back))) == \
        carry.ext_state_to_plain(ref)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_framing_both_ways(writer):
    """u32 CRC ‖ CBOR: each package decodes the other's snapshot; the
    unframed payload of an older snapshot is read; a flipped byte is
    refused with the same error."""
    ref = _ref_state("mock", "praos")
    port = carry.ext_state_from_reference(ref)
    data = j_ledgerdb.encode_snapshot(ref) if writer == "jax" else \
        p_ledgerdb.encode_snapshot(port)
    assert data == j_ledgerdb.encode_snapshot(ref) == p_ledgerdb.encode_snapshot(port)
    for dec in (j_ledgerdb.decode_snapshot, p_ledgerdb.decode_snapshot):
        assert carry.ext_state_to_plain(dec(data)) == carry.ext_state_to_plain(ref)
        assert carry.ext_state_to_plain(dec(data[4:])) == carry.ext_state_to_plain(ref)
    bad = bytearray(data)
    bad[-3] ^= 0xFF
    errs = []
    for dec in (j_ledgerdb.decode_snapshot, p_ledgerdb.decode_snapshot):
        with pytest.raises(ValueError) as info:
            dec(bytes(bad))
        errs.append(str(info.value))
    assert errs[0] == errs[1] == "snapshot checksum mismatch"


def test_genesis_state_round_trips():
    je, jg = j_ext()
    data = j_ser.encode_ext_state(jg)
    assert p_ser.encode_ext_state(carry.ext_state_from_reference(jg)) == data
    assert carry.ext_state_to_plain(p_ser.decode_ext_state(data)) == carry.ext_state_to_plain(jg)


@pytest.mark.parametrize("golden", ["mary_shelley_snapshot.hex", "dual_byron_snapshot.hex"])
def test_era_ledger_tags_wait_for_their_eras(golden):
    """The reference's Shelley and Dual-Byron payloads (its golden files)
    are tags the port does not decode yet: ValueError, as the reference
    answers a tag it does not know."""
    o = j_cbor.decode(_golden(golden))
    with pytest.raises(ValueError, match="unknown ledger-state tag"):
        p_ser.decode_ledger_state_tagged(o)


@pytest.mark.parametrize("tag", ["shelley", "byron", "dual_byron", "dual"])
def test_era_tags_refused(tag):
    with pytest.raises(ValueError, match="unknown ledger-state tag"):
        p_ser.decode_ledger_state_tagged([tag, []])
    with pytest.raises(ValueError, match="unknown chain-dep tag"):
        p_ser.decode_chain_dep_tagged([tag, []])


def test_unknown_state_types_refused():
    class Other:
        pass

    with pytest.raises(TypeError, match="no snapshot codec for ledger state Other"):
        p_ser.encode_ledger_state_tagged(Other())
    with pytest.raises(TypeError, match="no snapshot codec for chain-dep state Other"):
        p_ser.encode_chain_dep_tagged(Other())
    st = ExtLedgerState(Other(), HeaderState(None, PraosState()))
    with pytest.raises(TypeError):
        p_ser.encode_ext_state(st)


def test_pool_credentials_match_the_golden_pool():
    """The golden block's pool, made by either package from seed 7."""
    ref = fixtures.make_pool(7, kes_depth=3)
    assert (G_POOL.vk_cold, G_POOL.vrf_vk, G_POOL.kes_vk) == (ref.vk_cold, ref.vrf_vk, ref.kes_vk)
