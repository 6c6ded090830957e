"""The port's ledger core (ouroboros_consensus_tpu_torch/ledger/) against
the JAX package's on the same inputs: the envelope checks, the mock UTxO
ledger's tx rules and codec, the stake snapshots and ledger views of its
StakeConfig, the extended ledger's apply and reapply folds over a forged
chain that crosses epoch boundaries (the state at every position, the
first error), InspectLedger, and the state crossing of carry.py. States
and errors are compared as plain values."""

from dataclasses import dataclass, replace

import pytest

from torch_ledger_common import (LVIEW, P_LVIEW, P_PARAMS, PARAMS, POOLS, forge_chain, j_ext,
                                 p_ext, port_block)

from ouroboros_consensus_tpu.hardfork.combinator import HFState as JHFState
from ouroboros_consensus_tpu.ledger import header_validation as j_hv
from ouroboros_consensus_tpu.ledger import inspect as j_inspect
from ouroboros_consensus_tpu.ledger import mock as j_mock
from ouroboros_consensus_tpu.ledger.abstract import OutsideForecastRange as JOutside
from ouroboros_consensus_tpu.protocol.views import hash_vrf_vk
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.ledger import header_validation as p_hv
from ouroboros_consensus_tpu_torch.ledger import inspect as p_inspect
from ouroboros_consensus_tpu_torch.ledger import mock as p_mock
from ouroboros_consensus_tpu_torch.ledger.abstract import OutsideForecastRange as POutside

ADDR_A, ADDR_B, ADDR_C = b"addr-a", b"addr-b", b"addr-c"
GENESIS_OUTS = [(ADDR_A, 60), (ADDR_B, 40)]
ZERO = bytes(32)


def _stake_configs():
    deleg = {ADDR_A: POOLS[0].pool_id, ADDR_B: POOLS[1].pool_id, ADDR_C: POOLS[1].pool_id}
    vrf = {p.pool_id: hash_vrf_vk(p.vrf_vk) for p in POOLS}
    j = j_mock.MockConfig(LVIEW, PARAMS.stability_window,
                          stake=j_mock.StakeConfig(deleg, vrf, PARAMS.epoch_length))
    p = p_mock.MockConfig(P_LVIEW, P_PARAMS.stability_window,
                          stake=p_mock.StakeConfig(deleg, vrf, P_PARAMS.epoch_length))
    return j, p


def _txs(n):
    """n txs: each spends A's newest output into A (one less) and C (one),
    so that the pools' stake shares move every block."""
    out, txin, v = [], (ZERO, 0), 60
    for _ in range(n):
        tx = j_mock.encode_tx([txin], [(ADDR_A, v - 1), (ADDR_C, 1)])
        out.append(tx)
        txin, v = (j_mock.tx_id(tx), 0), v - 1
    return out


# -- the envelope ------------------------------------------------------------


def _tip(mod, slot, bno, h):
    return mod.AnnTip(slot, bno, h)


@dataclass
class _Hdr:
    block_no: int
    slot: int
    prev_hash: bytes | None


ENVELOPES = {
    "genesis-ok": (None, _Hdr(0, 3, None)),
    "genesis-block-no": (None, _Hdr(1, 3, None)),
    "genesis-prev": (None, _Hdr(0, 3, b"\x01" * 32)),
    "ok": ((5, 2, b"\x07" * 32), _Hdr(3, 6, b"\x07" * 32)),
    "block-no": ((5, 2, b"\x07" * 32), _Hdr(4, 6, b"\x07" * 32)),
    "slot": ((5, 2, b"\x07" * 32), _Hdr(3, 5, b"\x07" * 32)),
    "prev": ((5, 2, b"\x07" * 32), _Hdr(3, 6, b"\x08" * 32)),
}


@pytest.mark.parametrize("case", list(ENVELOPES))
def test_envelope_checks_match(case):
    tip, hdr = ENVELOPES[case]
    out = []
    for mod in (j_hv, p_hv):
        try:
            mod.validate_envelope(None if tip is None else _tip(mod, *tip), hdr)
            out.append(None)
        except mod.HeaderEnvelopeError as e:
            out.append(carry.error_to_plain(e))
    assert out[0] == out[1]
    assert (out[1] is None) == case.endswith("ok")


# -- the mock ledger's tx rules and codec ------------------------------------


TXS = {
    "spend": lambda: j_mock.encode_tx([(ZERO, 0)], [(ADDR_B, 10), (ADDR_C, 50)]),
    "missing": lambda: j_mock.encode_tx([(b"\x09" * 32, 0)], [(ADDR_B, 10)]),
    "duplicate": lambda: j_mock.encode_tx([(ZERO, 0), (ZERO, 0)], [(ADDR_B, 120)]),
    "not-conserved": lambda: j_mock.encode_tx([(ZERO, 1)], [(ADDR_B, 39)]),
    "garbage": lambda: b"\xff\x00not cbor",
    "float-index": lambda: j_mock.cbor.encode([[[ZERO, 0.0]], [[ADDR_B, 60]]]),
    "text-amount": lambda: j_mock.cbor.encode([[[ZERO, 1]], [[ADDR_B, "40"]]]),
}


@pytest.mark.parametrize("case", list(TXS))
@pytest.mark.parametrize("conserve", [True, False])
def test_apply_tx_matches(case, conserve):
    tx = TXS[case]()
    out = []
    for mod, lv in ((j_mock, LVIEW), (p_mock, P_LVIEW)):
        ledger = mod.MockLedger(mod.MockConfig(lv, 9, check_value_conservation=conserve))
        utxo = dict(ledger.genesis_state(GENESIS_OUTS).utxo)
        try:
            out.append(("ok", sorted(ledger.apply_tx(utxo, tx).items())))
        except mod.InvalidTx as e:
            out.append(("err", carry.error_to_plain(e), sorted(utxo.items())))
    assert out[0] == out[1]


def test_tx_codec_and_ids_match():
    for tx in _txs(4):
        assert p_mock.tx_id(tx) == j_mock.tx_id(tx)
        assert p_mock.decode_tx(tx) == j_mock.decode_tx(tx)
        ins, outs = j_mock.decode_tx(tx)
        assert p_mock.encode_tx(ins, outs) == tx


# -- the extended ledger over a forged chain ---------------------------------


def _fold(ext, st, blocks, reapply=False):
    """-> ([plain state after each block], plain error at the first
    failing block or None)."""
    out = []
    for b in blocks:
        try:
            st = (ext.tick_then_reapply if reapply else ext.tick_then_apply)(st, b)
        except Exception as e:  # noqa: BLE001 — the fold's error is the result
            return out, carry.error_to_plain(e)
        out.append(carry.ext_state_to_plain(st))
    return out, None


@pytest.mark.parametrize("reapply", [False, True], ids=["apply", "reapply"])
@pytest.mark.parametrize("stake", [False, True], ids=["static", "stake"])
def test_ext_fold_matches_across_epochs(stake, reapply):
    """40 blocks over three 16-slot epochs, a tx a block: every state
    equal (UTxO, stake snapshots, tip, nonces, counters)."""
    txs = _txs(40)
    blocks = forge_chain(40, txs=lambda i: [txs[i]])
    jc, pc = _stake_configs() if stake else (None, None)
    (je, jg), (pe, pg) = j_ext(jc, GENESIS_OUTS), p_ext(config=pc, initial=GENESIS_OUTS)
    ref = _fold(je, jg, blocks, reapply)
    got = _fold(pe, pg, [port_block(b) for b in blocks], reapply)
    assert got == ref
    assert ref[1] is None and len(ref[0]) == 40
    if stake:
        snaps = ref[0][-1]["ledger"]["snapshots"]
        assert [(lo, hi) for lo, hi, _d in snaps] == [(-2, -1), (0, 0), (1, 1)]


def test_stake_views_and_forecasts_match():
    txs = _txs(20)
    blocks = forge_chain(20, txs=lambda i: [txs[i]])
    jc, pc = _stake_configs()
    (je, jg), (pe, pg) = j_ext(jc, GENESIS_OUTS), p_ext(config=pc, initial=GENESIS_OUTS)
    for b in blocks:
        jg, pg = je.tick_then_apply(jg, b), pe.tick_then_apply(pg, port_block(b))

    def lview_plain(lv):
        return sorted((k, (e.stake, e.vrf_key_hash)) for k, e in lv.pool_distr.items())

    for epoch in range(3):
        assert lview_plain(pe.ledger.view_for_epoch(pg.ledger_state, epoch)) == \
            lview_plain(je.ledger.view_for_epoch(jg.ledger_state, epoch))
    jf, pf = je.ledger_view_forecast_at(jg), pe.ledger_view_forecast_at(pg)
    assert (pf.at, pf.max_for) == (jf.at, jf.max_for)
    for slot in range(jf.at + 1, jf.max_for):
        assert lview_plain(pf.forecast_for(slot)) == lview_plain(jf.forecast_for(slot))
    with pytest.raises(JOutside) as je_info:
        jf.forecast_for(jf.max_for)
    with pytest.raises(POutside) as pe_info:
        pf.forecast_for(pf.max_for)
    assert carry.error_to_plain(pe_info.value) == carry.error_to_plain(je_info.value)


def _bad_sig(b):
    from ouroboros_consensus_tpu.block.praos_block import Block, Header

    sig = bytearray(b.header.kes_sig)
    sig[40] ^= 0x01
    return Block(Header(b.header.body, bytes(sig)), b.txs)


def _bad_tx(b):
    from ouroboros_consensus_tpu.block.praos_block import Block

    return Block(b.header, (j_mock.encode_tx([(b"\x05" * 32, 0)], [(ADDR_B, 1)]),))


BAD_BLOCKS = {"kes-signature": _bad_sig, "missing-input": _bad_tx,
              "envelope": lambda b: forge_chain(1, start_slot=b.slot, start_bno=b.block_no + 1,
                                                prev=b.prev_hash)[0]}


@pytest.mark.parametrize("kind", list(BAD_BLOCKS))
def test_ext_apply_errors_match(kind):
    """A bad block in the middle (a flipped KES-signature byte, a tx whose
    input is missing, a block number that skips): the same states before
    it and the same error (the ledger runs before the header checks)."""
    blocks = forge_chain(12)
    blocks[7] = BAD_BLOCKS[kind](blocks[7])
    (je, jg), (pe, pg) = j_ext(), p_ext()
    ref = _fold(je, jg, blocks)
    got = _fold(pe, pg, [port_block(b) for b in blocks])
    assert got == ref
    assert len(ref[0]) == 7 and ref[1] is not None


# -- InspectLedger and the state crossing --------------------------------------


def test_inspect_ledger_matches():
    class Ledger:
        def __init__(self, mod):
            self.mod = mod

        def inspect(self, old, new):
            return [self.mod.HardForkEraTransition(f"{old}->{new}", "a", "b"),
                    self.mod.LedgerWarning("w")]

    for mod, lv in ((j_inspect, LVIEW), (p_inspect, P_LVIEW)):
        assert mod.inspect_ledger(object(), 1, 2) == []
    got = [carry.error_to_plain(e) for e in p_inspect.inspect_ledger(Ledger(p_inspect), 1, 2)]
    ref = [carry.error_to_plain(e) for e in j_inspect.inspect_ledger(Ledger(j_inspect), 1, 2)]
    assert got == ref


def test_ext_states_cross_from_the_reference():
    txs = _txs(20)
    blocks = forge_chain(20, txs=lambda i: [txs[i]])
    jc, _pc = _stake_configs()
    je, jg = j_ext(jc, GENESIS_OUTS)
    for b in blocks:
        jg = je.tick_then_apply(jg, b)
        got = carry.ext_state_from_reference(jg)
        assert carry.ext_state_to_plain(got) == carry.ext_state_to_plain(jg)
    hf = replace(jg, ledger_state=JHFState(2, jg.ledger_state),
                 header_state=replace(jg.header_state,
                                      chain_dep_state=JHFState(2, jg.header_state.chain_dep_state)))
    got = carry.ext_state_from_reference(hf)
    assert type(got.ledger_state).__name__ == "HFState"
    assert carry.ext_state_to_plain(got) == carry.ext_state_to_plain(hf)
