"""The port's hard-fork history and combinator (ouroboros_consensus_tpu_torch
hardfork/history.py, combinator.py, byron_mock.py) against the JAX
package's: the Summary's conversions over a five-era layout, the
past-horizon refusals, era-tagged block bytes and their decoding, the
Byron mock's forge and views, and the combinator's tick, translations and
chain order."""

from fractions import Fraction

import pytest
import torch

from ouroboros_consensus_tpu.hardfork import byron_mock as JB
from ouroboros_consensus_tpu.hardfork import combinator as JC
from ouroboros_consensus_tpu.hardfork import composite as JX
from ouroboros_consensus_tpu.hardfork import history as JH
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.hardfork import byron_mock as PB
from ouroboros_consensus_tpu_torch.hardfork import combinator as PC
from ouroboros_consensus_tpu_torch.hardfork import composite as PX
from ouroboros_consensus_tpu_torch.hardfork import history as PH

torch.set_num_threads(1)

LAYOUT = ([(30, Fraction(20)), (40, Fraction(1)), (40, Fraction(1)), (80, Fraction(1, 2)),
           (20, Fraction(1))], [1, 3, 4, 5, None])


def _summaries():
    out = []
    for h in (JH, PH):
        params = [h.EraParams(n, sl) for n, sl in LAYOUT[0]]
        out.append(h.summarize(Fraction(0), params, list(LAYOUT[1])))
    return out


def _try(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return type(e).__name__


def test_summary_conversions_match_reference():
    js, ps = _summaries()
    assert len(js.eras) == len(ps.eras) == 5
    for je, pe in zip(js.eras, ps.eras):
        assert (je.start.time, je.start.slot, je.start.epoch) == (
            pe.start.time, pe.start.slot, pe.start.epoch)
        assert (je.end is None) == (pe.end is None)
    for slot in range(0, 400, 3):
        for name in ("era_index_of_slot", "slot_to_wallclock", "slot_to_epoch"):
            assert _try(getattr(js, name), slot) == _try(getattr(ps, name), slot), (name, slot)
    for t in [Fraction(k, 4) for k in range(0, 3000, 7)]:
        assert _try(js.wallclock_to_slot, t) == _try(ps.wallclock_to_slot, t), t
    for ep in range(0, 12):
        for name in ("epoch_to_first_slot", "epoch_size"):
            assert _try(getattr(js, name), ep) == _try(getattr(ps, name), ep), (name, ep)


def test_bounded_summary_refuses_past_its_horizon():
    for h in (JH, PH):
        s = h.summarize(Fraction(0), [h.EraParams(10, Fraction(1))] * 2, [1, 2])
        with pytest.raises(h.PastHorizon):
            s.era_index_of_slot(20)
        with pytest.raises(h.PastHorizon):
            s.wallclock_to_slot(Fraction(25))
    with pytest.raises(ValueError):
        PH.summarize(Fraction(0), [PH.EraParams(10, Fraction(1))] * 2, [2, 1])


def _byron_blocks(mod):
    seed = b"\x21" * 32
    ebb = mod.forge_ebb(slot=0, block_no=0, prev_hash=None)
    blk = mod.forge_block(seed, slot=3, block_no=0, prev_hash=ebb.hash_, txs=(b"t", b"u"))
    return ebb, blk


def test_byron_mock_bytes_and_views_match_reference():
    for jb, pb in zip(_byron_blocks(JB), _byron_blocks(PB)):
        assert jb.bytes_ == pb.bytes_ and jb.hash_ == pb.hash_
        assert PB.ByronMockBlock.from_bytes(jb.bytes_) == pb
        assert pb.check_integrity()
        jv, pv = jb.header.to_view(), pb.header.to_view()
        if jb.header.is_ebb:
            assert repr(jv) == repr(pv) == "PBftValidateBoundary"
        else:
            assert (jv.issuer_vk, jv.signed_bytes, jv.signature) == (
                pv.issuer_vk, pv.signed_bytes, pv.signature)


def test_era_tagged_blocks_round_trip():
    ebb, blk = _byron_blocks(PB)
    for era, inner in ((0, ebb), (0, blk)):
        hfb = PC.HardForkBlock(era, inner)
        jhfb = JC.HardForkBlock(era, JB.ByronMockBlock.from_bytes(inner.bytes_))
        assert hfb.bytes_ == jhfb.bytes_
        out = PC.decode_block(jhfb.bytes_, [PB.ByronMockBlock.from_bytes])
        assert out == hfb and out.era == era and out.block == inner
        assert (out.slot, out.block_no, out.hash_, out.prev_hash) == (
            jhfb.slot, jhfb.block_no, jhfb.hash_, jhfb.prev_hash)
        assert PC.unwrap(out) is out.block and PC.unwrap(inner) is inner


def test_decode_block_over_a_composite_chain(tmp_path):
    """Every block of a forged 3-era chain decodes to the same header
    bytes through both packages' decoders."""
    from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB

    cfg = PX.CardanoMockConfig(byron_epochs=1, byron_epoch_length=8, shelley_epochs=1,
                               epoch_length=8, k=3)
    PX.synthesize(str(tmp_path / "db"), cfg, 22)
    pm = PX.CardanoMock(cfg, device="cpu")
    jm = JX.CardanoMock(JX.CardanoMockConfig(byron_epochs=1, byron_epoch_length=8,
                                             shelley_epochs=1, epoch_length=8, k=3))
    raws = [raw for _e, raw in ImmutableDB(str(tmp_path / "db" / "immutable")).stream_all()]
    eras = []
    for raw in raws:
        p = PC.decode_block(raw, pm.decoders)
        j = JC.decode_block(raw, jm.decoders)
        assert p.era == j.era and p.bytes_ == j.bytes_ == raw
        assert p.header.bytes_ == j.header.bytes_
        eras.append(p.era)
    assert sorted(set(eras)) == [0, 1, 2]


def test_combinator_walks_the_telescope_as_reference():
    """tick across both boundaries, the translations and the chain order,
    through the two composites' combinators."""
    cfg = dict(byron_epochs=1, byron_epoch_length=10, shelley_epochs=1, epoch_length=10, k=3)
    pm = PX.CardanoMock(PX.CardanoMockConfig(**cfg), device="cpu")
    jm = JX.CardanoMock(JX.CardanoMockConfig(**cfg))
    ps, js = pm.hf.initial_state(), jm.hf.initial_state()
    for slot in (0, 5, 10, 15, 20, 25):
        pt = pm.hf.tick(pm.view_for_era(pm.hf.era_of_slot(slot)), slot, ps)
        jt = jm.hf.tick(jm.view_for_era(jm.hf.era_of_slot(slot)), slot, js)
        assert pt.era == jt.era
        assert carry.state_to_plain(pt.state) == carry.state_to_plain(jt.state)
        ps, js = PC.HFState(pt.era, pt.state), JC.HFState(jt.era, jt.state)
    assert carry.state_to_plain(pm.hf.cross_eras(PC.HFState(0, pm.pbft.initial_state()), 2)) \
        == carry.state_to_plain(jm.hf._cross_eras(JC.HFState(0, jm.pbft.initial_state()), 2))
    with pytest.raises(ValueError):
        pm.hf.tick(None, 0, ps)  # a slot in a past era
    from ouroboros_consensus_tpu.protocol import select as JS
    from ouroboros_consensus_tpu_torch.protocol import select as PS

    def views(sel):
        sv = [sel.PraosSelectView(3, 30, b"a", 0, 9), sel.PraosSelectView(3, 31, b"a", 1, 9),
              sel.PraosSelectView(3, 32, b"b", 0, 5), sel.PraosSelectView(4, 33, b"b", 0, 7)]
        return [None, (0, 3), (0, 4)] + [(1, v) for v in sv] + [(2, sv[0]), (2, sv[3])]

    pv, jv = views(PS), views(JS)
    for i in range(len(pv)):
        for k in range(len(pv)):
            assert pm.hf.compare_candidates(pv[i], pv[k]) == \
                jm.hf.compare_candidates(jv[i], jv[k]), (i, k)
    assert pm.hf.security_param == jm.hf.security_param
    assert carry.hfstate_from_reference(js) == ps
