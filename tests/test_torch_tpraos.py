"""The port's TPraos (ouroboros_consensus_tpu_torch protocol/tpraos.py)
against the JAX package's: the overlay schedule over two epochs, the
overlay-aware host prechecks, a chain's replay (device on the CPU, i.e.
the plain twins, and native) against the JAX host fold on a clean chain,
a header by the wrong genesis delegate and one in an inactive overlay
slot, the TPraos→Praos translation, and the one divergence kept on
purpose: a failed device batch raises in the port where the reference
falls back to its host fold (ROADMAP §C)."""

import dataclasses
from fractions import Fraction

import pytest
import torch

from ouroboros_consensus_tpu.block.praos_block import Block as JBlock
from ouroboros_consensus_tpu.protocol import batch as jbatch
from ouroboros_consensus_tpu.protocol import tpraos as JT
from ouroboros_consensus_tpu.protocol.views import hash_vrf_vk as j_hash_vrf_vk
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.block import forge as pforge
from ouroboros_consensus_tpu_torch.protocol import praos as PP
from ouroboros_consensus_tpu_torch.protocol import tpraos as PT
from ouroboros_consensus_tpu_torch.protocol.instances import PraosCanBeLeader
from ouroboros_consensus_tpu_torch.testing import chaos, synth

torch.set_num_threads(1)

DEPTH = 3
EPOCH = 40
ETA0 = b"\x0b" * 32
PRAOS = PP.PraosParams(slots_per_kes_period=100, max_kes_evolutions=62, security_param=5,
                       active_slot_coeff=Fraction(1, 2), epoch_length=EPOCH, kes_depth=DEPTH)
PARAMS = PT.TPraosParams(PRAOS, Fraction(1, 2))
DELEGS = [synth.make_pool(100 + i, kes_depth=DEPTH) for i in range(2)]
POOL = synth.make_pool(0, kes_depth=DEPTH)
LVIEW = PT.TPraosLedgerView(
    pool_distr=synth.make_ledger_view([POOL]).pool_distr,
    gen_delegs=[PT.GenDeleg(d.vk_cold, PT.hash_vrf_vk(d.vrf_vk)) for d in DELEGS])


def _jparams():
    return JT.TPraosParams(carry_back(PRAOS), PARAMS.decentralization)


def carry_back(p):
    from ouroboros_consensus_tpu.protocol import praos as JP

    return JP.PraosParams(**dataclasses.asdict(p))


def _jlview():
    from ouroboros_consensus_tpu.protocol.views import IndividualPoolStake

    return JT.TPraosLedgerView(
        pool_distr={k: IndividualPoolStake(e.stake, e.vrf_key_hash)
                    for k, e in LVIEW.pool_distr.items()},
        gen_delegs=[JT.GenDeleg(d.vk_cold, j_hash_vrf_vk(d.vrf_vk)) for d in DELEGS])


def _forge(slot, creds, block_no, prev, eta0):
    return pforge.forge_block(PRAOS, creds, slot=slot, block_no=block_no, prev_hash=prev,
                              epoch_nonce=eta0, txs=(b"tx-%d" % slot,))


@pytest.fixture(scope="module")
def chain():
    """Two epochs of a TPraos chain from slot 1: the scheduled delegate in
    each active overlay slot, the pool where it wins a non-overlay slot;
    plus, per slot, the epoch nonce it was forged under. -> (blocks,
    {slot: eta0}, the first inactive overlay slot, an active one of
    delegate 0's)."""
    st = PT.TPraosState(epoch_nonce=ETA0)
    blocks, etas, prev = [], {}, None
    inactive = active0 = None
    for slot in range(1, 2 * EPOCH):
        ticked = PT.tick(PARAMS, LVIEW, slot, st)
        eta0 = ticked.state.epoch_nonce
        a = PT.overlay_slot_assignment(PARAMS, len(DELEGS), slot)
        if a is not None:
            active, j = a
            if not active:
                inactive = inactive or slot
                continue
            if j == 0 and slot < EPOCH:
                active0 = active0 or slot
            creds = DELEGS[j]
        else:
            can = PraosCanBeLeader(None, POOL.vk_cold, POOL.vrf_seed)
            if PT.check_is_leader(PARAMS, can, slot, ticked) is None:
                continue
            creds = POOL
        blk = _forge(slot, creds, len(blocks), prev, eta0)
        etas[slot] = eta0
        blocks.append(blk)
        st = PT.reupdate(PARAMS, blk.header.to_view(), slot, ticked)
        prev = blk.hash_
    return blocks, etas, inactive, active0


def _replay_port(blocks, backend):
    proto = PT.TPraosProtocol(PARAMS, device="cpu")
    hvs = [b.header.to_view() for b in blocks]
    st, total = PT.TPraosState(epoch_nonce=ETA0), 0
    for ep in (0, 1):
        seg = [hv for hv in hvs if hv.slot // EPOCH == ep]
        if not seg:
            continue
        res = proto.validate_batch(proto.tick(LVIEW, seg[0].slot, st), seg, backend=backend)
        st, total = res.state, total + res.n_valid
        if res.error is not None:
            return carry.state_to_plain(st), total, carry.error_to_plain(res.error)
    return carry.state_to_plain(st), total, None


def _replay_jax(blocks):
    proto = JT.TPraosProtocol(_jparams(), use_device_batch=False)
    hvs = [JBlock.from_bytes(b.bytes_).header.to_view() for b in blocks]
    lview = _jlview()
    st, total = JT.TPraosState(epoch_nonce=ETA0), 0
    for ep in (0, 1):
        seg = [hv for hv in hvs if hv.slot // EPOCH == ep]
        if not seg:
            continue
        res = proto.validate_batch(proto.tick(lview, seg[0].slot, st), seg,
                                   backend="host-fold")
        st, total = res.state, total + res.n_valid
        if res.error is not None:
            return carry.state_to_plain(st), total, carry.error_to_plain(res.error)
    return carry.state_to_plain(st), total, None


def test_overlay_schedule_matches_reference():
    for f in (Fraction(1), Fraction(1, 2), Fraction(1, 3)):
        for d in (Fraction(0), Fraction(1, 2), Fraction(3, 10), Fraction(1)):
            ours = PT.TPraosParams(dataclasses.replace(PRAOS, active_slot_coeff=f), d)
            ref = JT.TPraosParams(carry_back(ours.praos), d)
            for slot in range(2 * EPOCH):
                assert PT.overlay_position(ours, slot) == JT.overlay_position(ref, slot)
                for n in (0, 2, 7):
                    assert (PT.overlay_slot_assignment(ours, n, slot)
                            == JT.overlay_slot_assignment(ref, n, slot))


def test_host_prechecks_match_reference(chain):
    blocks, _etas, inactive, active0 = chain
    wrong_deleg = _forge(active0, DELEGS[1], 0, None, ETA0)  # delegate 1 in delegate 0's slot
    stray = _forge(inactive, POOL, 0, None, ETA0)
    picked = blocks[:20] + [wrong_deleg, stray, blocks[0]]
    ours = [b.header.to_view() for b in picked]
    refs = [JBlock.from_bytes(b.bytes_).header.to_view() for b in picked]
    # the last view's OCert starts after its slot's KES period
    for views in (ours, refs):
        views[-1] = dataclasses.replace(
            views[-1], ocert=dataclasses.replace(views[-1].ocert, kes_period=5))
    a = PT.host_prechecks(PARAMS, LVIEW, ours)
    b = JT.host_prechecks(_jparams(), _jlview(), refs)
    assert [carry.error_to_plain(e) for e in a.vrf_lookup_errors] == \
        [carry.error_to_plain(e) for e in b.vrf_lookup_errors]
    assert [carry.error_to_plain(e) for e in a.kes_window_errors] == \
        [carry.error_to_plain(e) for e in b.kes_window_errors]
    assert a.kes_evolution.tolist() == list(b.kes_evolution)
    names = [carry.error_to_plain(e) and carry.error_to_plain(e)[0] for e in a.vrf_lookup_errors]
    assert names[-3:-1] == ["WrongGenesisDelegate", "NonActiveSlot"]
    assert carry.error_to_plain(a.kes_window_errors[-1])[0] == "KESBeforeStartOCERT"


def test_clean_chain_replays_as_reference(chain):
    blocks = chain[0]
    want = _replay_jax(blocks)
    assert want[2] is None and want[1] == len(blocks)
    assert _replay_port(blocks, "native") == want
    assert _replay_port(blocks, "device") == want


@pytest.mark.parametrize("kind", ["wrong-delegate", "inactive-slot"])
def test_rejected_header_replays_as_reference(chain, kind):
    blocks, etas, inactive, active0 = chain
    if kind == "wrong-delegate":
        k = next(i for i, b in enumerate(blocks) if b.slot == active0)
        bad = _forge(active0, DELEGS[1], k, blocks[k - 1].hash_ if k else None, etas[active0])
        tampered = blocks[:k] + [bad] + blocks[k + 1:]
    else:
        k = next(i for i, b in enumerate(blocks) if b.slot > inactive)
        bad = _forge(inactive, POOL, k, blocks[k - 1].hash_ if k else None, etas[blocks[k].slot])
        tampered = blocks[:k] + [bad] + blocks[k:]
    want = _replay_jax(tampered)
    assert want[1] == k
    assert want[2][0] == {"wrong-delegate": "WrongGenesisDelegate",
                          "inactive-slot": "NonActiveSlot"}[kind]
    assert _replay_port(tampered, "native") == want
    assert _replay_port(tampered, "device") == want


def test_translate_state_matches_reference(chain):
    blocks = chain[0]
    st = PT.TPraosState(epoch_nonce=ETA0)
    for b in blocks[:10]:
        st = PT.reupdate(PARAMS, b.header.to_view(), b.slot, PT.tick(PARAMS, LVIEW, b.slot, st))
    ref = JT.TPraosState(**{k: v for k, v in vars(st).items()})
    ours = PT.translate_state(st)
    assert type(ours) is PP.PraosState
    assert carry.state_to_plain(ours) == carry.state_to_plain(JT.translate_state(ref))
    assert carry.state_to_plain(carry.tstate_from_reference(ref)) == carry.state_to_plain(st)


def test_sharded_route_waits_for_multi_card():
    proto = PT.TPraosProtocol(PARAMS, device="cpu")
    with pytest.raises(ValueError, match="A.9"):
        proto.validate_batch(None, [object()], backend="sharded")


def test_failed_device_batch_raises_where_reference_falls_back(chain, monkeypatch):
    """ROADMAP §C: the reference's recover_fold drops a failed device batch
    to its host fold; the port raises the fault (here a device error
    injected at the ed stage's launch)."""
    blocks = chain[0][:6]
    proto = PT.TPraosProtocol(PARAMS, device="cpu")
    hvs = [b.header.to_view() for b in blocks]
    with chaos.arming("device-error@stage:ed"):
        with pytest.raises(chaos.DeviceChaosError):
            proto.validate_batch(proto.tick(LVIEW, hvs[0].slot, PT.TPraosState(
                epoch_nonce=ETA0)), hvs, backend="device")
    jproto = JT.TPraosProtocol(_jparams())

    def lost(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(jproto, "_device_batch", lost)
    jhvs = [JBlock.from_bytes(b.bytes_).header.to_view() for b in blocks]
    res = jproto.validate_batch(jproto.tick(_jlview(), jhvs[0].slot, JT.TPraosState(
        epoch_nonce=ETA0)), jhvs, backend="device")
    assert isinstance(res, jbatch.BatchResult) and res.n_valid == len(blocks)


def test_dispatch_seam_faults_a_tpraos_window(chain):
    """A TPraos batch goes through batch.dispatch_prepared, so the window
    dispatch seam faults it as it faults a Praos window."""
    blocks = chain[0][:6]
    proto = PT.TPraosProtocol(PARAMS, device="cpu")
    hvs = [b.header.to_view() for b in blocks]
    with chaos.arming("device-error@dispatch:0"):
        with pytest.raises(chaos.DeviceChaosError):
            proto.validate_batch(proto.tick(LVIEW, hvs[0].slot, PT.TPraosState(
                epoch_nonce=ETA0)), hvs, backend="device")


def test_reference_objects_carry_across():
    assert carry.tparams_from_reference(_jparams()) == PARAMS
    assert carry.tlview_from_reference(_jlview()) == LVIEW
