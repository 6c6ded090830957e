"""Shared fixture code of the port's ledger-core and storage tests: a
small Praos configuration, chains forged by the JAX package's
`block.forge_block` (the epoch nonce followed across epoch boundaries),
the same extended ledger (mock UTxO ledger + Praos) built in both
packages, and plain views of a ChainDB for exact comparisons.

The JAX side validates through its sequential host fold with the C++
verifier (`use_device_batch=False`); the port through its C++ verifier a
header (`use_device_batch=False`) or its batched push on the plain twins
(`use_device_batch=True, device="cpu"`)."""

from __future__ import annotations

from dataclasses import replace
from fractions import Fraction

import torch

from ouroboros_consensus_tpu.block import forge_block as j_forge_block
from ouroboros_consensus_tpu.ledger import ExtLedger as JExtLedger
from ouroboros_consensus_tpu.ledger import mock as j_mock
from ouroboros_consensus_tpu.protocol import praos as j_praos
from ouroboros_consensus_tpu.protocol.instances import PraosProtocol as JPraosProtocol
from ouroboros_consensus_tpu.testing import fixtures
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.block.praos_block import Block as PBlock
from ouroboros_consensus_tpu_torch.ledger import ExtLedger as PExtLedger
from ouroboros_consensus_tpu_torch.ledger import mock as p_mock
from ouroboros_consensus_tpu_torch.protocol.instances import PraosProtocol as PPraosProtocol

torch.set_num_threads(1)

K = 3
# f = 1: every pool leads every slot; 16-slot epochs (the stability
# window 3k/f = 9 slots, so the candidate nonce freezes mid-epoch)
PARAMS = j_praos.PraosParams(
    slots_per_kes_period=100, max_kes_evolutions=62, security_param=K,
    active_slot_coeff=Fraction(1), epoch_length=16, kes_depth=3,
)
P_PARAMS = carry.params_from_reference(PARAMS)
POOLS = [fixtures.make_pool(i, kes_depth=PARAMS.kes_depth) for i in range(2)]
LVIEW = fixtures.make_ledger_view(POOLS)
P_LVIEW = carry.lview_from_reference(LVIEW)
ETA0 = b"\x22" * 32
CRYPTO = j_praos.native_verifier_or_host()


def _draft03_leader(pool, slot, epoch_nonce):
    """The certified VRF output with a draft-03 (80-byte) proof."""
    from ouroboros_consensus_tpu import native_loader
    from ouroboros_consensus_tpu.ops.host import fast
    from ouroboros_consensus_tpu.protocol import nonces

    proof = native_loader.native_ecvrf_prove(pool.vrf_seed, nonces.mk_input_vrf(slot, epoch_nonce))
    return j_praos.PraosIsLeader(fast.ecvrf_proof_to_hash(proof), proof)


def forge_chain(n, start_slot=1, start_bno=0, prev=None, pool_ix=0, slot_step=1,
                state=None, txs=None, draft03=lambda i: False):
    """n JAX blocks, each forged under the epoch nonce its slot's tick
    gives (`state`: the chain-dep state before the first; None: the
    genesis state with ETA0). `txs(i)` -> block i's txs; `draft03(i)`:
    block i carries a draft-03 proof (else a batch-compatible one)."""
    st = state if state is not None else replace(j_praos.PraosState(), epoch_nonce=ETA0)
    blocks = []
    for i in range(n):
        slot = start_slot + i * slot_step
        ticked = j_praos.tick(PARAMS, LVIEW, slot, st)
        pool = POOLS[(pool_ix + i) % len(POOLS)]
        eta = ticked.state.epoch_nonce
        b = j_forge_block(PARAMS, pool, slot=slot, block_no=start_bno + i, prev_hash=prev,
                          epoch_nonce=eta, txs=tuple(txs(i)) if txs is not None else (),
                          is_leader=_draft03_leader(pool, slot, eta) if draft03(i) else None)
        st = j_praos.reupdate(PARAMS, b.header.to_view(), slot, ticked)
        blocks.append(b)
        prev = b.hash_
    return blocks


def state_after(blocks):
    """The JAX chain-dep state after `blocks` (a chain from genesis)."""
    st = replace(j_praos.PraosState(), epoch_nonce=ETA0)
    for b in blocks:
        st = j_praos.reupdate(PARAMS, b.header.to_view(), b.slot,
                              j_praos.tick(PARAMS, LVIEW, b.slot, st))
    return st


def forge_after(base, n, start_slot, **kw):
    """n JAX blocks extending the chain `base` (genesis when empty) from
    `start_slot`, under the epoch nonces that chain leads to."""
    if not base:
        return forge_chain(n, start_slot=start_slot, **kw)
    return forge_chain(n, start_slot=start_slot, start_bno=base[-1].block_no + 1,
                       prev=base[-1].hash_, state=state_after(base), **kw)


def port_block(b) -> PBlock:
    return PBlock.from_bytes(b.bytes_)


def with_eta0(st):
    hs = st.header_state
    return replace(st, header_state=replace(
        hs, chain_dep_state=replace(hs.chain_dep_state, epoch_nonce=ETA0)))


def j_ext(config=None, initial=()):
    """(JAX ExtLedger, its genesis state): the host fold, the C++ verifier."""
    ledger = j_mock.MockLedger(config or j_mock.MockConfig(LVIEW, PARAMS.stability_window))
    ext = JExtLedger(ledger, JPraosProtocol(PARAMS, crypto=CRYPTO, use_device_batch=False))
    return ext, with_eta0(ext.genesis(ledger.genesis_state(list(initial))))


def p_ext(use_device_batch=False, config=None, initial=()):
    """(the port's ExtLedger, its genesis state): the batched push on the
    plain twins (`use_device_batch`) or the C++ verifier a header."""
    ledger = p_mock.MockLedger(config or p_mock.MockConfig(P_LVIEW, P_PARAMS.stability_window))
    ext = PExtLedger(ledger, PPraosProtocol(P_PARAMS, device="cpu",
                                            use_device_batch=use_device_batch))
    return ext, with_eta0(ext.genesis(ledger.genesis_state(list(initial))))


def states_plain(ledgerdb) -> list:
    """Every checkpoint of a LedgerDB of either package as plain values."""
    return [(None if p is None else (p.slot, p.hash_), carry.ext_state_to_plain(s))
            for p, s in ledgerdb._seq]


def chaindb_plain(db) -> dict:
    """A ChainDB of either package as plain values: tip, the whole chain's
    hashes, the volatile fragment, the immutable tip, the invalid map,
    every LedgerDB state and the header history's tips."""
    tip = db.tip_point()
    imm = db.immutable.tip_point()
    return {
        "tip": None if tip is None else (tip.slot, tip.hash_),
        "chain": [b.hash_ for b in db.stream_all()],
        "current": [b.hash_ for b in db.current_chain],
        "immutable_tip": None if imm is None else (imm.slot, imm.hash_),
        "invalid": {h: carry.error_to_plain(e) for h, e in db.invalid.items()},
        "states": states_plain(db.ledgerdb),
        "history": [None if hs.tip is None else (hs.tip.slot, hs.tip.hash_)
                    for hs in db.header_history.states],
    }


def event_plain(ev):
    """A typed trace event of either package as (class name, fields); a
    ValidatedBatch's seconds are left out."""
    import dataclasses

    fields = {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)
              if f.name != "device_s"}
    return type(ev).__name__, fields
