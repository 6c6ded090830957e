"""Carry the reference package's constants and protocol objects across.

This system has no weights: what crosses from the JAX package is its
fixed-base table, its protocol objects (Praos, TPraos and PBFT
parameters, views and states, the hard-fork state, the composite's
config) and its ledger and header states (the mock ledger's UTxO state,
the header state, the extended state a LedgerDB checkpoints). Everything
here reads plain Python and numpy values by attribute (duck typing), so
the port never imports the JAX package; only the tests hand objects of
both over.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from .ops.pk import field as fe
from .protocol.instances import PBftParams, PBftState
from .protocol.praos import PraosParams, PraosState
from .protocol.tpraos import GenDeleg, TPraosLedgerView, TPraosParams, TPraosState
from .protocol.views import IndividualPoolStake, LedgerView

_REF_BITS = 13
_REF_LIMBS = 20


def base8_from_reference(base8_np) -> torch.Tensor:
    """The reference's fixed-base table — float32 [32, 160, 256]: per
    window, rows 0..79 the high and 80..159 the low halves (hi·64 + lo)
    of the (x, y, z, t) 13-bit limb rows of d·2^(8w)·B, columns d — ->
    the port's [32, 256, 40] int64 table in radix 2^25.5."""
    a = np.asarray(base8_np).astype(np.int64)
    limbs = a[:, :80] * 64 + a[:, 80:]  # [32, 80, 256] 13-bit limbs
    w, _, n = limbs.shape
    weights = [1 << (_REF_BITS * k) for k in range(_REF_LIMBS)]
    out = np.zeros((w, n, 40), np.int64)
    for wi in range(w):
        for d in range(n):
            row = []
            for c in range(4):
                col = limbs[wi, 20 * c: 20 * (c + 1), d].tolist()
                row += fe.int_to_limbs(sum(v * s for v, s in zip(col, weights)))
            out[wi, d] = row
    return torch.from_numpy(out)


def params_from_reference(p) -> PraosParams:
    return PraosParams(
        slots_per_kes_period=int(p.slots_per_kes_period),
        max_kes_evolutions=int(p.max_kes_evolutions),
        security_param=int(p.security_param),
        active_slot_coeff=Fraction(p.active_slot_coeff),
        epoch_length=int(p.epoch_length),
        kes_depth=int(p.kes_depth),
    )


def lview_from_reference(lv) -> LedgerView:
    return LedgerView(
        pool_distr={
            bytes(k): IndividualPoolStake(Fraction(e.stake), bytes(e.vrf_key_hash))
            for k, e in lv.pool_distr.items()
        },
        max_header_size=int(lv.max_header_size),
        max_body_size=int(lv.max_body_size),
        protocol_version=tuple(lv.protocol_version),
    )


def _nonce(n):
    return None if n is None else bytes(n)


def state_from_reference(st) -> PraosState:
    return PraosState(
        last_slot=None if st.last_slot is None else int(st.last_slot),
        ocert_counters={bytes(k): int(v) for k, v in st.ocert_counters.items()},
        evolving_nonce=_nonce(st.evolving_nonce),
        candidate_nonce=_nonce(st.candidate_nonce),
        epoch_nonce=_nonce(st.epoch_nonce),
        lab_nonce=_nonce(st.lab_nonce),
        last_epoch_block_nonce=_nonce(st.last_epoch_block_nonce),
    )


def tparams_from_reference(p) -> TPraosParams:
    return TPraosParams(praos=params_from_reference(p.praos),
                        decentralization=Fraction(p.decentralization))


def tlview_from_reference(lv) -> TPraosLedgerView:
    base = lview_from_reference(lv)
    return TPraosLedgerView(
        pool_distr=base.pool_distr, max_header_size=base.max_header_size,
        max_body_size=base.max_body_size, protocol_version=base.protocol_version,
        gen_delegs=[GenDeleg(bytes(d.vk_cold), bytes(d.vrf_key_hash)) for d in lv.gen_delegs])


def tstate_from_reference(st) -> TPraosState:
    return TPraosState(**vars(state_from_reference(st)))


def pbft_params_from_reference(p) -> PBftParams:
    return PBftParams(num_genesis_keys=int(p.num_genesis_keys), threshold=Fraction(p.threshold),
                      window=int(p.window), security_param=int(p.security_param))


def pbft_state_from_reference(st) -> PBftState:
    return PBftState(tuple((int(s), int(g)) for s, g in st.signers))


def _inner_from_reference(st):
    """A reference era state by its class: PBftState, TPraosState, else a
    PraosState."""
    name = type(st).__name__
    if name == "PBftState":
        return pbft_state_from_reference(st)
    if name == "TPraosState":
        return tstate_from_reference(st)
    return state_from_reference(st)


def hfstate_from_reference(st):
    from .hardfork.combinator import HFState

    return HFState(int(st.era), _inner_from_reference(st.inner))


def mock_state_from_reference(st):
    """The reference's MockState (UTxO, tip slot, stake snapshots)."""
    from .ledger.mock import MockState

    return MockState(
        {(bytes(t), int(ix)): (bytes(a), int(amt)) for (t, ix), (a, amt) in st.utxo.items()},
        None if st.tip_slot_ is None else int(st.tip_slot_),
        tuple((int(lo), int(hi), tuple((bytes(p), int(n), int(d)) for p, n, d in distr))
              for lo, hi, distr in st.snapshots),
    )


def _chain_dep_from_reference(st):
    if hasattr(st, "era") and hasattr(st, "inner"):
        return hfstate_from_reference(st)
    return _inner_from_reference(st)


def header_state_from_reference(hs):
    """The reference's HeaderState: its AnnTip and its chain-dep state
    (Praos, TPraos, PBFT or hard-fork)."""
    from .ledger.header_validation import AnnTip, HeaderState

    t = hs.tip
    tip = None if t is None else AnnTip(int(t.slot), int(t.block_no), bytes(t.hash_))
    return HeaderState(tip, _chain_dep_from_reference(hs.chain_dep_state))


def ext_state_from_reference(st):
    """The reference's ExtLedgerState over its mock ledger (or a
    hard-fork state wrapping one)."""
    from .hardfork.combinator import HFState
    from .ledger.extended import ExtLedgerState

    ls = st.ledger_state
    if hasattr(ls, "era") and hasattr(ls, "inner"):
        ls = HFState(int(ls.era), mock_state_from_reference(ls.inner))
    else:
        ls = mock_state_from_reference(ls)
    return ExtLedgerState(ls, header_state_from_reference(st.header_state))


def cardano_config_from_reference(cfg):
    """The reference's CardanoMockConfig as the port's, field by field."""
    from .hardfork.composite import CardanoMockConfig

    return CardanoMockConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(CardanoMockConfig)})


def state_to_plain(st) -> dict | None:
    """A protocol state of either package as a plain dict: a Praos or
    TPraos state (its fields, the nonces as bytes), a PBFT state (its
    signing window), a BFT or leader-schedule state (its last slot), or
    a hard-fork state (its era and its era's state)."""
    if st is None:
        return None
    if hasattr(st, "era") and hasattr(st, "inner"):
        return {"era": int(st.era), "inner": state_to_plain(st.inner)}
    if hasattr(st, "signers"):
        return {"signers": [(int(s), int(g)) for s, g in st.signers]}
    if not hasattr(st, "ocert_counters"):
        return {"last_slot": st.last_slot}
    return {
        "last_slot": st.last_slot,
        "ocert_counters": {bytes(k): int(v) for k, v in st.ocert_counters.items()},
        "evolving_nonce": _nonce(st.evolving_nonce),
        "candidate_nonce": _nonce(st.candidate_nonce),
        "epoch_nonce": _nonce(st.epoch_nonce),
        "lab_nonce": _nonce(st.lab_nonce),
        "last_epoch_block_nonce": _nonce(st.last_epoch_block_nonce),
    }


def ledger_state_to_plain(ls) -> dict:
    """A mock ledger state of either package (or a hard-fork state over
    one) as a plain dict."""
    if hasattr(ls, "era") and hasattr(ls, "inner"):
        return {"era": int(ls.era), "inner": ledger_state_to_plain(ls.inner)}
    return {
        "utxo": sorted(((bytes(t), int(ix)), (bytes(a), int(amt)))
                       for (t, ix), (a, amt) in ls.utxo.items()),
        "tip_slot": ls.tip_slot_,
        "snapshots": [(int(lo), int(hi), [(bytes(p), int(n), int(d)) for p, n, d in distr])
                      for lo, hi, distr in ls.snapshots],
    }


def ext_state_to_plain(st) -> dict:
    """An extended ledger state of either package as a plain dict: the
    ledger state, the header state's tip and its chain-dep state (with
    the state's class name, which both packages share)."""
    t = st.header_state.tip
    cds = st.header_state.chain_dep_state
    return {
        "ledger": ledger_state_to_plain(st.ledger_state),
        "tip": None if t is None else (int(t.slot), int(t.block_no), bytes(t.hash_)),
        "chain_dep": (type(cds).__name__, state_to_plain(cds)),
    }


def error_to_plain(e) -> tuple | None:
    """A validation error of either package as (class name, fields): the
    Praos, TPraos (WrongGenesisDelegate, NonActiveSlot, WrongGenesisVRFKey),
    PBFT, BFT and leader-schedule errors are dataclasses; any other
    exception gives its args."""
    if e is None:
        return None
    if not dataclasses.is_dataclass(e):
        return type(e).__name__, {"args": tuple(e.args)}
    fields = {f.name: getattr(e, f.name) for f in dataclasses.fields(e)}
    return type(e).__name__, fields
