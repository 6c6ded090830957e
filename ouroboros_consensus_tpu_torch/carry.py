"""Carry the reference package's constants and protocol objects across.

This system has no weights: what crosses from the JAX package is its
fixed-base table and its protocol objects. Everything here reads plain
Python and numpy values by attribute (duck typing), so the port never
imports the JAX package; only the tests hand objects of both over.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from .ops.pk import field as fe
from .protocol.praos import PraosParams, PraosState
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


def state_to_plain(st) -> dict | None:
    """A PraosState of either package as a plain dict."""
    if st is None:
        return None
    return {
        "last_slot": st.last_slot,
        "ocert_counters": {bytes(k): int(v) for k, v in st.ocert_counters.items()},
        "evolving_nonce": _nonce(st.evolving_nonce),
        "candidate_nonce": _nonce(st.candidate_nonce),
        "epoch_nonce": _nonce(st.epoch_nonce),
        "lab_nonce": _nonce(st.lab_nonce),
        "last_epoch_block_nonce": _nonce(st.last_epoch_block_nonce),
    }


def error_to_plain(e) -> tuple | None:
    """A validation error of either package as (class name, fields)."""
    if e is None:
        return None
    fields = {f.name: getattr(e, f.name) for f in dataclasses.fields(e)}
    return type(e).__name__, fields
