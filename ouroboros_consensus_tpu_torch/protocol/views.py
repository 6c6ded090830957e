"""Praos header / ledger views — the exact inputs of header validation.

Reference: Praos/Views.hs:22-51 (`HeaderView`, `LedgerView`) and
cardano-protocol-tpraos `OCert`. The list form only: the packed staging
(protocol/batch.py) columnarizes lists of these views itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache
from typing import Mapping

from ..utils.hashes import blake2b_224, blake2b_256


@lru_cache(maxsize=65536)
def hash_key(vk_cold: bytes) -> bytes:
    """KeyHash (Blake2b-224) of an Ed25519 cold verification key."""
    return blake2b_224(vk_cold)


def hash_vrf_vk(vrf_vk: bytes) -> bytes:
    """Blake2b-256 hash of a VRF verification key (pool registration)."""
    return blake2b_256(vrf_vk)


@dataclass(frozen=True)
class OCert:
    """Operational certificate: cold key delegates to a hot KES key. The
    DSIGN-signable form is vk_hot ‖ counter_be8 ‖ kes_period_be8."""

    vk_hot: bytes  # 32 — KES root verification key
    counter: int  # issue number
    kes_period: int  # start period c0
    sigma: bytes  # 64 — Ed25519 signature by the cold key

    def signable(self) -> bytes:
        return (
            self.vk_hot
            + self.counter.to_bytes(8, "big")
            + self.kes_period.to_bytes(8, "big")
        )


@dataclass(frozen=True)
class HeaderView:
    """Exactly the header fields validation consumes (Praos/Views.hs:22-39)."""

    prev_hash: bytes | None  # None = genesis
    vk_cold: bytes  # 32 — issuer cold key
    vrf_vk: bytes  # 32
    vrf_output: bytes  # 64 — certified VRF output beta
    vrf_proof: bytes  # ECVRF proof pi: 80 (draft-03) or 128 (batch-compat)
    ocert: OCert
    slot: int
    signed_bytes: bytes  # KES-signed representation (header body CBOR)
    kes_sig: bytes  # CompactSum signature (64 + 32 + 32*depth)


@dataclass(frozen=True)
class IndividualPoolStake:
    """Relative stake + registered VRF key hash (SL.IndividualPoolStake)."""

    stake: Fraction
    vrf_key_hash: bytes  # Blake2b-256 of the pool's VRF vk


@dataclass(frozen=True)
class LedgerView:
    """Praos ledger view (Praos/Views.hs:41-51): the pool stake
    distribution plus the envelope size limits."""

    pool_distr: Mapping[bytes, IndividualPoolStake]  # KeyHash -> stake
    max_header_size: int = 1100
    max_body_size: int = 90112
    protocol_version: tuple[int, int] = (9, 0)
