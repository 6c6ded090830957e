"""Praos nonces and VRF range extension (host control plane).

A `Nonce` is `bytes` (32) or `None` for the neutral nonce:
  * combine: Blake2b-256(a ‖ b); neutral is identity on either side.
  * mk_input_vrf: Blake2b-256(slot_be8 ‖ nonce-bytes); the neutral nonce
    contributes no bytes (Praos/VRF.hs:55-69).
  * leader value: "L"-tagged hash of the certified VRF output
    (Praos/VRF.hs:103); nonce value: "N"-tagged double hash (:116).
"""

from __future__ import annotations

import numpy as np

from ..utils.hashes import blake2b_256

Nonce = bytes | None


def combine(a: Nonce, b: Nonce) -> Nonce:
    """eta ⭒ v. Non-associative hash fold; neutral is identity."""
    if a is None:
        return b
    if b is None:
        return a
    return blake2b_256(a + b)


# the nonce fold's carry as bytes: evolving ‖ set ‖ candidate ‖ set, a
# nonce's 32 bytes zero and its set byte 0 when it is neutral
CARRY_BYTES = 66


def pack_carry(evolving: Nonce, candidate: Nonce) -> np.ndarray:
    """(evolving, candidate) -> the [66] uint8 carry."""
    out = np.zeros(CARRY_BYTES, np.uint8)
    for o, n in ((0, evolving), (33, candidate)):
        if n is not None:
            out[o: o + 32] = np.frombuffer(n, np.uint8)
            out[o + 32] = 1
    return out


def unpack_carry(c: np.ndarray) -> tuple[Nonce, Nonce]:
    """The [66] uint8 carry -> (evolving, candidate)."""
    c = np.asarray(c, np.uint8)
    return tuple(c[o: o + 32].tobytes() if c[o + 32] else None for o in (0, 33))


def prev_hash_to_nonce(prev_hash: bytes | None) -> Nonce:
    return None if prev_hash is None else prev_hash


def mk_input_vrf(slot: int, epoch_nonce: Nonce) -> bytes:
    tail = b"" if epoch_nonce is None else epoch_nonce
    return blake2b_256(slot.to_bytes(8, "big") + tail)


def vrf_leader_value(vrf_output: bytes) -> int:
    """Bounded natural in [0, 2^256) for the leader threshold check."""
    return int.from_bytes(blake2b_256(b"L" + vrf_output), "big")


def vrf_nonce_value(vrf_output: bytes) -> bytes:
    return blake2b_256(blake2b_256(b"N" + vrf_output))
