"""CompactSum KES on the host (cardano-crypto-class `KES.CompactSum`):
key derivation and signing, as the forger uses them.

Seeds split top down (left = Blake2b-256(0x01 ‖ seed), right =
Blake2b-256(0x02 ‖ seed)), a node's vk is Blake2b-256(vk_left ‖
vk_right), and a signature is the leaf Ed25519 signature ‖ leaf vk ‖ one
sibling vk per level, bottom-up. Everything but the leaf signature
depends only on (seed, depth, period): `leaf_path` derives it once, so a
forger signs a block with one native Ed25519 signature and a copy.
Reference: ouroboros_consensus_tpu/ops/host/kes.py:115 (`leaf_path`).
"""

from __future__ import annotations

from functools import lru_cache

from .. import native
from ..utils.hashes import blake2b_256


def seed_left(seed: bytes) -> bytes:
    return blake2b_256(b"\x01" + seed)


def seed_right(seed: bytes) -> bytes:
    return blake2b_256(b"\x02" + seed)


@lru_cache(maxsize=1 << 14)
def derive_vk(seed: bytes, depth: int) -> bytes:
    """Verification key of the KES subtree rooted at `seed`."""
    if depth == 0:
        return native.ed25519_public(seed)
    return blake2b_256(derive_vk(seed_left(seed), depth - 1)
                       + derive_vk(seed_right(seed), depth - 1))


@lru_cache(maxsize=1 << 12)
def leaf_path(seed: bytes, depth: int, period: int) -> tuple[bytes, bytes]:
    """(leaf seed, leaf vk ‖ sibling vks bottom-up) of `period`: the
    message-independent part of a CompactSum signature, derived once per
    (seed, depth, period) by one walk down the tree (each sibling's vk
    from derive_vk's cache)."""
    if not 0 <= period < (1 << depth):
        raise ValueError(f"period {period} out of range for depth {depth}")
    sibs = []
    sd, per = seed, period
    for d in range(depth, 0, -1):
        half = 1 << (d - 1)
        left, right = seed_left(sd), seed_right(sd)
        if per < half:
            sibs.append(derive_vk(right, d - 1))
            sd = left
        else:
            sibs.append(derive_vk(left, d - 1))
            sd, per = right, per - half
    return sd, native.ed25519_public(sd) + b"".join(reversed(sibs))


def sign(seed: bytes, depth: int, period: int, msg: bytes) -> bytes:
    """CompactSum signature of `msg` for `period` (0 <= period < 2^depth):
    the leaf's native Ed25519 signature and the cached path."""
    leaf, tail = leaf_path(seed, depth, period)
    return native.ed25519_sign(leaf, msg) + tail
