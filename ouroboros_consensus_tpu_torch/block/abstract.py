"""Chain points (Block/Abstract.hs, Block/RealPoint.hs)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Point:
    """A point on the chain: (slot, hash)."""

    slot: int
    hash_: bytes

    def __repr__(self):
        return f"Point({self.slot}, {self.hash_[:6].hex()})"
