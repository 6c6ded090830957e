"""Host Blake2b helpers (hashlib) used by the protocol and block codecs."""

from __future__ import annotations

import hashlib


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def blake2b_224(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=28).digest()
