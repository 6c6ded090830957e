"""Byron-analog era: PBFT over Ed25519-signed mock blocks; the port's copy
of the reference's hardfork/byron_mock.py (the same bytes).

Reference shape: `ouroboros-consensus-cardano/src/byron/.../Byron/Ledger/
Block.hs` (delegate-signed headers) under `Protocol/PBFT.hs` (signing
window) — with the Byron ledger's tx machinery replaced by opaque tx
bytes, the same strategy the reference's own mock-block library uses for
ThreadNet (src/mock-block/). This is the first era of the mixed-era
composite (hardfork/composite.py), giving BASELINE config 5 its
Byron→Shelley→Babbage shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Sequence

from .. import native
from ..block.abstract import Point
from ..protocol.instances import PBFT_BOUNDARY_VIEW as BOUNDARY_VIEW
from ..protocol.instances import PBftView
from ..utils import cbor
from ..utils.hashes import blake2b_256 as _b2b


@dataclass(frozen=True)
class ByronMockHeader:
    """Header: delegate-signed (cold Ed25519) over the body fields.

    `is_ebb` marks an EPOCH BOUNDARY BLOCK (Block/EBB.hs, Byron/EBBs.hs):
    unsigned, empty, sharing its epoch's first slot and its PREDECESSOR's
    block number — validation treats it as PBftValidateBoundary (no
    signature, no window update, PBFT.hs:326)."""

    block_no: int
    slot: int
    prev_hash: bytes | None
    issuer_vk: bytes  # 32 — genesis delegate key (zeros for an EBB)
    body_hash: bytes  # 32
    sig: bytes  # 64 — Ed25519 over signed_bytes (zeros for an EBB)
    is_ebb: bool = False

    @cached_property
    def signed_bytes(self) -> bytes:
        return cbor.encode(
            [self.block_no, self.slot, self.prev_hash, self.issuer_vk,
             self.body_hash, self.is_ebb]
        )

    @cached_property
    def bytes_(self) -> bytes:
        return cbor.encode(
            [self.block_no, self.slot, self.prev_hash, self.issuer_vk,
             self.body_hash, self.sig, self.is_ebb]
        )

    @cached_property
    def hash_(self) -> bytes:
        return _b2b(self.bytes_)

    @property
    def point(self) -> Point:
        return Point(self.slot, self.hash_)

    def to_view(self):
        """ValidateView: PBftValidateBoundary for EBBs (a sentinel the
        protocol recognizes), PBftValidateRegular otherwise."""
        if self.is_ebb:
            return BOUNDARY_VIEW
        return PBftView(self.issuer_vk, self.signed_bytes, self.sig)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ByronMockHeader":
        bn, slot, prev, vk, bh, sig, ebb = cbor.decode(data)
        return cls(bn, slot, prev, vk, bh, sig, bool(ebb))


def body_hash(txs: Sequence[bytes]) -> bytes:
    return _b2b(cbor.encode(list(txs)))


@dataclass(frozen=True)
class ByronMockBlock:
    header: ByronMockHeader
    txs: tuple[bytes, ...] = ()

    @cached_property
    def bytes_(self) -> bytes:
        return cbor.encode([self.header.bytes_, list(self.txs)])

    @property
    def hash_(self) -> bytes:
        return self.header.hash_

    @property
    def slot(self) -> int:
        return self.header.slot

    @property
    def block_no(self) -> int:
        return self.header.block_no

    @property
    def prev_hash(self) -> bytes | None:
        return self.header.prev_hash

    @property
    def point(self) -> Point:
        return self.header.point

    def check_integrity(self) -> bool:
        return body_hash(self.txs) == self.header.body_hash

    @classmethod
    def from_bytes(cls, data: bytes) -> "ByronMockBlock":
        hdr, txs = cbor.decode(data)
        return cls(ByronMockHeader.from_bytes(hdr), tuple(txs))


def forge_block(
    seed: bytes,
    *,
    slot: int,
    block_no: int,
    prev_hash: bytes | None,
    txs: tuple[bytes, ...] = (),
) -> ByronMockBlock:
    """Forge a delegate block (Byron forging: sign the header body with
    the delegate's Ed25519 key — Byron/Forge.hs shape)."""
    vk = native.ed25519_public(seed)
    bh = body_hash(txs)
    unsigned = ByronMockHeader(block_no, slot, prev_hash, vk, bh, b"\x00" * 64)
    sig = native.ed25519_sign(seed, unsigned.signed_bytes)
    return ByronMockBlock(
        ByronMockHeader(block_no, slot, prev_hash, vk, bh, sig), tuple(txs)
    )


def forge_ebb(
    *, slot: int, block_no: int, prev_hash: bytes | None
) -> ByronMockBlock:
    """Forge an epoch boundary block (Byron/EBBs.hs): unsigned, empty;
    `block_no` must equal the PREDECESSOR's (EBBs do not advance the
    block count), `slot` the new epoch's first slot."""
    hdr = ByronMockHeader(
        block_no, slot, prev_hash, b"\x00" * 32, body_hash(()),
        b"\x00" * 64, is_ebb=True,
    )
    return ByronMockBlock(hdr, ())
