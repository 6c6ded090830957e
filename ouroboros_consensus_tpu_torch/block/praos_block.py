"""Praos header & block model with deterministic CBOR codecs.

Reference: the standalone Praos header (Protocol/Praos/Header.hs:62-125):
`HeaderBody` carries 10 fields; `Header = (HeaderBody, KES signature)`;
the header hash is Blake2b-256 of its CBOR (Header.hs:158). The KES
signature signs the CBOR of the HeaderBody — exactly the bytes the batched
verifier consumes (`HeaderView.signed_bytes`). A block is the header plus
a list of opaque tx byte strings; `body_hash` covers their CBOR list.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Sequence

from ..protocol.views import HeaderView, OCert
from ..utils import cbor
from ..utils.hashes import blake2b_256
from .abstract import Point


@dataclass(frozen=True)
class HeaderBody:
    """The KES-signed part of a Praos header (Praos/Header.hs:62-84)."""

    block_no: int
    slot: int
    prev_hash: bytes | None  # None = genesis
    issuer_vk: bytes  # 32 — cold key
    vrf_vk: bytes  # 32
    vrf_output: bytes  # 64 — certified output beta
    vrf_proof: bytes  # ECVRF proof pi: 80 (draft-03) or 128 (batch-compat)
    body_size: int
    body_hash: bytes  # 32
    ocert: OCert
    protocol_version: tuple[int, int] = (9, 0)

    def to_cbor_obj(self):
        return [
            self.block_no,
            self.slot,
            self.prev_hash,
            self.issuer_vk,
            self.vrf_vk,
            [self.vrf_output, self.vrf_proof],
            self.body_size,
            self.body_hash,
            [self.ocert.vk_hot, self.ocert.counter, self.ocert.kes_period, self.ocert.sigma],
            [self.protocol_version[0], self.protocol_version[1]],
        ]

    @classmethod
    def from_cbor_obj(cls, obj) -> "HeaderBody":
        (bn, slot, prev, ivk, vvk, (vout, vproof), bsz, bh, oc, pv) = obj
        return cls(
            block_no=bn, slot=slot,
            prev_hash=bytes(prev) if prev is not None else None,
            issuer_vk=bytes(ivk), vrf_vk=bytes(vvk),
            vrf_output=bytes(vout), vrf_proof=bytes(vproof),
            body_size=bsz, body_hash=bytes(bh),
            ocert=OCert(bytes(oc[0]), oc[1], oc[2], bytes(oc[3])),
            protocol_version=(pv[0], pv[1]),
        )

    @cached_property
    def signed_bytes(self) -> bytes:
        """The exact bytes the KES signature covers (Header.hs:120-125)."""
        return cbor.encode(self.to_cbor_obj())


@dataclass(frozen=True)
class Header:
    body: HeaderBody
    kes_sig: bytes

    @cached_property
    def bytes_(self) -> bytes:
        return cbor.encode([self.body.to_cbor_obj(), self.kes_sig])

    @cached_property
    def hash_(self) -> bytes:
        """Blake2b-256 of the serialized header (Header.hs:158)."""
        return blake2b_256(self.bytes_)

    @property
    def slot(self) -> int:
        return self.body.slot

    @property
    def block_no(self) -> int:
        return self.body.block_no

    @property
    def prev_hash(self) -> bytes | None:
        return self.body.prev_hash

    @property
    def point(self) -> Point:
        return Point(self.slot, self.hash_)

    def to_view(self) -> HeaderView:
        """Project the exact validation inputs (Praos/Views.hs:22-39)."""
        b = self.body
        return HeaderView(
            prev_hash=b.prev_hash,
            vk_cold=b.issuer_vk,
            vrf_vk=b.vrf_vk,
            vrf_output=b.vrf_output,
            vrf_proof=b.vrf_proof,
            ocert=b.ocert,
            slot=b.slot,
            signed_bytes=b.signed_bytes,
            kes_sig=self.kes_sig,
        )


def body_hash(txs: Sequence[bytes]) -> bytes:
    """Blake2b-256 over the canonical CBOR of the tx list."""
    return blake2b_256(cbor.encode(list(txs)))


@dataclass(frozen=True)
class Block:
    """header + opaque txs."""

    header: Header
    txs: tuple[bytes, ...] = ()

    @cached_property
    def bytes_(self) -> bytes:
        return cbor.encode(
            [[self.header.body.to_cbor_obj(), self.header.kes_sig], list(self.txs)]
        )

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
        return Point(self.slot, self.hash_)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Block":
        (body_obj, sig), txs = cbor.decode(data)
        return cls(
            Header(HeaderBody.from_cbor_obj(body_obj), bytes(sig)),
            tuple(bytes(t) for t in txs),
        )

    def check_integrity(self) -> bool:
        """nodeCheckIntegrity analog: the declared body hash matches."""
        return body_hash(self.txs) == self.header.body.body_hash
