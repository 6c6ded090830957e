"""One-byte corruptions of a stored chain, for the replay checks.

A flipped byte is re-sealed in the block's index CRC, so storage
validation passes and only a protocol check can catch it. Flipping a
byte of the VRF proof alone would be caught by the KES check first (the
proof lies inside the KES-signed header body); given the forging
credentials, the header body is KES-signed again after the flip, so that
the VRF check is the one that fails.

`standin_views` rewrites parsed views instead: each view's KES-signed
body becomes a stand-in that embeds none of the header's fields (as the
JAX package's fixture views carry), so the packed staging declines the
window and the generic staging takes it.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

from ..block.praos_block import Block, Header
from ..storage.immutable import ImmutableDB, chunk_name, index_name
from ..utils import cbor
from .synth import kes_sign

FIELDS = ("kes_sig", "vrf_proof", "ocert_sigma")


def flip_header_byte(db_path: str, index: int, field: str, offset: int = 40,
                     params=None, pool=None) -> None:
    """Flip byte `offset` of header `index`'s `field` (one of FIELDS).
    With `params` and `pool` (the PoolCredentials that forged the block)
    a flipped VRF proof's header body is KES-signed again."""
    if field not in FIELDS:
        raise ValueError(f"unknown field {field!r}")
    imm = ImmutableDB(os.path.join(db_path, "immutable"))
    entries = [(n, k, e) for n in imm._chunks for k, e in enumerate(imm._entries[n])]
    n, k, e = entries[index]
    cpath = os.path.join(imm.path, chunk_name(n))
    with open(cpath, "rb") as f:
        data = bytearray(f.read())
    blob = bytes(data[e.offset: e.offset + e.size])
    block = Block.from_bytes(blob)
    h = block.header
    target = {"kes_sig": h.kes_sig, "vrf_proof": h.body.vrf_proof,
              "ocert_sigma": h.body.ocert.sigma}[field]
    if pool is None:
        data[e.offset + blob.index(target) + offset] ^= 0x01
    else:
        if field != "vrf_proof":
            raise ValueError("only a flipped VRF proof is KES-signed again")
        flipped = bytearray(target)
        flipped[offset] ^= 0x01
        body = dataclasses.replace(h.body, vrf_proof=bytes(flipped))
        t = params.kes_period_of(body.slot) - body.ocert.kes_period
        sig = kes_sign(pool.kes_seed, pool.kes_depth, t, body.signed_bytes)
        new = Block(Header(body, sig), block.txs).bytes_
        if len(new) != len(blob):
            raise AssertionError("the re-signed block changed length")
        data[e.offset: e.offset + e.size] = new
    with open(cpath, "wb") as f:
        f.write(bytes(data))
    rows = [e2.to_cbor_obj() for e2 in imm._entries[n]]
    rows[k][5] = zlib.crc32(bytes(data[e.offset: e.offset + e.size]))
    with open(os.path.join(imm.path, index_name(n)), "wb") as f:
        f.write(b"".join(cbor.encode(r) for r in rows))


def standin_views(hvs: list, params, pool, body: bytes = b"") -> list:
    """`hvs` with every KES-signed body replaced by `body` and KES-signed
    again by `pool` (the PoolCredentials that forged them); the OCert and
    the VRF proof stay valid."""
    out = []
    for hv in hvs:
        t = params.kes_period_of(hv.slot) - hv.ocert.kes_period
        out.append(dataclasses.replace(
            hv, signed_bytes=body,
            kes_sig=kes_sign(pool.kes_seed, pool.kes_depth, t, body)))
    return out
