"""One-byte corruptions of a stored chain, for the replay checks.

A flipped byte is re-sealed in the block's index CRC, so the CRC check
passes: a flip in the declared body hash is caught by the integrity
check on read, any other only by a protocol check. Flipping a
byte of the VRF proof alone would be caught by the KES check first (the
proof lies inside the KES-signed header body); given the forging
credentials, the header body is KES-signed again after the flip, so that
the VRF check is the one that fails.

`flip_volatile_byte` flips a byte of a block in a VolatileDB's files and
re-frames its record (length and CRC), so that the reopened VolatileDB
keeps the block, under a new hash (the header's bytes changed), and only
chain selection's validation can reject it.

`flip_mixed_byte` does the same to a block of a mixed-era chain (a
Byron signature, a Praos-class KES signature or VRF proof).

`standin_views` rewrites parsed views instead: each view's KES-signed
body becomes a stand-in that embeds none of the header's fields (as the
JAX package's fixture views carry), so the packed staging declines the
window and the generic staging takes it.

`corrupt_packed` corrupts a staged packed window (the `unpack` kernel's
input) lane by lane, one WIRE_KINDS kind on 4 lanes each.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np

from ..block.praos_block import Block, Header
from ..ops.host_kes import sign as kes_sign
from ..protocol.batch import LANE_COLUMNS
from ..storage.immutable import ImmutableDB, chunk_name, index_name
from ..storage.volatile import VolatileDB
from ..utils import cbor

FIELDS = ("kes_sig", "vrf_proof", "ocert_sigma", "body_hash")


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
              "ocert_sigma": h.body.ocert.sigma, "body_hash": h.body.body_hash}[field]
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
    _rewrite(imm, n, k, e, data)


def flip_volatile_byte(vol_path: str, hash_: bytes, field: str = "kes_sig",
                       offset: int = 40) -> bytes:
    """Flip byte `offset` of `field` (one of FIELDS) in the header of the
    block `hash_` of the VolatileDB at `vol_path`, with its record's CRC
    re-sealed. -> the corrupted block's hash."""
    if field not in FIELDS:
        raise ValueError(f"unknown field {field!r}")
    info = VolatileDB(vol_path).get_block_info(hash_)
    if info is None:
        raise KeyError(f"no block {hash_.hex()} in {vol_path}")
    path = os.path.join(vol_path, f"blocks-{info.file_no:04d}.dat")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    blob = bytes(data[info.offset: info.offset + info.size])
    h = Block.from_bytes(blob).header
    target = {"kes_sig": h.kes_sig, "vrf_proof": h.body.vrf_proof,
              "ocert_sigma": h.body.ocert.sigma, "body_hash": h.body.body_hash}[field]
    data[info.offset + blob.index(target) + offset] ^= 0x01
    new = bytes(data[info.offset: info.offset + info.size])
    struct.pack_into("<I", data, info.offset - 4, zlib.crc32(new))
    with open(path, "wb") as f:
        f.write(bytes(data))
    return Block.from_bytes(new).hash_


def _rewrite(imm, n: int, k: int, e, data: bytearray) -> None:
    """Write chunk n's bytes back with entry k's CRC re-sealed."""
    cpath = os.path.join(imm.path, chunk_name(n))
    with open(cpath, "wb") as f:
        f.write(bytes(data))
    rows = [e2.to_cbor_obj() for e2 in imm._entries[n]]
    rows[k][5] = zlib.crc32(bytes(data[e.offset: e.offset + e.size]))
    with open(os.path.join(imm.path, index_name(n)), "wb") as f:
        f.write(b"".join(cbor.encode(r) for r in rows))


MIXED_FIELDS = ("byron_sig", "kes_sig", "vrf_proof")


def flip_mixed_byte(db_path: str, index: int, field: str, offset: int = 7,
                    params=None, pool=None) -> None:
    """flip_header_byte for a mixed-era chain (hardfork/composite.py):
    flip byte `offset` of block `index`'s `field` (one of MIXED_FIELDS:
    a Byron header's signature, a Praos-class header's KES signature or
    VRF proof), the index CRC re-sealed. With `params` and `pool` (the
    credentials that forged the block) a flipped VRF proof's header body
    is KES-signed again, so that the VRF check is the one that fails."""
    from ..hardfork.byron_mock import ByronMockBlock
    from ..hardfork.combinator import HardForkBlock

    if field not in MIXED_FIELDS:
        raise ValueError(f"unknown field {field!r}")
    imm = ImmutableDB(os.path.join(db_path, "immutable"))
    entries = [(n, k, e) for n in imm._chunks for k, e in enumerate(imm._entries[n])]
    n, k, e = entries[index]
    data = bytearray(imm.read_chunk(n))
    blob = bytes(data[e.offset: e.offset + e.size])
    era, inner = cbor.decode(blob)
    if (field == "byron_sig") != (era == 0):
        raise ValueError(f"block {index} is of era {era}: no {field}")
    if field == "byron_sig":
        target = ByronMockBlock.from_bytes(inner).header.sig
    else:
        block = Block.from_bytes(inner)
        target = block.header.kes_sig if field == "kes_sig" else block.header.body.vrf_proof
    if pool is None:
        data[e.offset + blob.index(target) + offset] ^= 0x01
    else:
        if field != "vrf_proof":
            raise ValueError("only a flipped VRF proof is KES-signed again")
        flipped = bytearray(target)
        flipped[offset] ^= 0x01
        body = dataclasses.replace(block.header.body, vrf_proof=bytes(flipped))
        t = params.kes_period_of(body.slot) - body.ocert.kes_period
        sig = kes_sign(pool.kes_seed, pool.kes_depth, t, body.signed_bytes)
        new = HardForkBlock(era, Block(Header(body, sig), block.txs)).bytes_
        if len(new) != len(blob):
            raise AssertionError("the re-signed block changed length")
        data[e.offset: e.offset + e.size] = new
    _rewrite(imm, n, k, e, data)


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


WIRE_KINDS = ("issuer", "sigma", "vk_hot", "vrf_vk", "proof", "beta", "kes_rs",
              "counter_max", "slot_max", "c0_ahead", "tail_row", "thr_row")


def corrupt_packed(layout, packed, rng: np.random.Generator):
    """Every wire corrupt kind on 4 seeded lanes each of a numpy packed
    window: a flipped bit in each body field the stages read and in the
    KES signature's R ‖ s, the int32 extremes of counter and slot, a c0
    past the slot's KES period (a negative period), and lanes pointed at
    a new KES-tail and a new threshold row. -> the corrupted window."""
    p = packed._replace(**{k: getattr(packed, k).copy() for k in (
        "body", "kes_rs", "slot", "counter", "c0", "kes_tail_idx", "thr_idx")})
    b = p.body.shape[0]
    lanes = rng.choice(b, size=(len(WIRE_KINDS), 4), replace=False)
    field = {"issuer": (layout.o_issuer, 32), "sigma": (layout.o_sigma, 64),
             "vk_hot": (layout.o_vk_hot, 32), "vrf_vk": (layout.o_vrf_vk, 32),
             "proof": (layout.o_vrf_proof, layout.vrf_proof_len),
             "beta": (layout.o_vrf_out, 64)}
    tail = p.kes_tail_tab[:1].copy()
    tail[0, int(rng.integers(tail.shape[1]))] ^= 0x10
    thr = p.thr_tab[:1].copy()
    thr[0, int(rng.integers(64))] ^= 0x01
    p = p._replace(kes_tail_tab=np.concatenate([p.kes_tail_tab, tail]),
                   thr_tab=np.concatenate([p.thr_tab, thr]))
    for kind, ls in zip(WIRE_KINDS, lanes.tolist()):
        for i in ls:
            if kind in field:
                o, n = field[kind]
                p.body[i, o + int(rng.integers(n))] ^= 1 << int(rng.integers(8))
            elif kind == "kes_rs":
                p.kes_rs[i, int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            elif kind == "counter_max":
                p.counter[i] = 2**31 - 1
            elif kind == "slot_max":
                p.slot[i] = 2**31 - 1
            elif kind == "c0_ahead":
                p.c0[i] = p.slot[i] // layout.slots_per_kes + 5
            elif kind == "tail_row":
                p.kes_tail_idx[i] = p.kes_tail_tab.shape[0] - 1
            elif kind == "thr_row":
                p.thr_idx[i] = p.thr_tab.shape[0] - 1
    return p


def first_lanes(packed, n: int):
    """A packed window's first n lanes (the tables and nonce shared)."""
    return packed._replace(**{k: getattr(packed, k)[:n] for k in LANE_COLUMNS})
