"""Minimal deterministic CBOR (RFC 8949 subset) encoder/decoder.

Reference equivalent: the `cborg` codecs used throughout the reference for
block/header/ledger serialisation (e.g. the Praos header codec at
ouroboros-consensus-protocol/.../Protocol/Praos/Header.hs:168-238 and the
storage codecs in ouroboros-consensus/.../Storage/Serialisation.hs).

Supports: unsigned/negative ints, byte strings, text strings, definite
arrays/maps, tags, bools/null, and floats (decode only for floats we never
emit). Always emits canonical (smallest-width) heads — encoding is
deterministic, a requirement for hashing headers and golden tests.
"""

from __future__ import annotations

import struct
from typing import Any

_MAJOR_UINT = 0
_MAJOR_NEGINT = 1
_MAJOR_BYTES = 2
_MAJOR_TEXT = 3
_MAJOR_ARRAY = 4
_MAJOR_MAP = 5
_MAJOR_TAG = 6
_MAJOR_SIMPLE = 7


class Tag:
    __slots__ = ("tag", "value")

    def __init__(self, tag: int, value: Any):
        self.tag = tag
        self.value = value

    def __eq__(self, other):
        return (
            isinstance(other, Tag) and other.tag == self.tag and other.value == self.value
        )

    def __repr__(self):
        return f"Tag({self.tag}, {self.value!r})"


def _encode_head(major: int, arg: int) -> bytes:
    mb = major << 5
    if arg < 24:
        return bytes([mb | arg])
    if arg < 1 << 8:
        return bytes([mb | 24, arg])
    if arg < 1 << 16:
        return bytes([mb | 25]) + arg.to_bytes(2, "big")
    if arg < 1 << 32:
        return bytes([mb | 26]) + arg.to_bytes(4, "big")
    if arg < 1 << 64:
        return bytes([mb | 27]) + arg.to_bytes(8, "big")
    raise ValueError("CBOR head argument too large")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _encode_into(obj, out)
    return bytes(out)


def _encode_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int):
        if obj >= 0:
            out += _encode_head(_MAJOR_UINT, obj)
        else:
            out += _encode_head(_MAJOR_NEGINT, -1 - obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out += _encode_head(_MAJOR_BYTES, len(b))
        out += b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += _encode_head(_MAJOR_TEXT, len(b))
        out += b
    elif isinstance(obj, (list, tuple)):
        out += _encode_head(_MAJOR_ARRAY, len(obj))
        for item in obj:
            _encode_into(item, out)
    elif isinstance(obj, dict):
        out += _encode_head(_MAJOR_MAP, len(obj))
        # canonical: sort by encoded key
        items = sorted(((encode(k), v) for k, v in obj.items()), key=lambda kv: kv[0])
        for kenc, v in items:
            out += kenc
            _encode_into(v, out)
    elif isinstance(obj, Tag):
        out += _encode_head(_MAJOR_TAG, obj.tag)
        _encode_into(obj.value, out)
    elif isinstance(obj, float):
        out.append(0xFB)
        out += struct.pack(">d", obj)
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj)}")


class DecodeError(ValueError):
    pass


def decode(data: bytes) -> Any:
    obj, off = _decode_item(data, 0)
    if off != len(data):
        raise DecodeError(f"trailing bytes at {off}")
    return obj


def decode_prefix(data: bytes, offset: int = 0) -> tuple[Any, int]:
    """Decode one item starting at `offset`; return (value, next_offset)."""
    return _decode_item(data, offset)


def _read_head(data: bytes, off: int) -> tuple[int, int, int]:
    if off >= len(data):
        raise DecodeError("truncated")
    ib = data[off]
    major, info = ib >> 5, ib & 0x1F
    off += 1
    if info < 24:
        return major, info, off
    if info == 24:
        n = 1
    elif info == 25:
        n = 2
    elif info == 26:
        n = 4
    elif info == 27:
        n = 8
    else:
        raise DecodeError(f"unsupported head info {info}")
    if off + n > len(data):
        raise DecodeError("truncated head")
    return major, int.from_bytes(data[off : off + n], "big"), off + n


def _decode_item(data: bytes, off: int) -> tuple[Any, int]:
    if off < len(data) and (data[off] >> 5) == _MAJOR_SIMPLE:
        return _decode_simple(data, off)
    major, arg, off = _read_head(data, off)
    if major == _MAJOR_UINT:
        return arg, off
    if major == _MAJOR_NEGINT:
        return -1 - arg, off
    if major == _MAJOR_BYTES:
        if off + arg > len(data):
            raise DecodeError("truncated bytes")
        return data[off : off + arg], off + arg
    if major == _MAJOR_TEXT:
        if off + arg > len(data):
            raise DecodeError("truncated text")
        return data[off : off + arg].decode("utf-8"), off + arg
    if major == _MAJOR_ARRAY:
        items = []
        for _ in range(arg):
            item, off = _decode_item(data, off)
            items.append(item)
        return items, off
    if major == _MAJOR_MAP:
        d = {}
        for _ in range(arg):
            k, off = _decode_item(data, off)
            v, off = _decode_item(data, off)
            if isinstance(k, (bytes, str, int)):
                d[k] = v
            else:
                raise DecodeError("unhashable map key")
        return d, off
    if major == _MAJOR_TAG:
        v, off = _decode_item(data, off)
        return Tag(arg, v), off
    raise DecodeError(f"unsupported major type {major}")


def _decode_simple(data: bytes, off: int) -> tuple[Any, int]:
    """Major type 7: simple values and floats, dispatched on the head INFO
    (not the decoded argument — float bits are payload, not a length)."""
    info = data[off] & 0x1F
    off += 1
    if info == 20:
        return False, off
    if info == 21:
        return True, off
    if info == 22:
        return None, off
    if info in (25, 26, 27):
        n = {25: 2, 26: 4, 27: 8}[info]
        if off + n > len(data):
            raise DecodeError("truncated float")
        fmt = {25: ">e", 26: ">f", 27: ">d"}[info]
        return struct.unpack(fmt, data[off : off + n])[0], off + n
    raise DecodeError(f"unsupported simple value {info}")
