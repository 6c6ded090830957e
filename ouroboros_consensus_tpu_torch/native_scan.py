"""ctypes binding of the repo's native chunk scanner (native/headerscan.cpp).

Built with g++ on first use into the port's build directory, as
`native.py` builds the host crypto; a failed build raises (there is no
slower per-block path to fall to). Four entry points:

- `extract_headers`: one chunk's blocks parsed into `HeaderColumns` (the
  fixed-width header fields as numpy columns, the variable-width ones as
  (offset, length) spans into the chunk's bytes);
- `crc32_first_bad`: the CRC sweep of the index's spans;
- `parse_index`: a chunk index's CBOR entries as columns;
- `scan_items`: the spans of a chunk's complete top-level CBOR items
  (the index rebuild of storage/immutable.py).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .native import BUILD_DIR, build_shared

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_REPO, "native", "headerscan.cpp")
SO = os.path.join(BUILD_DIR, "libheaderscan.so")

_lib = None


def lib():
    """The loaded scanner, building it on first use (raises on failure)."""
    global _lib
    if _lib is not None:
        return _lib
    so = ctypes.CDLL(build_shared(SRC, SO, "-O2"))
    so.ocx_extract_headers.restype = ctypes.c_int
    so.ocx_extract_headers.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
        *([ctypes.c_void_p] * 22),
    ]
    so.ocx_crc32_first_bad.restype = ctypes.c_int64
    so.ocx_crc32_first_bad.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    so.ocx_parse_index.restype = ctypes.c_int64
    so.ocx_parse_index.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64,
        *([ctypes.c_void_p] * 6),
    ]
    so.ocx_scan_items.restype = ctypes.c_int
    so.ocx_scan_items.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    _lib = so
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_index(buf: bytes):
    """Columnar parse of a chunk index (concatenated CBOR entries [slot,
    block_no, hash, offset, size, crc32]) up to the first torn or
    malformed entry -> (slots, block_nos, hashes [n, 32], offsets, sizes,
    crcs)."""
    # a well-formed entry takes at least 40 bytes, so this capacity is
    # never reached by a real index
    cap = len(buf) // 40 + 1
    slots, block_nos = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    hashes = np.zeros((cap, 32), np.uint8)
    offsets, sizes, crcs = (np.zeros(cap, np.int64) for _ in range(3))
    n = int(lib().ocx_parse_index(
        buf, len(buf), cap, _ptr(slots), _ptr(block_nos), _ptr(hashes),
        _ptr(offsets), _ptr(sizes), _ptr(crcs)))
    return slots[:n], block_nos[:n], hashes[:n], offsets[:n], sizes[:n], crcs[:n]


def scan_items(buf: bytes, max_items: int = 1 << 20):
    """(offsets, sizes, end) of the complete top-level CBOR items at the
    start of `buf`: `end` is where the well-formed prefix stops (len(buf)
    when the whole buffer parses; past it lies a torn tail)."""
    offsets = np.zeros(max_items, np.int64)
    sizes = np.zeros(max_items, np.int64)
    end = np.zeros(1, np.int64)
    n = int(lib().ocx_scan_items(buf, len(buf), _ptr(offsets), _ptr(sizes), max_items,
                                 _ptr(end)))
    return offsets[:n].copy(), sizes[:n].copy(), int(end[0])


def crc32_first_bad(buf: bytes, offsets, sizes, expected) -> int:
    """Index of the first span buf[offsets[i] : offsets[i] + sizes[i]]
    whose zlib CRC-32 differs from expected[i] (or that leaves the
    buffer); -1 when all match."""
    offs = np.ascontiguousarray(offsets, np.int64)
    szs = np.ascontiguousarray(sizes, np.int64)
    exp = np.ascontiguousarray(expected, np.int64)
    if not offs.shape == szs.shape == exp.shape:
        raise ValueError("offsets, sizes and expected differ in length")
    return int(lib().ocx_crc32_first_bad(buf, len(buf), _ptr(offs), _ptr(szs),
                                         _ptr(exp), len(offs)))


class MalformedBlock(ValueError):
    """extract_headers hit a block it cannot parse; `.index` is its
    position in the offsets (the blocks before it parsed)."""

    def __init__(self, index: int):
        super().__init__(f"malformed block at index {index}")
        self.index = index


def _span_matrix(buf_u8: np.ndarray, off: np.ndarray, ln: np.ndarray):
    """[n, w] uint8 matrix over the (offset, length) spans of a chunk's
    bytes, or None when the spans differ in width. Spans at a uniform
    stride come back as a strided read-only view into the buffer (no
    copy); others as one gather."""
    n = len(off)
    if n == 0:
        return np.zeros((0, 0), np.uint8)
    w = int(ln[0])
    if not (ln == w).all():
        return None
    if n > 1:
        d = np.diff(off)
        d0 = int(d[0])
        if d0 > 0 and (d == d0).all():
            return np.lib.stride_tricks.as_strided(
                buf_u8[int(off[0]):], shape=(n, w), strides=(d0, 1))
    idx = off.astype(np.int64)[:, None] + np.arange(w, dtype=np.int64)
    return buf_u8[idx]


@dataclass
class HeaderColumns:
    """One chunk's headers as columns, straight from its bytes. The three
    variable-width fields (OCert sigma, KES signature, KES-signed body)
    are (offset, length) spans into `raw`: as `bytes` lists on first
    access, or as [n, w] matrices (`*_mat`, None when ragged)."""

    n: int
    block_no: np.ndarray  # [n] int64
    slot: np.ndarray  # [n] int64
    prev_hash: np.ndarray  # [n, 32] uint8
    has_prev: np.ndarray  # [n] uint8
    issuer_vk: np.ndarray  # [n, 32]
    vrf_vk: np.ndarray  # [n, 32]
    vrf_output: np.ndarray  # [n, 64]
    vrf_proof: np.ndarray  # [n, 128], zero-padded past the proof's length
    vrf_proof_len: np.ndarray  # [n] int64: 80 (draft-03) or 128 (bc)
    body_size: np.ndarray  # [n] int64
    body_hash: np.ndarray  # [n, 32]
    ocert_vk: np.ndarray  # [n, 32]
    ocert_counter: np.ndarray  # [n] int64
    ocert_kes_period: np.ndarray  # [n] int64
    pv_major: np.ndarray
    pv_minor: np.ndarray
    header_end: np.ndarray  # [n] int64: offset just past the header item
    raw: bytes  # the chunk's bytes the spans point into
    sig_off: np.ndarray  # [n] int64: OCert sigma span
    sig_len: np.ndarray
    kes_off: np.ndarray  # [n] int64: KES signature span
    kes_len: np.ndarray
    sgn_off: np.ndarray  # [n] int64: KES-signed body span
    sgn_len: np.ndarray

    def _span_list(self, off, ln) -> list:
        buf = self.raw
        return [buf[o: o + k] for o, k in zip(off.tolist(), ln.tolist())]

    @cached_property
    def _buf_u8(self) -> np.ndarray:
        return np.frombuffer(self.raw, np.uint8)

    @cached_property
    def ocert_sigma(self) -> list:
        return self._span_list(self.sig_off, self.sig_len)

    @cached_property
    def kes_sig(self) -> list:
        return self._span_list(self.kes_off, self.kes_len)

    @cached_property
    def signed_bytes(self) -> list:
        return self._span_list(self.sgn_off, self.sgn_len)

    @cached_property
    def ocert_sigma_mat(self):
        return _span_matrix(self._buf_u8, self.sig_off, self.sig_len)

    @cached_property
    def kes_sig_mat(self):
        return _span_matrix(self._buf_u8, self.kes_off, self.kes_len)

    @cached_property
    def signed_bytes_mat(self):
        return _span_matrix(self._buf_u8, self.sgn_off, self.sgn_len)


def extract_headers(buf: bytes, offsets) -> HeaderColumns:
    """Parse the blocks at `offsets` of a chunk's bytes into columns.
    Raises MalformedBlock at the first block that does not parse (its
    txs item is walked too, so garbled txs bytes count)."""
    n = len(offsets)
    offs = np.ascontiguousarray(offsets, np.int64)
    if n and (offs.min() < 0 or offs.max() >= len(buf)):
        raise ValueError("block offsets out of the chunk")

    def i64():
        return np.zeros(n, np.int64)

    def u8(w):
        return np.zeros((n, w), np.uint8)

    cols = dict(
        block_no=i64(), slot=i64(), prev_hash=u8(32), has_prev=np.zeros(n, np.uint8),
        issuer_vk=u8(32), vrf_vk=u8(32), vrf_output=u8(64), vrf_proof=u8(128),
        vrf_proof_len=i64(), body_size=i64(), body_hash=u8(32), ocert_vk=u8(32),
        ocert_counter=i64(), ocert_kes_period=i64(),
    )
    spans = dict(sig_off=i64(), sig_len=i64(), pv_major=i64(), pv_minor=i64(),
                 kes_off=i64(), kes_len=i64(), sgn_off=i64(), sgn_len=i64())
    rc = lib().ocx_extract_headers(
        buf, len(buf), _ptr(offs), n,
        *(_ptr(a) for a in cols.values()), *(_ptr(a) for a in spans.values()))
    if rc != 0:
        raise MalformedBlock(rc - 1)
    return HeaderColumns(n=n, header_end=spans["kes_off"] + spans["kes_len"],
                         raw=buf, **cols, **spans)
