"""ImmutableDB: append-only chunked store of the immutable chain.

Reference: `Ouroboros.Consensus.Storage.ImmutableDB` — `NNNNN.chunk`
files of concatenated block bytes, and one index per chunk:

    NNNNN.chunk      block bytes, concatenated
    NNNNN.index      CBOR [slot, block_no, hash, offset, size, crc32] per block
    NNNNN.cols       the chunk's sealed header columns (storage/sidecar.py)

The on-disk bytes are the JAX package's byte for byte. Reading validates
as the reference's ValidateAllChunks does (Impl/Validation.hs:67): index
entries must tile the chunk, and every block's CRC and body hash must
hold; the chain ends (in memory — this store never rewrites the disk) at
the first block that fails.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from .. import native_scan
from ..utils import cbor


class ImmutableDBError(Exception):
    pass


@dataclass(frozen=True)
class IndexEntry:
    slot: int
    block_no: int
    hash_: bytes
    offset: int
    size: int
    crc32: int

    def to_cbor_obj(self):
        return [self.slot, self.block_no, self.hash_, self.offset, self.size, self.crc32]


def chunk_name(n: int) -> str:
    return f"{n:05d}.chunk"


def index_name(n: int) -> str:
    return f"{n:05d}.index"


def sidecar_name(n: int) -> str:
    """Chunk n's columnar sidecar, beside the chunk and index it is
    derived from."""
    return f"{n:05d}.cols"


class ImmutableDB:
    """Append-only block store; blocks arrive in strictly increasing slot
    order. `chunk_size` is in slots (chunk number = slot // chunk_size)."""

    def __init__(self, path: str, chunk_size: int = 21600):
        self.path = path
        self.chunk_size = chunk_size
        self._entries: dict[int, list[IndexEntry]] = {}
        self._chunks: list[int] = []
        if os.path.isdir(path):
            self._load()

    def _load(self) -> None:
        """Load every chunk's index, keeping the prefix whose entries tile
        the chunk contiguously (a torn or lagging index ends the chain)."""
        ns = sorted(
            int(f.split(".")[0]) for f in os.listdir(self.path)
            if f.endswith(".chunk")
        )
        for n in ns:
            entries = self._load_index(n)
            self._entries[n] = entries
            self._chunks.append(n)
            size = os.path.getsize(os.path.join(self.path, chunk_name(n)))
            end = entries[-1].offset + entries[-1].size if entries else 0
            if end != size:
                break  # a gap: later chunks are stranded

    def _load_index(self, n: int) -> list[IndexEntry]:
        """The chunk's index entries (one native parse) up to the first
        torn entry or the first that does not tile the chunk."""
        try:
            with open(os.path.join(self.path, index_name(n)), "rb") as f:
                data = f.read()
        except OSError:
            return []
        slots, block_nos, hashes, offsets, sizes, crcs = native_scan.parse_index(data)
        starts = np.concatenate(([0], (offsets + sizes)[:-1]))
        bad = np.flatnonzero((offsets != starts) | (sizes <= 0))
        k = int(bad[0]) if bad.size else len(offsets)
        hb = hashes.tobytes()
        return [
            IndexEntry(s, b, hb[32 * i: 32 * i + 32], o, z, c)
            for i, (s, b, o, z, c) in enumerate(zip(
                slots[:k].tolist(), block_nos[:k].tolist(), offsets[:k].tolist(),
                sizes[:k].tolist(), crcs[:k].tolist()))
        ]

    @property
    def is_empty(self) -> bool:
        return not any(self._entries.values())

    def tip(self) -> IndexEntry | None:
        for n in reversed(self._chunks):
            if self._entries[n]:
                return self._entries[n][-1]
        return None

    def n_blocks(self) -> int:
        return sum(len(v) for v in self._entries.values())

    def append_block(self, slot: int, block_no: int, hash_: bytes, raw: bytes) -> None:
        t = self.tip()
        if t is not None and slot <= t.slot:
            raise ImmutableDBError(f"append out of order: {slot} <= {t.slot}")
        os.makedirs(self.path, exist_ok=True)
        n = slot // self.chunk_size
        if n not in self._entries:
            self._entries[n] = []
            self._chunks.append(n)
            self._chunks.sort()
        cpath = os.path.join(self.path, chunk_name(n))
        offset = os.path.getsize(cpath) if os.path.exists(cpath) else 0
        with open(cpath, "ab") as f:
            f.write(raw)
        e = IndexEntry(slot, block_no, hash_, offset, len(raw), zlib.crc32(raw))
        self._entries[n].append(e)
        with open(os.path.join(self.path, index_name(n)), "ab") as f:
            f.write(cbor.encode(e.to_cbor_obj()))

    def flush(self) -> None:
        """fsync the newest chunk and its index (clean shutdown)."""
        if not self._chunks:
            return
        n = self._chunks[-1]
        for name in (chunk_name(n), index_name(n)):
            p = os.path.join(self.path, name)
            if os.path.exists(p):
                fd = os.open(p, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)

    def chunk_entries(self) -> Iterator[tuple[int, list[IndexEntry]]]:
        """(chunk number, index entries) of every chunk that has
        entries, in slot order."""
        for n in self._chunks:
            if self._entries[n]:
                yield n, self._entries[n]

    def read_chunk(self, n: int) -> bytes:
        """Chunk n's bytes, in one read."""
        with open(os.path.join(self.path, chunk_name(n)), "rb") as f:
            return f.read()

    @staticmethod
    def deep_check(data: bytes, entries: list[IndexEntry],
                   check_batch: Callable[[bytes, list], int]) -> int:
        """The number of leading entries of a loaded chunk that pass: one
        native CRC sweep over every entry's span, then `check_batch`
        (data, entries) -> the index of the first block that fails the
        integrity check (len(entries) when none does) over the entries
        before the first CRC failure: the header scan of
        `db_analyser.check_integrity_batch`, or a sidecar's body-hash
        compare (`sidecar.integrity_batch_hook`). The count is that of
        the per-block walk of `stream_validated`."""
        rc = native_scan.crc32_first_bad(
            data, [e.offset for e in entries], [e.size for e in entries],
            [e.crc32 for e in entries])
        good = len(entries) if rc < 0 else rc
        if good == 0:
            return 0
        return min(good, check_batch(data, entries[:good]))

    def stream_validated(self, decode, check) -> Iterator:
        """Yield decode(blob) for every block in slot order, stopping at
        the first block whose CRC mismatches its index entry, that does
        not decode, or for which `check(decoded)` is false — the
        all-chunks validation walk folded into the replay's own read."""
        for n in self._chunks:
            entries = self._entries[n]
            if not entries:
                continue
            with open(os.path.join(self.path, chunk_name(n)), "rb") as f:
                data = f.read()
            for e in entries:
                blob = data[e.offset : e.offset + e.size]
                if len(blob) != e.size or zlib.crc32(blob) != e.crc32:
                    return
                try:
                    item = decode(blob)
                except Exception:  # noqa: BLE001 — an undecodable block ends the chain
                    return
                if not check(item):
                    return
                yield item
