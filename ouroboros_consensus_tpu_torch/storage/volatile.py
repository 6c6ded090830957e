"""VolatileDB: unordered store of recent blocks, GC'd by slot.

The port's copy of the JAX package's storage/volatile.py: the same files
byte for byte, so each package reads the other's.

Reference: `Ouroboros.Consensus.Storage.VolatileDB` (7 files, ~1.7k LoC) —
blocks append to `blocks-N.dat` files (Impl.hs:83-96) capped at
`maxBlocksPerFile` (Impl.hs:208); all lookup state (block info by hash,
successor map by prev-hash) is IN MEMORY and rebuilt by reparsing the
files on open; garbage collection removes whole files whose blocks are all
older than the GC slot.

On-disk record framing (per block):  u32 length ‖ u32 crc32 ‖ bytes.
A torn/corrupt record truncates its file at that point on open (the
reference's ParseError truncation).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterable

from ..block.praos_block import Block
from ..utils.fs import REAL_FS


@dataclass(frozen=True)
class BlockInfo:
    """What the in-memory index holds per block (VolatileDB API's
    BlockInfo): enough for ChainSel's path finding without reads."""

    hash_: bytes
    prev_hash: bytes | None
    slot: int
    block_no: int
    file_no: int
    offset: int  # of the payload inside the file
    size: int


class VolatileDB:
    def __init__(self, path: str, max_blocks_per_file: int = 1000, fs=None,
                 decode_block=None):
        self.path = path
        self.max_blocks_per_file = max_blocks_per_file
        self.fs = fs if fs is not None else REAL_FS
        # block codec seam (the reference is polymorphic in blk): the
        # Praos block by default
        self.decode_block = Block.from_bytes if decode_block is None else decode_block
        self.fs.makedirs(path)
        self._info: dict[bytes, BlockInfo] = {}
        self._successors: dict[bytes | None, set[bytes]] = {}
        self._file_counts: dict[int, int] = {}
        self._reopen()

    # -- open / reparse ------------------------------------------------------

    def _files(self) -> list[int]:
        ns = []
        for f in self.fs.listdir(self.path):
            if f.startswith("blocks-") and f.endswith(".dat"):
                ns.append(int(f[len("blocks-") : -len(".dat")]))
        return sorted(ns)

    def _reopen(self) -> None:
        for n in self._files():
            p = self._file_path(n)
            data = self.fs.read_bytes(p)
            off = 0
            good_end = 0
            while off + 8 <= len(data):
                size, crc = struct.unpack_from("<II", data, off)
                payload = data[off + 8 : off + 8 + size]
                if len(payload) != size or zlib.crc32(payload) != crc:
                    break
                try:
                    blk = self.decode_block(payload)
                except Exception:
                    break
                self._index(blk, n, off + 8, size)
                off += 8 + size
                good_end = off
            if good_end != len(data):  # truncate torn tail
                self.fs.truncate(p, good_end)
        ns = self._files()
        self._write_file_no = ns[-1] if ns else 0

    def _file_path(self, n: int) -> str:
        return os.path.join(self.path, f"blocks-{n:04d}.dat")

    def _index(self, blk, file_no: int, offset: int, size: int) -> None:
        info = BlockInfo(
            blk.hash_, blk.prev_hash, blk.slot, blk.block_no, file_no, offset, size
        )
        self._info[blk.hash_] = info
        self._successors.setdefault(blk.prev_hash, set()).add(blk.hash_)
        self._file_counts[file_no] = self._file_counts.get(file_no, 0) + 1

    # -- API (Storage/VolatileDB/API.hs) -------------------------------------

    def put_block(self, blk) -> None:
        if blk.hash_ in self._info:
            return  # duplicates are no-ops (putBlock idempotence)
        n = self._write_file_no
        if self._file_counts.get(n, 0) >= self.max_blocks_per_file:
            n = self._write_file_no = n + 1
        raw = blk.bytes_
        p = self._file_path(n)
        offset = (self.fs.getsize(p) if self.fs.exists(p) else 0) + 8
        self.fs.append(p, struct.pack("<II", len(raw), zlib.crc32(raw)) + raw)
        self._index(blk, n, offset, len(raw))

    def get_block_info(self, hash_: bytes) -> BlockInfo | None:
        return self._info.get(hash_)

    def member(self, hash_: bytes) -> bool:
        return hash_ in self._info

    def get_block_bytes(self, hash_: bytes) -> bytes | None:
        info = self._info.get(hash_)
        if info is None:
            return None
        return self.fs.read_at(self._file_path(info.file_no), info.offset, info.size)

    def filter_by_predecessor(self, prev_hash: bytes | None) -> set[bytes]:
        """The successor map ChainSel's path finding walks (Paths.hs)."""
        return set(self._successors.get(prev_hash, ()))

    def garbage_collect(self, slot: int) -> None:
        """Remove whole files whose blocks all have slot < `slot`
        (VolatileDB GC granularity is the file, Impl.hs garbageCollect)."""
        by_file: dict[int, list[BlockInfo]] = {}
        for info in self._info.values():
            by_file.setdefault(info.file_no, []).append(info)
        for n, infos in by_file.items():
            if n == self._write_file_no:
                continue  # never GC the write file
            if all(i.slot < slot for i in infos):
                self.fs.remove(self._file_path(n))
                for i in infos:
                    del self._info[i.hash_]
                    succ = self._successors.get(i.prev_hash)
                    if succ is not None:
                        succ.discard(i.hash_)
                        if not succ:
                            del self._successors[i.prev_hash]
                self._file_counts.pop(n, None)

    def all_hashes(self) -> Iterable[bytes]:
        return self._info.keys()
