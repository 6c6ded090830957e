"""ImmutableDB: append-only chunked store of the immutable chain.

Reference: `Ouroboros.Consensus.Storage.ImmutableDB` — `NNNNN.chunk`
files of concatenated block bytes, and one index per chunk:

    NNNNN.chunk      block bytes, concatenated
    NNNNN.index      CBOR [slot, block_no, hash, offset, size, crc32] per block
    NNNNN.cols       the chunk's sealed header columns (storage/sidecar.py)

The on-disk bytes are the JAX package's byte for byte, and so is the
open's validation and repair (its storage/immutable.py; ImmutableDB/
Impl/Validation.hs:67): each index is parsed natively into columns and
must tile its chunk; an index that is missing, torn or lags its chunk is
rebuilt from the chunk's bytes; the most recent chunk (every chunk under
`validate_all`) is deep-checked, its CRCs and, with `check_integrity`,
its body hashes; the chain is cut at the first block that fails, and
chunks stranded past a cut are dropped. Every repair is a row on
`repairs` (storage/repair.py). With `repair` the cuts are written to
disk and every snipped byte moves into ``quarantine/``; without it (the
default here: the port's readers never write) the same scan computes
them in memory only (rows with applied=False). Orphaned indexes and
sidecars, and sidecar tmp files a crash left, are swept at the open.

`stream_deep` defers the all-chunks checks to the reader
(db_analyser's validate_all="stream"), and `stream_repair` lets it write
back the cut it finds (`repair_to`). Appends go through the chaos
``append`` seam (testing/chaos.write_fault).
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from .. import native_scan
from ..block.abstract import Point
from ..testing import chaos
from ..utils import cbor
from ..utils.fs import REAL_FS
from . import repair as repair_mod


class ImmutableDBError(Exception):
    pass


class MissingBlock(ImmutableDBError):
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
    order. `chunk_size` is in slots (chunk number = slot // chunk_size).
    The keywords are the reference's; `repair` defaults to False."""

    def __init__(self, path: str, chunk_size: int = 21600,
                 check_integrity: Callable[[bytes], bool] | None = None,
                 validate_all: bool = False, fs=None,
                 check_integrity_batch=None, stream_deep: bool = False,
                 repair: bool = False, quarantine_dir: str | None = None,
                 stream_repair: bool = False):
        self.path = path
        self.chunk_size = chunk_size
        self.stream_deep = stream_deep
        self.stream_repair = stream_repair
        self._check_integrity_batch = check_integrity_batch
        self.fs = fs if fs is not None else REAL_FS
        if repair:
            # only a store that may write creates its directory: a
            # read-only open of a virgin path leaves nothing behind
            self.fs.makedirs(path)
        self._repair = repair
        self._quarantine = repair_mod.Quarantine(path, self.fs, quarantine_dir)
        self.repairs: list[dict] = []  # the repair rows of this open
        self._entries: dict[int, list[IndexEntry]] = {}
        self._chunks: list[int] = []
        self._truncated: dict[int, bool] = {}
        self._validate(check_integrity, validate_all)

    def prepare_write(self) -> None:
        """Adopt a read-only probe as the writer's store: create the
        directory and allow mutations from here on."""
        self.fs.makedirs(self.path)
        self._repair = True

    # -- the open's validation ------------------------------------------------

    def _chunk_numbers(self) -> list[int]:
        if not self.fs.isdir(self.path):
            return []
        return sorted(int(f.split(".")[0]) for f in self.fs.listdir(self.path)
                      if f.endswith(".chunk"))

    def _validate(self, check_integrity, validate_all: bool) -> None:
        """Load every index; deep-check the last chunk (every chunk under
        validate_all); cut the chain at the first bad block, dropping the
        chunks past it; then sweep the orphans."""
        chunks = self._chunk_numbers()
        for i, n in enumerate(chunks):
            deep = validate_all or i == len(chunks) - 1
            entries = self._load_chunk(n, deep, check_integrity)
            if entries is None:  # a wholly corrupt chunk: drop it and the rest
                for m in chunks[i:]:
                    self._repair_drop_chunk(
                        m, detail=("wholly corrupt chunk" if m == n
                                   else "stranded past a dropped chunk"))
                break
            self._entries[n] = entries
            self._chunks.append(n)
            if self._truncated.get(n):
                for m in chunks[i + 1:]:
                    self._repair_drop_chunk(m, detail="stranded past a truncated chunk")
                break
        live = set(self._chunks)
        names = self.fs.listdir(self.path) if self.fs.isdir(self.path) else ()
        for f in names:
            if f.endswith(".index") and int(f.split(".")[0]) not in live:
                q = self._quarantine_file(f) if self._repair else 0
                self._note_repair("sweep-orphan-index", int(f.split(".")[0]), qbytes=q,
                                  detail="index file without a chunk")
            elif f.endswith(".cols.tmp") or (
                    f.endswith(".cols") and int(f.split(".")[0]) not in live):
                # a sidecar tmp is never live (its rename died with a
                # crash mid-build); a sidecar whose chunk is gone has no
                # referent: both quarantined, never trusted
                q = self._quarantine_file(f) if self._repair else 0
                self._note_repair(
                    "sweep-orphan-sidecar", int(f.split(".")[0]), qbytes=q,
                    detail="sidecar without a chunk" if f.endswith(".cols")
                    else "sidecar tmp stranded by a crash mid-build")

    # -- the repair plane ------------------------------------------------------

    def _quarantine_file(self, name: str) -> int:
        """Move a live file into quarantine (a rename); QuarantineError
        before anything is destroyed when it cannot."""
        return self._quarantine.store_file(name, os.path.join(self.path, name))

    def _note_repair(self, action: str, chunk: int, kept: int = 0, dropped: int = 0,
                     qbytes: int = 0, detail: str = "") -> None:
        self.repairs.append(repair_mod.note_repair(
            action, chunk=chunk, kept=kept, dropped=dropped, bytes_quarantined=qbytes,
            applied=self._repair, detail=detail))

    def _repair_truncate(self, n: int, data: bytes, entries: list[IndexEntry],
                         dropped: int = 0, detail: str = "") -> None:
        """Cut chunk n's on-disk tail to `entries`: quarantine the snip,
        rewrite the chunk and its index (or, read-only, note it)."""
        end = entries[-1].offset + entries[-1].size if entries else 0
        q = max(0, len(data) - end)
        if self._repair:
            q = self._quarantine.store(chunk_name(n) + ".tail", data[end:])
            self._rewrite_chunk(n, data, entries)
        self._note_repair("truncate-chunk", n, kept=len(entries), dropped=dropped,
                          qbytes=q, detail=detail)

    def _repair_drop_chunk(self, n: int, detail: str = "") -> None:
        """Remove chunk n's files into quarantine."""
        if n in self._entries:
            dropped = len(self._entries[n])
        else:
            idx = self._load_index(os.path.join(self.path, index_name(n)))
            dropped = len(idx) if idx else 0
        q = 0
        if self._repair:
            for name in (chunk_name(n), index_name(n), sidecar_name(n)):
                if self.fs.exists(os.path.join(self.path, name)):
                    q += self._quarantine_file(name)
        self._note_repair("drop-chunk", n, kept=0, dropped=dropped, qbytes=q, detail=detail)

    def repair_to(self, n: int, good: int,
                  detail: str = "stream deep-validation write-back",
                  data: bytes | None = None) -> None:
        """The stream reader's write-back: cut chunk n on disk at `good`
        entries (the cut its deep read found) and drop every later
        chunk, as the deep open would have. `data`: the chunk's bytes
        when the reader holds them."""
        entries = self._entries.get(n, [])
        if data is None:
            try:
                data = self.fs.read_bytes(os.path.join(self.path, chunk_name(n)))
            except OSError:
                data = b""
        kept = entries[:good]
        self._truncated[n] = True
        self._repair_truncate(n, data, kept, dropped=len(entries) - len(kept), detail=detail)
        self._entries[n] = kept
        for m in [m for m in self._chunks if m > n]:
            self._repair_drop_chunk(m, detail="stranded past stream truncation")
            self._entries.pop(m, None)
            self._chunks.remove(m)

    def _load_chunk(self, n: int, deep: bool, check_integrity):
        ipath = os.path.join(self.path, index_name(n))
        cpath = os.path.join(self.path, chunk_name(n))
        entries = self._load_index(ipath)
        if entries is None:
            return self._reparse_chunk(n, check_integrity, why="index missing or corrupt")
        # the index can lag the chunk after a crash: rebuild it
        end = entries[-1].offset + entries[-1].size if entries else 0
        try:
            fsize = self.fs.getsize(cpath)
        except OSError:
            return None
        if fsize > end:
            return self._reparse_chunk(
                n, check_integrity, why=f"index lags chunk data ({fsize} > {end})")
        if deep:
            try:
                data = self.fs.read_bytes(cpath)
            except OSError:
                return None
            n_indexed = len(entries)
            good = self.deep_check_loaded(data, entries, check_integrity)
            if good < len(entries):
                self._truncated[n] = True
                entries = entries[:good]
                self._repair_truncate(
                    n, data, entries, dropped=n_indexed - len(entries),
                    detail="deep validation (CRC + integrity) found a corrupt tail")
        return entries

    def deep_check_loaded(self, data: bytes, entries: list[IndexEntry], check_integrity=None,
                          batch_hook=None) -> int:
        """The leading entries of a loaded chunk that pass, without
        touching the disk (the open's deep check and the stream reader's):
        the native CRC sweep, then, when an integrity check is asked for,
        the chunk-wide hook (`batch_hook`, else the open's) over the
        entries before the first CRC failure, in the per-block walk's
        order."""
        if not entries:
            return 0
        rc = native_scan.crc32_first_bad(
            data, [e.offset for e in entries], [e.size for e in entries],
            [e.crc32 for e in entries])
        good = len(entries) if rc < 0 else rc
        if check_integrity is None or good == 0:
            return good
        return min(good, (batch_hook or self._check_integrity_batch)(data, entries[:good]))

    def _reparse_chunk(self, n: int, check_integrity, why: str = ""):
        """Rebuild chunk n's index from its bytes (the blocks are
        self-delimiting CBOR), cutting at the first block that does not
        parse or fails `check_integrity`; the native item scan when no
        integrity check is asked for."""
        try:
            data = self.fs.read_bytes(os.path.join(self.path, chunk_name(n)))
        except OSError:
            return None
        if check_integrity is None:
            fast = self._reparse_chunk_native(n, data)
            if fast is not None:
                return self._finish_reparse(n, data, fast, why)
        from ..block.praos_block import Block

        entries: list[IndexEntry] = []
        off = 0
        while off < len(data):
            try:
                _, end = cbor.decode_prefix(data, off)
                blob = data[off:end]
                blk = Block.from_bytes(blob)
            except Exception:  # noqa: BLE001 — an unparseable block ends the chain
                self._truncated[n] = True
                break
            if check_integrity is not None and not check_integrity(blob):
                self._truncated[n] = True
                break
            entries.append(IndexEntry(blk.slot, blk.block_no, blk.hash_, off, len(blob),
                                      zlib.crc32(blob)))
            off = end
        return self._finish_reparse(n, data, entries, why)

    def _finish_reparse(self, n: int, data: bytes, entries: list[IndexEntry], why: str):
        """Note the rebuild and write it back (repair permitting); a torn
        tail found on the way is cut and quarantined too."""
        self._note_repair("rebuild-index", n, kept=len(entries), detail=why)
        if self._truncated.get(n):
            self._repair_truncate(
                n, data, entries,
                detail=f"unparseable/bad chunk tail ({why})" if why
                else "unparseable/bad chunk tail")
        elif self._repair:
            self._write_index(n, entries)
        return entries

    def _reparse_chunk_native(self, n: int, data: bytes) -> list[IndexEntry] | None:
        """The native rebuild: the item scan, the header columns and a
        Blake2b of each header; None when the items are not blocks of
        this layout (the per-block loop then decides)."""
        import hashlib

        offsets, sizes, end = native_scan.scan_items(data)
        try:
            cols = native_scan.extract_headers(data, offsets) if len(offsets) else None
        except ValueError:
            return None
        entries: list[IndexEntry] = []
        for i in range(len(offsets)):
            off, sz = int(offsets[i]), int(sizes[i])
            # the header's bytes: after the block's array head, through
            # the end of the KES signature
            h = hashlib.blake2b(data[off + 1: int(cols.header_end[i])], digest_size=32).digest()
            entries.append(IndexEntry(int(cols.slot[i]), int(cols.block_no[i]), h, off, sz,
                                      zlib.crc32(data[off: off + sz])))
        if end < len(data):
            self._truncated[n] = True
        return entries

    def _rewrite_chunk(self, n: int, data: bytes, entries: list[IndexEntry]) -> None:
        # the chunk's bytes change, so its sidecar's seal is a lie now
        self._invalidate_sidecar(n)
        end = entries[-1].offset + entries[-1].size if entries else 0
        self.fs.write_bytes(os.path.join(self.path, chunk_name(n)), data[:end])
        self._write_index(n, entries)

    def _invalidate_sidecar(self, n: int) -> int:
        """Move chunk n's sidecar into quarantine: every path that
        changes a chunk's bytes calls this first."""
        if self.fs.exists(os.path.join(self.path, sidecar_name(n))):
            return self._quarantine_file(sidecar_name(n))
        return 0

    def _remove_chunk(self, n: int) -> None:
        for name in (chunk_name(n), index_name(n), sidecar_name(n)):
            self.fs.remove(os.path.join(self.path, name))

    def _load_index(self, ipath: str) -> list[IndexEntry] | None:
        """The index's entries (one native parse) up to the first torn
        one or the first that does not tile the chunk from 0 with a
        plausible size; None when the file cannot be read."""
        try:
            data = self.fs.read_bytes(ipath)
        except OSError:
            return None
        slots, block_nos, hashes, offsets, sizes, crcs = native_scan.parse_index(data)
        starts = np.concatenate(([0], (offsets + sizes)[:-1]))
        bad = np.flatnonzero((offsets != starts) | (sizes <= 0) | (sizes > (1 << 40)))
        k = int(bad[0]) if bad.size else len(offsets)
        hb = hashes.tobytes()
        return [
            IndexEntry(s, b, hb[32 * i: 32 * i + 32], o, z, c)
            for i, (s, b, o, z, c) in enumerate(zip(
                slots[:k].tolist(), block_nos[:k].tolist(), offsets[:k].tolist(),
                sizes[:k].tolist(), crcs[:k].tolist()))
        ]

    def _write_index(self, n: int, entries: list[IndexEntry]) -> None:
        data = b"".join(cbor.encode(e.to_cbor_obj()) for e in entries)
        self.fs.write_atomic(os.path.join(self.path, index_name(n)), data)

    # -- queries ---------------------------------------------------------------

    @property
    def is_empty(self) -> bool:
        return not any(self._entries.values())

    def tip(self) -> IndexEntry | None:
        for n in reversed(self._chunks):
            if self._entries[n]:
                return self._entries[n][-1]
        return None

    def tip_point(self) -> Point | None:
        t = self.tip()
        return None if t is None else Point(t.slot, t.hash_)

    def n_blocks(self) -> int:
        return sum(len(v) for v in self._entries.values())

    # -- appending -------------------------------------------------------------

    def append_block(self, slot: int, block_no: int, hash_: bytes, raw: bytes) -> None:
        t = self.tip()
        if t is not None and slot <= t.slot:
            raise ImmutableDBError(f"append out of order: {slot} <= {t.slot}")
        self.fs.makedirs(self.path)
        n = slot // self.chunk_size
        if n not in self._entries:
            self._entries[n] = []
            self._chunks.append(n)
            self._chunks.sort()
        cpath = os.path.join(self.path, chunk_name(n))
        offset = self.fs.getsize(cpath) if self.fs.exists(cpath) else 0
        fault = chaos.write_fault(chunk=n)
        if fault == "torn-write":
            # a crash mid-append: half the block lands, no index entry
            self.fs.append(cpath, raw[: max(1, len(raw) // 2)])
            raise chaos.TornWriteChaos(f"chaos: append torn at chunk {n} slot {slot}")
        data = raw
        if fault == "bitflip":
            # silent bit rot: one byte flips on disk, the index keeps the
            # true CRC, so only a deep walk finds it
            buf = bytearray(raw)
            buf[len(buf) // 2] ^= 0x01
            data = bytes(buf)
        self.fs.append(cpath, data)
        if fault == "sigkill":
            import signal

            # a real kill between the chunk write and the index write
            os.kill(os.getpid(), signal.SIGKILL)
        e = IndexEntry(slot, block_no, hash_, offset, len(raw), zlib.crc32(raw))
        self._entries[n].append(e)
        enc = cbor.encode(e.to_cbor_obj())
        ipath = os.path.join(self.path, index_name(n))
        self.fs.append(ipath, enc)
        if fault == "index-truncate":
            size = self.fs.getsize(ipath)
            self.fs.truncate(ipath, max(0, size - max(1, len(enc) // 2)))
            raise chaos.IndexTornChaos(f"chaos: index torn at chunk {n} slot {slot}")

    def flush(self) -> None:
        """fsync the newest chunk and its index (clean shutdown)."""
        if not self._chunks:
            return
        n = self._chunks[-1]
        for name in (chunk_name(n), index_name(n)):
            p = os.path.join(self.path, name)
            if self.fs.exists(p):
                self.fs.fsync(p)

    # -- reading ---------------------------------------------------------------

    def chunk_entries(self) -> Iterator[tuple[int, list[IndexEntry]]]:
        """(chunk number, index entries) of every chunk that has
        entries, in slot order."""
        for n in self._chunks:
            if self._entries[n]:
                yield n, self._entries[n]

    def read_chunk(self, n: int) -> bytes:
        """Chunk n's bytes, in one read."""
        return self.fs.read_bytes(os.path.join(self.path, chunk_name(n)))

    def stream_all(self) -> Iterator[tuple[IndexEntry, bytes]]:
        """Every block in slot order, with its index entry."""
        for n, entries in self.chunk_entries():
            data = self.read_chunk(n)
            for e in entries:
                yield e, data[e.offset: e.offset + e.size]

    def get_block_bytes(self, point: Point) -> bytes:
        """The bytes of the block at `point`; MissingBlock if absent."""
        n = point.slot // self.chunk_size
        for e in self._entries.get(n, ()):
            if e.slot == point.slot and e.hash_ == point.hash_:
                return self.fs.read_at(os.path.join(self.path, chunk_name(n)), e.offset, e.size)
        raise MissingBlock(point)

    def iter_points(self) -> Iterator[Point]:
        """Every block's point in slot order, no block read (the plan
        ChainDB's ranged iterators walk)."""
        for _n, entries in self.chunk_entries():
            for e in entries:
                yield Point(e.slot, e.hash_)

    def stream_from(self, after_slot: int) -> Iterator[tuple[IndexEntry, bytes]]:
        """The blocks with slot > `after_slot`, in slot order, reading no
        chunk that ends at or before it (the replay from a snapshot,
        LedgerDB/Init.hs:116)."""
        for n, entries in self.chunk_entries():
            if entries[-1].slot <= after_slot:
                continue
            data = self.read_chunk(n)
            for e in entries:
                if e.slot > after_slot:
                    yield e, data[e.offset: e.offset + e.size]

    def stream_validated(self, decode, check) -> Iterator:
        """Yield decode(blob) for every block in slot order, stopping at
        the first block whose CRC mismatches its index entry, that does
        not decode, or for which `check(decoded)` is false: the per-block
        walk whose cut the chunk-wide checks reproduce."""
        for n, entries in self.chunk_entries():
            data = self.read_chunk(n)
            for e in entries:
                blob = data[e.offset: e.offset + e.size]
                if len(blob) != e.size or zlib.crc32(blob) != e.crc32:
                    return
                try:
                    item = decode(blob)
                except Exception:  # noqa: BLE001 — an undecodable block ends the chain
                    return
                if not check(item):
                    return
                yield item

    def truncate_after(self, point: Point | None) -> None:
        """db-truncater (Tools/DBTruncater/Run.hs): drop everything after
        `point` (None: everything)."""
        keep_through = -1 if point is None else point.slot
        for n in list(self._chunks):
            entries = [e for e in self._entries[n] if e.slot <= keep_through]
            if len(entries) != len(self._entries[n]):
                if entries:
                    data = self.fs.read_bytes(os.path.join(self.path, chunk_name(n)))
                    self._entries[n] = entries
                    self._rewrite_chunk(n, data, entries)
                else:
                    self._remove_chunk(n)
                    self._entries.pop(n, None)
                    self._chunks.remove(n)
