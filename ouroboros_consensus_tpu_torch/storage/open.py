"""The store's validation policies, the deep open with repair, and the
ChainDB's open.

Reference: the JAX package's storage/open.py (`escalate_policy`,
`open_repair_store`, `default_check_integrity(_batch)`, `open_chaindb`;
Node/Recovery.hs:24-59, Run.hs:133-143, and `ChainDB.openDB` via
`openChainDB`, diffusion Node.hs:568-580).

The policy is the `validate_all` value: True (`ValidateAllChunks`: every
chunk deep-checked at the open, corruption truncated on disk), False
(`ValidateMostRecentChunk`), or db_analyser's "stream" (the all-chunks
checks folded into the replay's own chunk reads).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .. import native, native_scan
from ..block.praos_block import Block
from ..ledger.extended import ExtLedger, ExtLedgerState
from .chaindb import ChainDB
from .immutable import ImmutableDB
from .ledgerdb import LedgerDB
from .volatile import VolatileDB

ValidateAllChunks = True
ValidateMostRecentChunk = False


def escalate_policy(policy, opened_dirty: bool):
    """Forced revalidation after a crash (Recovery.hs:24-59): a store
    that cannot prove a clean shutdown revalidates every chunk. False
    escalates to True; "stream" already checks every chunk and stays."""
    if opened_dirty and not policy:
        return ValidateAllChunks
    return policy


def open_repair_store(path: str, chunk_size: int = 21600, fs=None,
                      quarantine_dir: str | None = None,
                      repair: bool = True) -> ImmutableDB:
    """The deep open with on-disk repair: every chunk's CRCs and body
    hashes at the open, corrupted tails truncated and quarantined
    (the synthesizer's resume of a dirty store, db_truncater).
    ``repair=False`` is its read-only twin (a dry run): the same scan,
    the actions computed in memory only."""
    return ImmutableDB(
        os.path.join(path, "immutable"), chunk_size=chunk_size,
        check_integrity=default_check_integrity, validate_all=True,
        check_integrity_batch=default_check_integrity_batch,
        repair=repair, quarantine_dir=quarantine_dir, fs=fs,
    )


def default_check_integrity(raw: bytes) -> bool:
    """nodeCheckIntegrity (Node/InitStorage.hs:25): the block decodes and
    its body hash matches."""
    try:
        return Block.from_bytes(raw).check_integrity()
    except Exception:  # noqa: BLE001 — any decode failure means not intact
        return False


def default_check_integrity_batch(data: bytes, entries: list) -> int:
    """The integrity check of a chunk's blocks at once: the index of the
    first block that fails it (len(entries) when none does). One native
    header scan (a block that does not parse fails) and one Blake2b-256
    sweep over each block's [header end, block end) span against its
    body hash; a mismatch is settled by the per-block check, so that the
    chain ends where the per-block walk ends it."""
    offsets = np.asarray([e.offset for e in entries], np.int64)
    ends = offsets + np.asarray([e.size for e in entries], np.int64)
    limit = len(entries)
    try:
        cols = native_scan.extract_headers(data, offsets)
    except native_scan.MalformedBlock as exc:
        limit = exc.index
        if limit == 0:
            return 0
        cols = native_scan.extract_headers(data, offsets[:limit])
    digests = native.blake2b_spans(data, cols.header_end, ends[:limit])
    for i in np.flatnonzero((digests != cols.body_hash).any(axis=1)).tolist():
        if not default_check_integrity(data[offsets[i]: ends[i]]):
            return i
    return limit


def open_chaindb(
    path: str,
    ext: ExtLedger,
    genesis: ExtLedgerState,
    k: int,
    validate_all: bool = False,
    chunk_size: int = 21600,
    trace: Callable[[str], None] = lambda s: None,
    fs=None,
    check_in_future=None,
    decode_block=None,
    check_integrity=None,
    tracer=None,
) -> ChainDB:
    """openDB: the ImmutableDB (a writer's open: the most recent chunk
    checked, every chunk with `validate_all`, cuts written to disk), the
    VolatileDB (its files reparsed), the LedgerDB from the newest
    readable snapshot under ``<path>/ledger`` and a replay of the
    immutable blocks after it, then initial chain selection over the
    volatile blocks (ChainDB's constructor: a run of fresh blocks goes
    through the protocol's device batch when it has `use_device_batch`).
    `fs`: a MockFS runs the whole ChainDB in memory; `decode_block` and
    `check_integrity`: the block codec's seams (the Praos block's by
    default); `tracer`: the typed ChainDB events (utils/trace.py)."""
    check_integrity_batch = None
    if check_integrity is None and validate_all:
        check_integrity = default_check_integrity
        if decode_block is None:
            # the chunk-wide check parses the Praos block's layout only
            check_integrity_batch = default_check_integrity_batch
    imm = ImmutableDB(
        os.path.join(path, "immutable"), chunk_size=chunk_size,
        check_integrity=check_integrity if validate_all else None,
        validate_all=validate_all, fs=fs,
        check_integrity_batch=check_integrity_batch, repair=True,
    )
    vol = VolatileDB(os.path.join(path, "volatile"), fs=fs, decode_block=decode_block)
    snap_dir = os.path.join(path, "ledger")
    ldb = LedgerDB.init_from_snapshots(ext, k, snap_dir, genesis, imm, trace, fs=fs,
                                       decode_block=decode_block)
    return ChainDB(ext, imm, vol, ldb, k, snap_dir=snap_dir, trace=trace,
                   check_in_future=check_in_future, decode_block=decode_block,
                   tracer=tracer)
