"""The store's validation policies and the deep open with repair.

Reference: the JAX package's storage/open.py (`escalate_policy`,
`open_repair_store`, `default_check_integrity(_batch)`; Node/Recovery.hs
:24-59 and Run.hs:133-143). Its `open_chaindb` waits for the port's
ChainDB.

The policy is the `validate_all` value: True (`ValidateAllChunks`: every
chunk deep-checked at the open, corruption truncated on disk), False
(`ValidateMostRecentChunk`), or db_analyser's "stream" (the all-chunks
checks folded into the replay's own chunk reads).
"""

from __future__ import annotations

import os

import numpy as np

from .. import native, native_scan
from ..block.praos_block import Block
from .immutable import ImmutableDB

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
