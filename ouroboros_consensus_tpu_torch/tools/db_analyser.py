"""db-analyser's revalidation: stream a stored chain and validate it.

Reference: `Cardano.Tools.DBAnalyser` only-validation (Analysis.hs:75-88,
Run.hs:42-151): every chunk is validated as it is read (index tiling,
CRC and body hash per block — ValidateAllChunks, the chain ends at the
first block that fails), then the headers are revalidated from genesis,
one epoch segment at a time, cut into windows at `max_batch` and at a
proof-format switch:

  backend="device": the stage kernels on `device` (None -> the CUDA
                    card, raising when it is absent; "cpu" runs the plain
                    PyTorch versions and is what the tests pass). A window
                    of draft-03 (80-byte) proofs runs ed, kes, vrf_prep,
                    vrf_ladders and finish; a window of batch-compatible
                    (128-byte) proofs runs vrf_bc_prep in vrf_prep's place;
  backend="native": the C++ verifier (native/hostcrypto.cpp).

The read is columnar: each chunk takes one native CRC sweep, one native
header scan (native/headerscan.cpp) and one Blake2b sweep of the bodies,
and its headers become `ViewColumns` pieces, cut where a span width
changes; same-width pieces of an epoch merge into one segment. With
`columnar=False` the same scan yields one HeaderView list per chunk
instead (the per-header path the tests compare against).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from .. import native, native_scan
from ..block.praos_block import Block
from ..protocol import batch as pbatch
from ..protocol.praos import PraosParams, PraosState
from ..protocol.views import HeaderView, LedgerView, OCert, ViewColumns
from ..storage.immutable import ImmutableDB


@dataclass
class ValidationResult:
    n_blocks: int = 0  # blocks that passed storage validation
    n_valid: int = 0  # headers that passed protocol validation
    error: Exception | None = None
    final_state: PraosState | None = None
    wall_s: float = 0.0  # the whole call: the read, parse and validation
    validate_s: float = 0.0  # protocol validation (staging + kernels + epilogue)


def read_header_views(db_path: str) -> list:
    """Every header view of the chain, in slot order, up to the first
    block that fails storage validation: the per-block walk (a CBOR
    decode and a body hash a block)."""
    imm = ImmutableDB(os.path.join(db_path, "immutable"))
    blocks = imm.stream_validated(Block.from_bytes, Block.check_integrity)
    return [b.header.to_view() for b in blocks]


def _block_intact(raw: bytes) -> bool:
    """The per-block integrity check: the block decodes and its body
    hash matches."""
    try:
        return Block.from_bytes(raw).check_integrity()
    except Exception:  # noqa: BLE001 — any decode failure means not intact
        return False


def check_integrity_batch(data: bytes, entries: list) -> int:
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
        if not _block_intact(data[offsets[i]: ends[i]]):
            return i
    return limit


def _views_from_columns(cols) -> list:
    """A chunk scan as HeaderViews (no CBOR decode); the span lists when
    the chunk's spans differ in width."""
    vc = ViewColumns.from_header_columns(cols)
    if vc is not None:
        return vc.views()
    prev, cold, vrf_vk, out, proof, vk_hot = (a.tobytes() for a in (
        cols.prev_hash, cols.issuer_vk, cols.vrf_vk, cols.vrf_output,
        cols.vrf_proof, cols.ocert_vk))
    return [
        HeaderView(
            prev_hash=prev[32 * i: 32 * i + 32] if has else None,
            vk_cold=cold[32 * i: 32 * i + 32], vrf_vk=vrf_vk[32 * i: 32 * i + 32],
            vrf_output=out[64 * i: 64 * i + 64],
            vrf_proof=proof[128 * i: 128 * i + plen],
            ocert=OCert(vk_hot[32 * i: 32 * i + 32], counter, period, cols.ocert_sigma[i]),
            slot=slot, signed_bytes=cols.signed_bytes[i], kes_sig=cols.kes_sig[i],
        )
        for i, (has, plen, counter, period, slot) in enumerate(zip(
            cols.has_prev.tolist(), cols.vrf_proof_len.tolist(),
            cols.ocert_counter.tolist(), cols.ocert_kes_period.tolist(),
            cols.slot.tolist()))
    ]


def _stream_windows(imm: ImmutableDB, res: ValidationResult, columnar: bool = True):
    """The chain's headers chunk by chunk, in slot order: each chunk's
    blocks checked (`ImmutableDB.deep_check` with check_integrity_batch),
    the good prefix scanned natively, and yielded as ViewColumns pieces
    (`columnar`; a chunk whose sigmas do not columnarize falls to a
    list) or as one HeaderView list. The stream ends with the first
    chunk that holds a failing block."""
    for data, entries in imm.chunks():
        good = imm.deep_check(data, entries, check_integrity_batch)
        if good:
            cols = native_scan.extract_headers(data, [e.offset for e in entries[:good]])
            res.n_blocks += cols.n
            pieces = ViewColumns.pieces_from_header_columns(cols) if columnar else None
            if pieces is None:
                yield _views_from_columns(cols)
            else:
                yield from pieces
        if good < len(entries):
            return


def _epoch_window_segments(params: PraosParams, wins):
    """Cut a stream of chunk windows at epoch boundaries and merge what
    falls in one epoch: consecutive ViewColumns pieces of one width into
    one segment (a width step inside an epoch gives separate segments,
    and validate_chain threads the state across them); a list piece is
    a segment of its own."""

    def pieces():
        for win in wins:
            if isinstance(win, ViewColumns):
                epochs = win.slot // params.epoch_length
                bounds = [0, *(np.flatnonzero(np.diff(epochs)) + 1).tolist(), len(win)]
                for lo, hi in zip(bounds[:-1], bounds[1:]):
                    yield int(epochs[lo]), win[lo:hi]
            else:
                seg: list = []
                e = None
                for hv in win:
                    he = params.epoch_of(hv.slot)
                    if seg and he != e:
                        yield e, seg
                        seg = []
                    seg.append(hv)
                    e = he
                if seg:
                    yield e, seg

    def flush(parts):
        group: list = []
        width = None
        for p in parts:
            if isinstance(p, ViewColumns):
                w = (p.signed_bytes.shape[1], p.kes_sig.shape[1])
                if group and w == width:
                    group.append(p)
                    continue
                if group:
                    yield ViewColumns.concat(group)
                group, width = [p], w
            else:
                if group:
                    yield ViewColumns.concat(group)
                    group, width = [], None
                yield p
        if group:
            yield ViewColumns.concat(group)

    acc: list = []
    epoch = None
    for e, piece in pieces():
        if acc and e != epoch:
            yield from flush(acc)
            acc = []
        acc.append(piece)
        epoch = e
    if acc:
        yield from flush(acc)


def revalidate(db_path: str, params: PraosParams, lview: LedgerView,
               backend: str = "device", max_batch: int = 8192,
               device=None, columnar: bool = True) -> ValidationResult:
    """Full-chain revalidation from genesis against a constant ledger
    view; -> n_valid, the first error (or None) and the final state.
    `validate_s` sums the validate_chain calls (one an epoch segment);
    `wall_s` holds the read too."""
    if backend not in ("device", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "device":
        from ..device import resolve

        device = resolve(device)
    res = ValidationResult()
    t0 = time.monotonic()
    st = PraosState()
    imm = ImmutableDB(os.path.join(db_path, "immutable"))
    for seg in _epoch_window_segments(params, _stream_windows(imm, res, columnar)):
        ts = time.monotonic()
        out = pbatch.validate_chain(params, lambda _e: lview, st, seg,
                                    max_batch=max_batch, backend=backend,
                                    device=device)
        res.validate_s += time.monotonic() - ts
        st = out.state
        res.n_valid += out.n_valid
        if out.error is not None:
            res.error = out.error
            break
    res.final_state = st
    res.wall_s = time.monotonic() - t0
    return res
