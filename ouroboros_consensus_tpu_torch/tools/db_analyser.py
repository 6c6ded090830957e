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

The read is columnar, in the reference's tiers (its `_stream_windows`).
Tier 1: a chunk whose sidecar (`NNNNN.cols`, storage/sidecar.py) is a
`hit` becomes `ViewColumns` pieces of the mapped columns, with no header
scan; a walked seal runs only the body-hash compare from its sealed
columns, an unwalked one the native CRC sweep first. A hit whose checks
stop short of the chunk's end takes the exact tier 2 check, without the
sidecar. Tier 2 (no sidecar, a stale or torn one, or `sidecar=False`):
one native CRC sweep, one native header scan (native/headerscan.cpp)
and one Blake2b sweep of the bodies, then a second scan of the good
prefix into pieces, cut where a span width changes. Same-width pieces
of an epoch merge into one segment. With `columnar=False` the scan
yields one HeaderView list per chunk instead (the per-header path the
tests compare against), and no sidecar is read. A replay never writes a
sidecar: the forge seals them. That read is `validate_all="stream"`;
False checks only the most recent chunk (its CRCs), as the reference's
shallow open; the reference's True, a repair open that writes
truncations to disk, raises until the port has a repair plane.
`max_headers` caps the read, `collect_phases` fills the result's phase
walls, bytes and windows, and `trace` reports progress (bench.py's
replay keywords).

On the device backend the read runs on a prefetch thread
(`_prefetch_iter`) that reads the next epoch segment while
`validate_chain` validates this one, whose window pipeline
(`pipeline_depth`) stages windows on a thread of its own ahead of the
card.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from .. import native, native_scan
from ..block.praos_block import Block
from ..protocol import batch as pbatch
from ..protocol.praos import PraosParams, PraosState
from ..protocol.views import HeaderView, LedgerView, OCert, ViewColumns
from ..storage import sidecar as sidecar_mod
from ..storage.immutable import ImmutableDB


@dataclass
class ValidationResult:
    n_blocks: int = 0  # blocks that passed storage validation
    n_valid: int = 0  # headers that passed protocol validation
    error: Exception | None = None
    final_state: PraosState | None = None
    wall_s: float = 0.0  # the whole call: the read, parse and validation
    validate_s: float = 0.0  # protocol validation (staging + kernels + epilogue)
    # the read's own time (the index parse, chunk reads, checks, pieces,
    # epoch merge), on the thread that reads: overlaps validate_s when
    # prefetching
    read_s: float = 0.0
    # the time validation waited for the next segment: on the prefetch
    # queue, or the read itself when it runs inline
    wait_s: float = 0.0
    # the store's open (every chunk's index loaded), inside read_s
    open_s: float = 0.0
    # filled by collect_phases=True (batch.PhaseTally): wall s per phase
    # (the read, and the window loop's stage, dispatch, materialize and
    # epilogue), bytes copied to the card and back, windows dispatched
    phases: dict | None = None
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    n_windows: int = 0
    packed_windows: int = 0


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


def _chunk_good(imm: ImmutableDB, n: int, data: bytes, entries: list, use_sidecar: bool):
    """One chunk's checks, in the reference's tiers -> (good, sc): the
    number of leading entries that pass, and the chunk's sidecar columns
    when it is a hit and every entry passed (else None)."""
    sc = None
    if use_sidecar:
        sc, outcome = sidecar_mod.load_sidecar(imm.path, n, data, len(entries))
        sidecar_mod.record(outcome)
    if sc is None:
        return imm.deep_check(data, entries, check_integrity_batch), None
    hook = sidecar_mod.integrity_batch_hook(sc)
    # a walked seal: the chunk CRC shows these are the walked bytes, so
    # only the body-hash compare runs; an unwalked one pays the CRC sweep
    good = hook(data, entries) if sc.walked else imm.deep_check(data, entries, hook)
    if good < len(entries):
        # an anomaly: the exact scan decides where the chain ends
        return imm.deep_check(data, entries, check_integrity_batch), None
    return good, sc


def _chunk_shallow(imm: ImmutableDB, n: int, data: bytes, entries: list, use_sidecar: bool,
                   last: bool):
    """One chunk of a shallow read (validate_all=False), as the
    reference's open checks it: the most recent chunk by the CRC sweep
    alone, the others not at all -> (good, sc) as `_chunk_good`'s."""
    good = len(entries)
    if last:
        rc = native_scan.crc32_first_bad(
            data, [e.offset for e in entries], [e.size for e in entries],
            [e.crc32 for e in entries])
        good = good if rc < 0 else rc
    sc = None
    if use_sidecar and good == len(entries):
        sc, outcome = sidecar_mod.load_sidecar(imm.path, n, data, len(entries))
        sidecar_mod.record(outcome)
    return good, sc


def _stream_windows(imm: ImmutableDB, res: ValidationResult, columnar: bool = True,
                    sidecar: bool = True, deep: bool = True):
    """The chain's headers chunk by chunk, in slot order, each chunk
    checked by `_chunk_good` (`deep`, validate_all="stream"), or by
    `_chunk_shallow`: a sidecar hit yields its pieces (tier 1),
    else the good prefix is scanned natively and yielded as ViewColumns
    pieces (`columnar`; a chunk whose sigmas do not columnarize falls to
    a list) or as one HeaderView list. The stream ends with the first
    chunk that holds a failing block."""
    use_sidecar = sidecar and columnar
    last = imm._chunks[-1] if imm._chunks else None
    for n, entries in imm.chunk_entries():
        data = imm.read_chunk(n)
        if deep:
            good, sc = _chunk_good(imm, n, data, entries, use_sidecar)
        else:
            good, sc = _chunk_shallow(imm, n, data, entries, use_sidecar, n == last)
        pieces = sc.pieces(data) if sc is not None else None
        if pieces is not None:
            res.n_blocks += sc.n
            yield from pieces
        elif good:
            cols = native_scan.extract_headers(data, [e.offset for e in entries[:good]])
            res.n_blocks += cols.n
            pieces = ViewColumns.pieces_from_header_columns(cols) if columnar else None
            if pieces is None:
                yield _views_from_columns(cols)
            else:
                yield from pieces
        if good < len(entries):
            return


def _cap_windows(wins, cap: int):
    """The window stream cut to its first `cap` headers (the reference's
    `_cap_windows`, tools/db_analyser.py:433)."""
    left = cap
    for win in wins:
        if left <= 0:
            return
        if len(win) > left:
            yield win[:left]
            return
        left -= len(win)
        yield win


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


def _prefetch_iter(gen, depth: int = 2):
    """Pull `gen` on a thread of its own through a queue of `depth`
    items, so that the next items are read while this one is consumed.
    An exception raised by `gen` is raised to the consumer in its place;
    when the consumer stops early (the first failing header), the thread
    stops at its next item and is joined, without blocking on the full
    queue."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        try:
            for item in gen:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — raised again to the consumer
            put(e)
        finally:
            gen.close()

    t = threading.Thread(target=pump, name="revalidate-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def _timed_segments(params: PraosParams, db_path: str, tally: ValidationResult,
                    columnar: bool, sidecar: bool, deep: bool, max_headers: int | None):
    """The epoch segments of the chain at `db_path` (its first
    `max_headers` headers, when given), each with the blocks read so far
    (the storage prefix when the consumer stops after it), the time spent
    producing them (the index parse of the open included) summed into
    `tally.read_s`, the open's alone into `tally.open_s`."""
    t0 = time.perf_counter()
    imm = ImmutableDB(os.path.join(db_path, "immutable"))
    tally.open_s = time.perf_counter() - t0
    wins = _stream_windows(imm, tally, columnar, sidecar, deep)
    if max_headers is not None:
        wins = _cap_windows(wins, max_headers)
    segs = _epoch_window_segments(params, wins)
    while True:
        seg = next(segs, None)
        tally.read_s += time.perf_counter() - t0
        if seg is None:
            return
        yield seg, tally.n_blocks
        t0 = time.perf_counter()


def revalidate(db_path: str, params: PraosParams, lview: LedgerView,
               backend: str = "device", max_batch: int = 8192,
               device=None, columnar: bool = True, sidecar: bool = True,
               prefetch: bool = True, pipeline_depth: int = 3,
               aggregate: bool = True, validate_all="stream",
               max_headers: int | None = None, trace=lambda s: None,
               collect_phases: bool = False) -> ValidationResult:
    """Full-chain revalidation from genesis against a constant ledger
    view; -> n_valid, the first error (or None) and the final state.
    `validate_all` (the reference's, tools/db_analyser.py:577-606):
    "stream" checks every chunk inside the replay's own reads (CRCs and
    body hashes, the reference's ValidateAllChunks verdicts and
    truncation points); False checks only the most recent chunk, by its
    CRCs, as the reference's shallow open does; True, the reference's
    default, opens the store for repair (truncations written to disk),
    which the port does not have yet: it raises. `max_headers`: replay
    the first max_headers headers only (`n_blocks` is at most that).
    `trace`: called with a progress line after each epoch segment.
    `collect_phases`: fill `phases`, `h2d_bytes`, `d2h_bytes`,
    `n_windows` and `packed_windows` (batch.PhaseTally).
    `sidecar`: read a chunk's sealed columns where they hold (tier 1;
    `columnar=False` reads none). `prefetch` (device backend): read the
    next epoch segment on a thread while this one validates.
    `pipeline_depth`: windows staged ahead and in flight in each
    validate_chain (1 is the serial loop). `aggregate` (device backend):
    batch-compatible packed windows through the window aggregate, a
    dirty one through the per-lane stages again (validate_chain's).
    Read-only: it writes nothing
    to disk. `validate_s` sums the validate_chain calls (one an epoch
    segment), `read_s` the read's own time (`open_s` of it the store's
    open, every index loaded), `wait_s` the time validation waited for
    it, and `wall_s` is the whole call."""
    if backend not in ("device", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if validate_all is True:
        raise ValueError(
            "validate_all=True opens the store for repair (ValidateAllChunks with "
            "on-disk truncation) and the port has no repair plane yet; pass "
            "validate_all='stream' (every chunk checked in the replay's reads) or False")
    if validate_all not in ("stream", False):
        raise ValueError(f"unknown validate_all {validate_all!r}")
    if backend == "device":
        from ..device import resolve

        device = resolve(device)
    res = ValidationResult()
    t0 = time.monotonic()
    st = PraosState()
    tally = ValidationResult()  # the reader's counts, on the reader's thread
    segs = _timed_segments(params, db_path, tally, columnar, sidecar,
                           validate_all == "stream", max_headers)
    if backend == "device" and prefetch:
        segs = _prefetch_iter(segs, depth=2)
    phases = pbatch.PhaseTally() if collect_phases else None
    try:
        while True:
            tw = time.perf_counter()
            item = next(segs, None)
            res.wait_s += time.perf_counter() - tw
            if item is None:
                break
            seg, res.n_blocks = item
            ts = time.monotonic()
            out = pbatch.validate_chain(params, lambda _e: lview, st, seg,
                                        max_batch=max_batch, backend=backend,
                                        device=device, pipeline_depth=pipeline_depth,
                                        aggregate=aggregate, phases=phases)
            res.validate_s += time.monotonic() - ts
            st = out.state
            res.n_valid += out.n_valid
            if out.error is not None:
                res.error = out.error
                break
            trace(f"validated {res.n_valid} headers")
    finally:
        segs.close()  # stops and joins the prefetch thread
    if res.error is None:
        res.n_blocks = tally.n_blocks
    if max_headers is not None:
        res.n_blocks = min(res.n_blocks, max_headers)
    res.read_s, res.open_s = tally.read_s, tally.open_s
    if phases is not None:
        res.phases = {"read": tally.read_s, **phases.wall}
        res.h2d_bytes, res.d2h_bytes = phases.h2d_bytes, phases.d2h_bytes
        res.n_windows, res.packed_windows = phases.windows, phases.packed_windows
    res.final_state = st
    res.wall_s = time.monotonic() - t0
    return res
