"""db-analyser's revalidation: stream a stored chain and validate it.

Reference: `Cardano.Tools.DBAnalyser` only-validation (Analysis.hs:75-88,
Run.hs:42-151); the JAX package's tools/db_analyser.py is the port's
reference. The store is opened under its crash protocol
(storage/guard.py: lock, chain magic, clean-shutdown marker), every
chunk is validated (index tiling, CRC and body hash per block), and the
headers are revalidated from genesis, one epoch segment at a time, cut
into windows at `max_batch` and at a proof-format switch:

  backend="device": the stage kernels on `device` (None -> the CUDA
                    card, raising when it is absent; "cpu" runs the plain
                    PyTorch versions and is what the tests pass). A window
                    of draft-03 (80-byte) proofs runs ed, kes, vrf_prep,
                    vrf_ladders and finish; a window of batch-compatible
                    (128-byte) proofs runs vrf_bc_prep in vrf_prep's place;
  backend="native": the C++ verifier (native/hostcrypto.cpp).

`validate_all` is the reference's validation policy. True (its default,
`ValidateAllChunks`) opens the store as a writer and deep-checks every
chunk at the open, writing the cut at the first bad block to disk (the
snipped bytes quarantined; storage/immutable.py). "stream" runs the same
checks inside the replay's own chunk reads and is read-only unless
`repair` (then the cut it finds is written back). False checks the most
recent chunk's CRCs at the open. An open that finds no clean-shutdown
marker (the last writer died) escalates to all chunks with repair.

The read is columnar, in the reference's tiers (its `_stream_windows`).
Tier 1: a chunk whose sidecar (`NNNNN.cols`, storage/sidecar.py) is a
`hit` becomes `ViewColumns` pieces of the mapped columns, with no header
scan; in "stream" a walked seal runs only the body-hash compare from its
sealed columns, an unwalked one the native CRC sweep first, and a hit
whose checks stop short of the chunk's end takes the exact tier 2 check,
without the sidecar. Tier 2 (no sidecar, a stale or torn one, or
`sidecar=False`): one native header scan of the good prefix into pieces,
cut where a span width changes (after, in "stream", one native CRC
sweep, one header scan and one Blake2b sweep of the bodies). A writer
open seals the sidecar of each chunk it scanned. Same-width pieces of an
epoch merge into one segment. With `columnar=False` the scan yields one
HeaderView list per chunk instead, and no sidecar is read.

The self-healing replay (obs/recovery.py): a window that fails with a
RECOVER-class error is validated again by the supervisor's ladder
(`recovery`, `backoff_s`); a chunk read that fails is read once more;
`checkpoint` keeps a progress record as windows retire and `resume`
starts from it. `chaos` arms a fault plan (testing/chaos.py) for the
call. `max_headers` caps the read, `collect_phases` fills the result's
phase walls, bytes and windows, and `trace` reports progress (bench.py's
replay keywords).

On the device backend the read runs on a prefetch thread
(`_prefetch_iter`) that reads the next epoch segment while
`validate_chain` validates this one, whose window pipeline
(`pipeline_depth`) stages windows on a thread of its own ahead of the
card.

`main` is the reference's CLI (only-validation): `python -m
ouroboros_consensus_tpu_torch.tools.db_analyser --db DB`, or with
`--cardano` a mixed-era composite chain (hardfork/composite.py).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .. import native_scan
from ..block.praos_block import Block
from ..obs import recovery as recovery_mod
from ..protocol import batch as pbatch
from ..protocol.praos import PraosParams, PraosState
from ..protocol.views import HeaderView, LedgerView, OCert, ViewColumns
from ..storage import guard as guard_mod
from ..storage import open as open_mod
from ..storage import repair as repair_mod
from ..storage import sidecar as sidecar_mod
from ..storage.immutable import ImmutableDB
from ..testing import chaos as chaos_mod


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
    resumed_headers: int = 0  # headers a checkpoint vouched for (in n_valid)
    opened_dirty: bool = False  # no clean-shutdown marker: escalated open
    repairs: dict | None = None  # {action: count} of the repairs applied
    # the supervisor's RecoveryEvents (obs/recovery.py), in order
    recoveries: list = field(default_factory=list)


def read_header_views(db_path: str) -> list:
    """Every header view of the chain, in slot order, up to the first
    block that fails storage validation: the per-block walk (a CBOR
    decode and a body hash a block). Read-only."""
    imm = ImmutableDB(os.path.join(db_path, "immutable"))
    blocks = imm.stream_validated(Block.from_bytes, Block.check_integrity)
    return [b.header.to_view() for b in blocks]


def open_immutable(db_path: str, validate_all=True, repair: bool = False) -> ImmutableDB:
    """The store under a policy (the reference's open_immutable): True
    deep-checks every chunk at the open and writes its cuts (a writer's
    open); "stream" defers the same checks to the reader, read-only
    unless `repair` (then the reader writes back the cut it finds,
    `ImmutableDB.repair_to`); False checks the most recent chunk's CRCs.
    Only a deep open or `repair` may write."""
    stream = validate_all == "stream"
    deep = bool(validate_all) and not stream
    return ImmutableDB(
        os.path.join(db_path, "immutable"),
        check_integrity=open_mod.default_check_integrity if deep else None,
        validate_all=deep,
        check_integrity_batch=open_mod.default_check_integrity_batch if deep else None,
        repair=deep or bool(repair), stream_deep=stream,
        stream_repair=stream and bool(repair),
    )


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
    """One chunk's checks in "stream", in the reference's tiers ->
    (good, sc): the number of leading entries that pass, and the chunk's
    sidecar columns when it is a hit and every entry passed (else None)."""
    sc = None
    if use_sidecar:
        sc, outcome = sidecar_mod.load_sidecar(imm.path, n, data, len(entries), fs=imm.fs)
        sidecar_mod.record(outcome)
    def exact():
        return imm.deep_check_loaded(data, entries, open_mod.default_check_integrity,
                                     open_mod.default_check_integrity_batch)

    if sc is None:
        return exact(), None
    hook = sidecar_mod.integrity_batch_hook(sc)
    # a walked seal: the chunk CRC shows these are the walked bytes, so
    # only the body-hash compare runs; an unwalked one pays the CRC sweep
    good = (hook(data, entries) if sc.walked else
            imm.deep_check_loaded(data, entries, open_mod.default_check_integrity, hook))
    if good < len(entries):
        return exact(), None  # an anomaly: the exact scan decides where the chain ends
    return good, sc


def _read_chunk(imm: ImmutableDB, n: int, chunk_idx: int, sup) -> bytes:
    """Chunk n's bytes behind the chaos ``chunk`` seam
    (chunk-corrupt@epoch:N, N the chunk's place in the store), with one
    re-read by the supervisor when the read fails with a RECOVER-class
    error; a second failure propagates (the reference's _read_chunk)."""
    try:
        chaos_mod.fire("chunk", chunk=chunk_idx)
        return imm.read_chunk(n)
    except (chaos_mod.ChaosError, OSError) as e:
        return sup.reread_chunk(lambda: imm.read_chunk(n), chunk_idx, e)


def _stream_windows(imm: ImmutableDB, res: ValidationResult, columnar: bool, sidecar: bool,
                    sup):
    """The chain's headers chunk by chunk, in slot order. In "stream"
    (`imm.stream_deep`) each chunk is checked by `_chunk_good`, and a
    repairing reader (`imm.stream_repair`) writes back the cut it finds;
    otherwise the open validated the chunks already. A sidecar hit
    yields its pieces (tier 1); else the good prefix is scanned natively
    and yielded as ViewColumns pieces (`columnar`; a chunk whose sigmas
    do not columnarize falls to a list) or as one HeaderView list, and a
    writer's open seals the chunk's sidecar from that scan (walked when
    this read checked the chunk). The stream ends with the first chunk
    that holds a failing block."""
    use_sidecar = sidecar and columnar
    for chunk_idx, n in enumerate(list(imm._chunks)):
        entries = imm._entries.get(n)
        if not entries:
            continue
        data = _read_chunk(imm, n, chunk_idx, sup)
        if imm.stream_deep:
            good, sc = _chunk_good(imm, n, data, entries, use_sidecar)
        else:
            good, sc = len(entries), None
            if use_sidecar:
                sc, outcome = sidecar_mod.load_sidecar(imm.path, n, data, len(entries),
                                                       fs=imm.fs)
                sidecar_mod.record(outcome)
        truncated = good < len(entries)
        if truncated and imm.stream_repair:
            imm.repair_to(n, good, data=data)
        pieces = sc.pieces(data) if sc is not None else None
        if pieces is not None:
            res.n_blocks += sc.n
            yield from pieces
        elif good:
            cols = native_scan.extract_headers(data, [e.offset for e in entries[:good]])
            res.n_blocks += cols.n
            if use_sidecar and sc is None and not truncated and imm._repair:
                if sidecar_mod.backfill(imm.path, n, cols, data, walked=imm.stream_deep,
                                        fs=imm.fs):
                    sidecar_mod.record("rebuilt")
            pieces = ViewColumns.pieces_from_header_columns(cols) if columnar else None
            if pieces is None:
                yield _views_from_columns(cols)
            else:
                yield from pieces
        if truncated:
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


def _skip_headers(wins, n: int):
    """The window stream without its first `n` headers (a resume: the
    record vouches for them); ViewColumns windows are sliced, so the
    stream stays columnar across the resume point."""
    left = n
    for win in wins:
        if left <= 0:
            yield win
        elif len(win) <= left:
            left -= len(win)
        else:
            yield win[left:]
            left = 0


def _timed_segments(params: PraosParams, imm: ImmutableDB, tally: ValidationResult,
                    columnar: bool, sidecar: bool, max_headers: int | None, skip: int,
                    sup):
    """The epoch segments of the opened store (its first `max_headers`
    headers, when given, less the first `skip`), each with the blocks
    read so far (the storage prefix when the consumer stops after it),
    the time spent producing them summed into `tally.read_s`."""
    t0 = time.perf_counter()
    wins = _stream_windows(imm, tally, columnar, sidecar, sup)
    if max_headers is not None:
        wins = _cap_windows(wins, max_headers)
    if skip:
        wins = _skip_headers(wins, skip)
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
               aggregate: bool = True, validate_all=True,
               max_headers: int | None = None, trace=lambda s: None,
               collect_phases: bool = False, resume: bool = False,
               repair: bool = False, network_magic: int | None = None,
               checkpoint: str | None = None, recovery: bool = True,
               backoff_s: float = 0.05, chaos=None) -> ValidationResult:
    """Full-chain revalidation from genesis (or from a checkpoint)
    against a constant ledger view; -> n_valid, the first error (or
    None) and the final state.
    `validate_all` (the reference's, tools/db_analyser.py:577-606): True
    (the default) opens the store as a writer and deep-checks every
    chunk at the open, cutting the chain on disk at the first bad block
    (quarantined, `repairs` counts the actions); "stream" runs the same
    checks in the replay's own reads, read-only unless `repair` (then the
    cut is written back); False checks only the most recent chunk's
    CRCs. The open takes the store's lock (DbLocked when another process
    holds it), checks its chain magic against `network_magic` (None
    accepts any; DbMarkerMismatch), and, when the clean-shutdown marker
    is missing, escalates to all chunks with repair (`opened_dirty`). A
    writer's open of a path with no store raises FileNotFoundError. The
    store is closed clean only after a walk that proved all of it.
    `max_headers`: replay the first max_headers headers only (`n_blocks`
    is at most that). `trace`: called with a progress line after each
    epoch segment. `collect_phases`: fill `phases`, `h2d_bytes`,
    `d2h_bytes`, `n_windows` and `packed_windows` (batch.PhaseTally).
    `sidecar`: read a chunk's sealed columns where they hold (tier 1;
    `columnar=False` reads none). `prefetch` (device backend): read the
    next epoch segment on a thread while this one validates.
    `pipeline_depth`: windows staged ahead and in flight in each
    validate_chain (1 is the serial loop). `aggregate` (device backend):
    batch-compatible packed windows through the window aggregate, a
    dirty one through the per-lane stages again (validate_chain's).
    `recovery`: a window that fails with a RECOVER-class error goes down
    the supervisor's ladder (obs/recovery.py; False raises it), after a
    retry backoff of `backoff_s` (jittered); the events land on
    `recoveries`. `checkpoint`: a path where the progress record is
    rewritten as each window retires; with `resume`, a record of this
    chain there seeds the fold and its headers are skipped
    (`resumed_headers`, counted in `n_valid`). `chaos`: a fault plan
    (testing/chaos.py spec or ChaosPlan) armed for the call.
    `validate_s` sums the validate_chain calls (one an epoch segment),
    `read_s` the read's own time (`open_s` of it the store's open),
    `wait_s` the time validation waited for it, and `wall_s` is the
    whole call."""
    if backend not in ("device", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if validate_all not in ("stream", False, True):
        raise ValueError(f"unknown validate_all {validate_all!r}")
    if resume and checkpoint is None:
        raise ValueError("resume needs the checkpoint path")
    if backend == "device":
        from ..device import resolve

        device = resolve(device)
    with chaos_mod.arming(chaos):
        return _revalidate_guarded(
            db_path, params, lview, backend, max_batch, device, columnar, sidecar, prefetch,
            pipeline_depth, aggregate, validate_all, max_headers, trace, collect_phases,
            resume, repair, network_magic, checkpoint,
            recovery_mod.RecoverySupervisor(backoff_s, enabled=recovery))


def _revalidate_guarded(db_path, params, lview, backend, max_batch, device, columnar,
                        sidecar, prefetch, pipeline_depth, aggregate, policy, max_headers,
                        trace, collect_phases, resume, repair, network_magic, checkpoint,
                        sup) -> ValidationResult:
    """The store's crash protocol around the replay (the reference's
    _revalidate_impl): the guard is a writer iff the open may write
    (True, or `repair`); a dirty open escalates the policy, takes the
    writer's half and forces repair; an exception leaves the store
    dirty, and a replay closes it clean only when its walk proved the
    whole store (a deep open, or an uncapped stream that reached its end
    without a validation error) or when it was clean already."""
    t0 = time.monotonic()
    guard = guard_mod.StoreGuard(db_path, network_magic=network_magic,
                                 writer=bool(repair) or policy is True)
    if guard.writer and not os.path.exists(os.path.join(db_path, "immutable")):
        raise FileNotFoundError(f"no store at {db_path} (refusing to create one)")
    guard.open()
    try:
        if guard.opened_dirty:
            policy = open_mod.escalate_policy(policy, True)
            guard.promote_writer()
            repair = True
        imm = open_immutable(db_path, validate_all=policy, repair=repair)
        res = _replay(imm, db_path, params, lview, backend, max_batch, device, columnar,
                      sidecar, prefetch, pipeline_depth, aggregate, max_headers, trace,
                      collect_phases, resume, checkpoint, sup, time.monotonic() - t0)
        res.opened_dirty = guard.opened_dirty
        counts: dict = {"dirty-open-escalated": 1} if guard.opened_dirty else {}
        counts.update(repair_mod.count_actions(imm.repairs))
        res.repairs = counts or None
    except BaseException:
        guard.close(clean=False)
        raise
    full_walk = policy is True or (policy == "stream" and max_headers is None
                                   and res.error is None)
    guard.close(clean=full_walk or not res.opened_dirty)
    res.wall_s = time.monotonic() - t0
    return res


def _replay(imm, db_path, params, lview, backend, max_batch, device, columnar, sidecar,
            prefetch, pipeline_depth, aggregate, max_headers, trace, collect_phases, resume,
            checkpoint, sup, open_s: float) -> ValidationResult:
    """The replay of an opened store, from genesis or from a checkpoint;
    the open's time counts in `read_s`, as the reader's."""
    res = ValidationResult(open_s=open_s)
    st = PraosState()
    tag = recovery_mod.chain_tag(db_path, params)
    doc = recovery_mod.resume_record(tag, checkpoint) if resume else None
    skip = int(doc["headers"]) if doc is not None else 0
    recovery_mod.arm_writer(checkpoint, tag, skip, int(doc["windows"]) if doc else 0)
    if doc is not None:
        st = recovery_mod.decode_state(doc["state"])
        res.n_valid = res.resumed_headers = skip
    tally = ValidationResult(read_s=open_s)  # the reader's counts, on its thread
    segs = _timed_segments(params, imm, tally, columnar, sidecar, max_headers, skip, sup)
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
                                        aggregate=aggregate, phases=phases, supervisor=sup)
            res.validate_s += time.monotonic() - ts
            st = out.state
            res.n_valid += out.n_valid
            if out.error is not None:
                res.error = out.error
                break
            trace(f"validated {res.n_valid} headers")
        if recovery_mod._WRITER is not None:
            recovery_mod._WRITER.finalize(st, res.error)
    finally:
        segs.close()  # stops and joins the prefetch thread
        recovery_mod.disarm_writer()
    if res.error is None:
        res.n_blocks = tally.n_blocks
    if max_headers is not None:
        res.n_blocks = min(res.n_blocks, max_headers)
    res.read_s = tally.read_s
    if phases is not None:
        res.phases = {"read": tally.read_s, **phases.wall}
        res.h2d_bytes, res.d2h_bytes = phases.h2d_bytes, phases.d2h_bytes
        res.n_windows, res.packed_windows = phases.windows, phases.packed_windows
    res.recoveries = list(sup.events)
    res.final_state = st
    return res


def _write_csv(path: str, header: list, rows: list) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def main(argv=None) -> int:
    """CLI (the reference's tools/db_analyser.py:1311-1390, its
    only-validation analysis): revalidate a synthesized chain (the
    reference CLI's parameters and credentials, db_synthesizer's
    `default_params` and `make_credentials`), or with `--cardano` a
    mixed-era composite chain (CardanoMockConfig's defaults), whose JSON
    line is the reference's."""
    import argparse
    import json

    from .db_synthesizer import default_params, make_credentials

    p = argparse.ArgumentParser(prog="db_analyser", description=__doc__.split("\n\n")[0])
    p.add_argument("--db", required=True)
    p.add_argument("--pools", type=int, default=2,
                   help="credential count the chain was synthesized with")
    p.add_argument("--kes-depth", type=int, default=7)
    p.add_argument("--backend", choices=["device", "native"], default="device")
    p.add_argument("--device", default=None,
                   help="the device backend's device (default: the CUDA card; cpu: the "
                        "plain PyTorch versions)")
    p.add_argument("--checkpoint", default=None,
                   help="the progress record's path, rewritten as windows retire")
    p.add_argument("--resume", action="store_true",
                   help="resume from the --checkpoint record when it matches this chain")
    p.add_argument("--repair", action="store_true",
                   help="write back the corrupted-tail cut the validation walk finds")
    p.add_argument("--out-csv", default=None,
                   help="write the result as CSV (with --cardano: a row an era)")
    p.add_argument("--cardano", action="store_true",
                   help="the DB holds the mixed-era composite (era-tagged blocks, "
                        "per-era protocols)")
    p.add_argument("--with-ledgers", action="store_true",
                   help="with --cardano: fold the era ledgers too (not ported yet)")
    a = p.parse_args(argv)
    if a.with_ledgers and not a.cardano:
        p.error("--with-ledgers requires --cardano")
    if a.resume and a.checkpoint is None:
        p.error("--resume requires --checkpoint")
    if a.cardano:
        from ..hardfork import composite as cardano

        if a.repair or a.resume or a.checkpoint:
            # a silently ignored flag would fake a repair or a resume
            p.error("--cardano does not support --repair/--resume/--checkpoint (the "
                    "composite replay opens its store read-only)")
        try:
            cfg = cardano.CardanoMockConfig(with_ledgers=a.with_ledgers)
            res = cardano.revalidate(a.db, cfg, backend=a.backend, device=a.device)
        except ValueError as e:
            p.error(str(e))
        print(json.dumps({"blocks": res.n_blocks, "valid": res.n_valid,
                          "per_era": res.per_era,
                          "error": None if res.error is None else repr(res.error)}))
        if a.out_csv:
            _write_csv(a.out_csv, ["era", "valid", "seconds"],
                       [[k, v, res.era_seconds[k]] for k, v in res.per_era.items()])
        return 0
    params = default_params(kes_depth=a.kes_depth)
    _pools, lview = make_credentials(a.pools, kes_depth=a.kes_depth)
    res = revalidate(a.db, params, lview, backend=a.backend, device=a.device,
                     trace=print, resume=a.resume, checkpoint=a.checkpoint, repair=a.repair)
    status = "OK" if res.error is None else f"INVALID at {res.n_valid}: {res.error!r}"
    if res.repairs:
        acts = ", ".join(f"{k}={v}" for k, v in sorted(res.repairs.items()))
        print(("dirty open — " if res.opened_dirty else "") + f"store repairs: {acts}")
    print(f"validated {res.n_valid}/{res.n_blocks} headers in {res.wall_s:.1f}s "
          f"(validate {res.validate_s:.1f}s) -> {status}")
    if a.out_csv:
        _write_csv(a.out_csv, ["blocks", "valid", "error", "wall_s", "validate_s", "read_s"],
                   [[res.n_blocks, res.n_valid, None if res.error is None else repr(res.error),
                     res.wall_s, res.validate_s, res.read_s]])
    return 0 if res.error is None else 1


if __name__ == "__main__":
    raise SystemExit(main())
