"""ChainDB: the unified chain store + chain selection (the port's copy
of the JAX package's storage/chaindb.py).

Reference: `Ouroboros.Consensus.Storage.ChainDB` — the `ChainDB` record
(API.hs:117) facading ImmutableDB + VolatileDB + LedgerDB, and ChainSel
(Impl/ChainSel.hs, 1,305 LoC), the consensus decision engine:

  * `add_block` (addBlockSync, ChainSel.hs:256): store in VolatileDB,
    then `chainSelectionForBlock` (:440) — construct maximal candidate
    fragments through the volatile successor graph (Paths.hs:65
    maximalCandidates / isReachable :372), order them by SelectView
    (chainSelection :874), validate the best (ledgerValidateCandidate
    :1053 → LedgerDB switch), and install the winner.
  * followers (Impl/Follower.hs) — push-style chain-update consumers
    feeding the ChainSync server.
  * background copy: blocks > k deep migrate VolatileDB → ImmutableDB
    with a LedgerDB snapshot (Impl/Background.hs copyAndSnapshotRunner);
    VolatileDB GC after copy.
  * invalid-block set (getIsInvalidBlock, API.hs:331) so peers serving
    known-bad blocks are punished once, not revalidated.

The batched inversion: candidate suffix validation goes through
`LedgerDB.push_many`, which sends the fresh headers' crypto to the card as
one packed window an epoch (the stage kernels) instead of a call a block.

Concurrency: the reference serializes chain selection through an STM
queue + single background thread (cdbBlocksToAdd, ChainSel.hs:217-246)
and runs copy/snapshot/GC on background threads (Impl/Background.hs).
Both shapes exist here:

  * synchronous (default): `add_block` IS the serialization point and
    runs the copy/GC step inline — the shape the CLI tools use.
  * decoupled: `add_block_async` enqueues and returns an
    AddBlockPromise; `add_block_runner()` (a sim/asyncio task) pops and
    serializes chain selection, and `background_runner()` performs
    copy-to-immutable, snapshots and DELAYED VolatileDB GC (the
    GcSchedule analog) off the adoption path. Peer tasks never block on
    chain selection, mirroring ChainSel.hs:217-246 + Background.hs:17-38.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

from ..block.abstract import Point
from ..block.praos_block import Block
from ..ledger.extended import ExtLedger, ExtLedgerState
from ..ledger.header_history import HeaderStateHistory
from ..ledger.inspect import inspect_ledger
from ..utils import trace as T
from ..utils.sim import Event, Fire, Sleep, Wait
from .immutable import ImmutableDB
from .ledgerdb import InvalidBlock, LedgerDB
from .volatile import VolatileDB


class BlockGCed(Exception):
    """Iterator hit a block removed from BOTH stores (Impl/Iterator.hs
    IteratorBlockGCed): the stream fell off the chain's history."""


class MissingBlockError(Exception):
    """Ranged stream bounds not on the current chain (UnknownRange)."""


@dataclass
class AddBlockResult:
    added: bool
    new_tip: Point | None  # tip after (possibly unchanged)
    selected: bool  # did the chain change?


@dataclass
class AddBlockPromise:
    """The caller-visible side of an enqueued block (API.hs:134
    AddBlockPromise): `processed` fires once chain selection ran."""

    block: Block
    processed: Event
    result: AddBlockResult | None = None


class Follower:
    """A push-style consumer of chain updates (Impl/Follower.hs): the
    ChainSync server reads (rollback, new_blocks) instructions.

    `include_tentative` makes this a diffusion-pipelining follower
    (Impl/Follower.hs tentative followers, ChainSel.hs:949-984): headers
    of blocks that extend the current tip are announced BEFORE chain
    selection validates their bodies; if the block is then not adopted,
    a compensating rollback instruction precedes the real update."""

    def __init__(self, db: "ChainDB", include_tentative: bool = False):
        self.db = db
        self.include_tentative = include_tentative
        # ("rollback", Point|None) | ("addblock", Block) | ("tentative", Header)
        self.updates: list = []
        self.event = Event("follower")  # fired on every new instruction
        self._tentative_hash: bytes | None = None
        self._tentative_prev: Point | None = None

    def _notify_tentative(self, header, prev_point: Point | None) -> None:
        if not self.include_tentative or self._tentative_hash is not None:
            return
        self._tentative_hash = header.hash_
        self._tentative_prev = prev_point
        self.updates.append(("tentative", header))
        self._wake()

    def _retract_tentative(self, hash_: bytes) -> None:
        """Chain selection finished WITHOUT adopting the announced block
        (the trap case): retract the tentative header."""
        if self._tentative_hash == hash_:
            self.updates.append(("rollback", self._tentative_prev))
            self._tentative_hash = None
            self._tentative_prev = None
            self._wake()

    def _notify_switch(
        self,
        rolled_back: bool,
        rollback_to: Point | None,
        new_blocks: Sequence[Block],
    ):
        # `rolled_back` distinguishes "no rollback" from "rollback to
        # genesis" — rollback_to is None in BOTH cases
        new_blocks = list(new_blocks)
        if self._tentative_hash is not None:
            if (
                not rolled_back
                and new_blocks
                and new_blocks[0].hash_ == self._tentative_hash
            ):
                # tentative confirmed: the header was already announced
                new_blocks = new_blocks[1:]
            else:
                # tentative lost (trap / different fork): retract it
                # before relaying the real update
                self.updates.append(("rollback", self._tentative_prev))
            self._tentative_hash = None
            self._tentative_prev = None
        if rolled_back:
            self.updates.append(("rollback", rollback_to))
        for b in new_blocks:
            self.updates.append(("addblock", b))
        if self.updates:
            self._wake()

    def _wake(self) -> None:
        if self.db.runtime is not None:
            self.db.runtime.fire(self.event)

    def take_updates(self) -> list:
        out, self.updates = self.updates, []
        return out

    def reset_position(self) -> None:
        """Drop queued instructions AND pending-tentative tracking — the
        server re-anchors on a chain snapshot at find_intersect, so a
        not-yet-resolved tentative must be delivered afresh when (if)
        its block is adopted."""
        self.updates = []
        self._tentative_hash = None
        self._tentative_prev = None

    def close(self) -> None:
        """Unregister (ChainDB followers are owned by their protocol
        server; a killed server must not leak its follower)."""
        self.db.remove_follower(self)


class DiskPolicy:
    """defaultDiskPolicy (Storage/LedgerDB/DiskPolicy.hs:87-108).

    * keep 2 on-disk snapshots (LedgerDB.take_snapshot keep=2);
    * with NO snapshot taken yet this run, snapshot once k blocks have
      been copied/replayed (covers short-lived nodes that would never
      reach the time trigger);
    * otherwise snapshot when the time since the last one reaches the
      requested interval (default k*2 seconds — 72 min at k=2160), or
      when a substantial burst was processed: >= 50k blocks AND >= 6
      minutes since the last snapshot (bulk-sync cadence cap).
    """

    MIN_BLOCKS_BEFORE_SNAPSHOT = 50_000
    MIN_TIME_BEFORE_SNAPSHOT = 6 * 60.0

    def __init__(self, k: int, requested_interval_s: float | None = None):
        self.k = k
        self.interval_s = (
            float(requested_interval_s)
            if requested_interval_s is not None
            else 2.0 * k
        )
        self._last_snapshot_at: float | None = None  # NoSnapshotTakenYet

    def should_take_snapshot(self, blocks_since_last: int, now_s: float) -> bool:
        if self._last_snapshot_at is None:
            return blocks_since_last >= self.k
        since = now_s - self._last_snapshot_at
        if since >= self.interval_s:
            return True
        return (
            blocks_since_last >= self.MIN_BLOCKS_BEFORE_SNAPSHOT
            and since >= self.MIN_TIME_BEFORE_SNAPSHOT
        )

    def snapshot_taken(self, now_s: float) -> None:
        self._last_snapshot_at = now_s


class ChainDB:
    """The facade. `current_chain` is the volatile fragment (≤ k blocks,
    newest last); older blocks live in the ImmutableDB."""

    def __init__(
        self,
        ext: ExtLedger,
        immutable: ImmutableDB,
        volatile: VolatileDB,
        ledgerdb: LedgerDB,
        k: int,
        snap_dir: str | None = None,
        snapshot_interval: int = 100,
        trace: Callable[[str], None] = lambda s: None,
        check_in_future=None,  # .truncate(blocks) -> (kept, dropped), or None
        decode_block=None,  # block codec seam; default = Praos Block
        tracer=None,  # TYPED event tracer (utils.trace ChainDB algebra,
        # ChainDB/Impl.hs:10-28) — `trace` stays the human-string log
    ):
        self.ext = ext
        self.immutable = immutable
        self.volatile = volatile
        self.ledgerdb = ledgerdb
        self.decode_block = (
            decode_block if decode_block is not None else Block.from_bytes
        )
        self.k = k
        self.snap_dir = snap_dir
        # DiskPolicy (DiskPolicy.hs:87-108): block-count trigger kept for
        # sim determinism when `snapshot_interval` is given; the
        # reference's time-based default (k*2 seconds, 50k-block burst
        # rule, snapshot at k blocks on a fresh run) via `disk_policy`
        self.snapshot_interval = snapshot_interval
        self.disk_policy: DiskPolicy | None = None
        self._copied_since_snapshot = 0
        self.trace = trace
        self.tracer = tracer if tracer is not None else T.null_tracer
        self._T = T
        # CheckInFuture (Fragment/InFuture.hs:45): candidates are cut at
        # their first in-future header before selection; None = dontCheck
        self.check_in_future = check_in_future
        self.current_chain: list[Block] = []  # volatile fragment, ≤ k
        self.invalid: dict[bytes, Exception] = {}  # hash -> reason
        self._block_cache: dict[bytes, Block] = {}  # per-selection (BlockCache.hs)
        self.followers: list[Follower] = []
        # decoupled mode state (add_block_runner / background_runner)
        self._blocks_to_add: deque[AddBlockPromise] = deque()
        self._queue_event = Event("blocks-to-add")
        self._chain_event = Event("chain-changed")
        self._background_decoupled = False
        self.runtime = None  # object with .fire(Event), set by the node
        # k-deep header-state history of the CURRENT chain
        # (HeaderStateHistory.hs): answers header_state_at without
        # touching the LedgerDB's full ExtLedgerStates. Maintained
        # incrementally by _install, resynced from the LedgerDB (the
        # authoritative store) when the shapes diverge.
        self.header_history = HeaderStateHistory(k=k)
        self._init_chain_selection()
        self._sync_header_history()

    # -- initial chain selection (ChainSel.hs:96) ----------------------------

    def _init_chain_selection(self) -> None:
        """Find the best chain through the volatile graph extending the
        immutable tip; validates via LedgerDB. The SAME validate-best /
        truncate-rejected loop as chainSelectionForBlock: a candidate
        that truncates to a valid prefix must not end selection — the
        next-best candidate may beat that prefix (initialChainSelection,
        ChainSel.hs:96)."""
        self.current_chain = []
        anchor = self._anchor_point()
        rejected: list[list[bytes]] = []
        while True:
            cand = self._best_candidate_from(anchor, rejected)
            if cand is None:
                return
            cur_view = self._current_select_view()
            if self.check_in_future is not None:
                kept, dropped = self.check_in_future.truncate(cand)
                if dropped:
                    self.trace(
                        f"init: {len(dropped)} in-future block(s) cut "
                        f"from candidate"
                    )
                    kept_view = (
                        self.ext.protocol.select_view(kept[-1].header)
                        if kept else None
                    )
                    if not kept or (
                        cur_view is not None
                        and self.ext.protocol.compare_candidates(
                            cur_view, kept_view
                        ) <= 0
                    ):
                        rejected.append([b.hash_ for b in cand])
                        continue
                    rejected.append([b.hash_ for b in cand])
                    cand = kept
            cand_view = self.ext.protocol.select_view(cand[-1].header)
            if (
                cur_view is not None
                and self.ext.protocol.compare_candidates(cur_view, cand_view) <= 0
            ):
                return
            n_rollback, suffix = self._diff_against_current(cand)
            outcome = self._try_adopt(n_rollback, suffix, full_candidate=cand)
            if outcome == "adopted":
                return
            rejected.append([b.hash_ for b in cand])

    def _anchor_point(self) -> Point | None:
        return self.immutable.tip_point()

    # -- queries (API.hs) ----------------------------------------------------

    def tip_point(self) -> Point | None:
        if self.current_chain:
            return self.current_chain[-1].point
        return self._anchor_point()

    def tip_header(self):
        return self.current_chain[-1].header if self.current_chain else None

    def tip_block_no(self) -> int | None:
        if self.current_chain:
            return self.current_chain[-1].block_no
        t = self.immutable.tip()
        return None if t is None else t.block_no

    def current_ledger(self) -> ExtLedgerState:
        return self.ledgerdb.current()

    def get_past_ledger(self, point: Point | None) -> ExtLedgerState | None:
        return self.ledgerdb.past_state(point)

    def header_state_at(self, point: Point | None):
        """HeaderState at `point` on the current chain, answered from the
        k-deep HeaderStateHistory (HeaderStateHistory.hs) — the cheap
        path for seeding a ChainSync peer candidate at an intersection.
        Falls back to the LedgerDB for the anchor/genesis. None if the
        point is not on the recent chain."""
        if point is not None:
            hs = self.header_history.state_at(point)
            if hs is not None:
                return hs
        ext = self.ledgerdb.past_state(point)
        return None if ext is None else ext.header_state

    def _sync_header_history(self) -> None:
        """Rebuild the header history from the LedgerDB checkpoints.

        The LedgerDB's volatile tail aligns 1:1 with the newest
        current_chain blocks (both are pruned to k); its header states
        ARE the history."""
        states = self.ledgerdb.header_states()
        n = len(states) - 1
        hh = self.header_history
        hh.states = states
        hh.headers = (
            [b.header for b in self.current_chain[len(self.current_chain) - n :]]
            if n > 0
            else []
        )
        hh.trimmed = states[0].tip is not None

    def _update_header_history(self, n_rollback: int, suffix: list[Block]) -> None:
        """Incremental history maintenance after _install: rollback the
        replaced suffix, append the new states the LedgerDB just pushed.
        extend() trims to k as the chain grows."""
        hh = self.header_history
        if n_rollback <= len(hh.headers) and len(suffix) <= self.ledgerdb.volatile_length():
            hh.rollback_n(n_rollback)
            for b, hs in zip(suffix, self.ledgerdb.last_header_states(len(suffix))):
                hh.extend(b.header, hs)
        else:
            self._sync_header_history()

    def get_is_invalid_block(self, hash_: bytes) -> Exception | None:
        return self.invalid.get(hash_)

    def get_block(self, point: Point) -> Block | None:
        raw = self.volatile.get_block_bytes(point.hash_)
        if raw is None:
            try:
                raw = self.immutable.get_block_bytes(point)
            except Exception:
                return None
        return self.decode_block(raw)

    def new_follower(self, include_tentative: bool = False) -> Follower:
        f = Follower(self, include_tentative=include_tentative)
        self.followers.append(f)
        self.tracer(self._T.NewFollowerEvent(include_tentative))
        return f

    def remove_follower(self, f: Follower) -> None:
        if f in self.followers:
            self.followers.remove(f)

    def stream_all(self) -> Iterable[Block]:
        """Iterator over the whole current chain, immutable part first."""
        for entry, raw in self.immutable.stream_all():
            yield self.decode_block(raw)
        yield from self.current_chain

    def stream(
        self, from_exclusive: Point | None = None, to_inclusive: Point | None = None
    ) -> Iterable[Block]:
        """GC-safe ranged iterator (ChainDB.stream, API.hs:274 +
        Impl/Iterator.hs): stream the current chain after
        `from_exclusive` up to `to_inclusive` (None = tip at creation).

        The PLAN (the point sequence) is pinned at creation; each body
        is resolved lazily at yield time — first from the VolatileDB,
        then from the ImmutableDB. A block that background copy+GC moved
        between the stores mid-iteration is therefore still found (the
        reference's Volatile→Immutable iterator switching); a block
        found in NEITHER store raises BlockGCed."""
        plan: list[Point] = []
        started = from_exclusive is None
        done = False

        def visit(p: Point) -> None:
            nonlocal started, done
            if not started:
                if p == from_exclusive:
                    started = True
                    if to_inclusive == from_exclusive:
                        done = True  # valid empty range
                return
            plan.append(p)
            if to_inclusive is not None and p == to_inclusive:
                done = True

        for p in self.immutable.iter_points():
            visit(p)
            if done:
                break
        if not done:
            for b in self.current_chain:
                visit(b.point)
                if done:
                    break
        if not started:
            raise MissingBlockError(from_exclusive)
        if to_inclusive is not None and not done:
            raise MissingBlockError(to_inclusive)

        def resolve():
            for p in plan:
                raw = self.volatile.get_block_bytes(p.hash_)
                if raw is None:
                    try:
                        raw = self.immutable.get_block_bytes(p)
                    except Exception:
                        raise BlockGCed(p) from None
                yield self.decode_block(raw)

        return resolve()

    # -- candidates (Impl/Paths.hs) ------------------------------------------

    def _candidates_through(
        self, anchor: Point | None, via: bytes | None = None
    ) -> list[list[bytes]]:
        """maximalCandidates (Paths.hs:65): maximal hash-paths in the
        volatile successor graph rooted at `anchor`. With `via`, only the
        paths passing through that block (isReachable, Paths.hs:372):
        walk prev-hashes backwards from `via` to the anchor, then extend
        forward — O(depth + subtree) instead of the whole graph.

        Iterative DFS: volatile paths reach k blocks (2160 mainnet),
        beyond Python's recursion limit.
        """
        root = None if anchor is None else anchor.hash_

        if via is not None:
            back: list[bytes] = []
            h = via
            while True:
                info = self.volatile.get_block_info(h)
                if info is None or h in self.invalid:
                    return []  # not connected (yet) or known bad
                back.append(h)
                if info.prev_hash == root:
                    break
                h = info.prev_hash
                if h is None:
                    return []  # hit genesis without meeting the anchor
            prefix = list(reversed(back))
            return [prefix[:-1] + tail for tail in self._forward_paths(via)]

        out: list[list[bytes]] = []
        # stack of (hash, path-so-far); paths share list copies only on fork
        stack: list[tuple[bytes | None, list[bytes]]] = [(root, [])]
        while stack:
            h, acc = stack.pop()
            succs = [
                s
                for s in self.volatile.filter_by_predecessor(h)
                if s not in self.invalid
            ]
            if not succs:
                if acc:
                    out.append(acc)
                continue
            for s in succs:
                stack.append((s, acc + [s]))
        return out

    def _forward_paths(self, start: bytes) -> list[list[bytes]]:
        """All maximal paths beginning AT `start` (inclusive)."""
        out: list[list[bytes]] = []
        stack: list[tuple[bytes, list[bytes]]] = [(start, [start])]
        while stack:
            h, acc = stack.pop()
            succs = [
                s
                for s in self.volatile.filter_by_predecessor(h)
                if s not in self.invalid
            ]
            if not succs:
                out.append(acc)
                continue
            for s in succs:
                stack.append((s, acc + [s]))
        return out

    def _load_fragment(self, hashes: list[bytes]) -> list[Block] | None:
        blocks = []
        for h in hashes:
            cached = self._block_cache.get(h)
            if cached is not None:
                blocks.append(cached)
                continue
            raw = self.volatile.get_block_bytes(h)
            if raw is None:
                return None
            blocks.append(self.decode_block(raw))
        return blocks

    def _best_candidate_from(
        self,
        anchor: Point | None,
        exclude: Sequence[Sequence[bytes]],
        via: bytes | None = None,
    ) -> list[Block] | None:
        """Best UNVALIDATED candidate by SelectView ordering; `exclude`
        lists hash-fragments already rejected this round."""
        cands = [
            c for c in self._candidates_through(anchor, via)
            if not any(list(c) == list(e) for e in exclude)
        ]
        if not cands:
            return None
        proto = self.ext.protocol

        # compare by TIP select-view only (sortCandidates, ChainSel.hs:874
        # orders on the tip's SelectView) — parsing whole fragments here
        # would cost O(k) block reads per incoming block on the hot path
        def tip_view(c):
            cached = self._block_cache.get(c[-1])
            if cached is not None:
                return proto.select_view(cached.header)
            raw = self.volatile.get_block_bytes(c[-1])
            if raw is None:
                return None
            return proto.select_view(self.decode_block(raw).header)

        ranked = [(c, v) for c in cands if (v := tip_view(c)) is not None]
        # best-first: load the full fragment only for the winner; fall
        # back to the next candidate if a body went missing (GC race)
        while ranked:
            best_i = 0
            for i in range(1, len(ranked)):
                if proto.compare_candidates(ranked[best_i][1], ranked[i][1]) > 0:
                    best_i = i
            c, _ = ranked.pop(best_i)
            blocks = self._load_fragment(c)
            if blocks is not None:
                return blocks
        return None

    # -- chain selection for a new block (ChainSel.hs:440) -------------------

    def add_block(self, block: Block) -> AddBlockResult:
        """addBlockSync: store, then run chain selection."""
        if block.hash_ in self.invalid:
            self.tracer(self._T.IgnoreInvalidBlock(block.slot, block.hash_))
            return AddBlockResult(False, self.tip_point(), False)
        # olderThanK (ChainSel.hs:359): blocks at or before the immutable
        # tip slot can never be adopted
        imm = self.immutable.tip()
        if imm is not None and block.slot <= imm.slot:
            self.tracer(
                self._T.IgnoreBlockOlderThanK(block.slot, block.hash_)
            )
            return AddBlockResult(False, self.tip_point(), False)
        self.volatile.put_block(block)
        self.tracer(self._T.AddedBlockToVolatileDB(block.slot, block.hash_))
        # BlockCache (Impl/BlockCache.hs): the block in hand need not be
        # reread/reparsed from the VolatileDB during this selection
        self._block_cache[block.hash_] = block
        try:
            selected = self._chain_selection_for_block(block)
        finally:
            self._block_cache.clear()
        if not selected:
            self.tracer(self._T.StoreButDontChange(block.slot, block.hash_))
        return AddBlockResult(True, self.tip_point(), selected)

    def _current_select_view(self):
        proto = self.ext.protocol
        if self.current_chain:
            return proto.select_view(self.current_chain[-1].header)
        return None

    def _chain_selection_for_block(self, block: Block) -> bool:
        """chainSelectionForBlock: consider candidates containing `block`;
        loop validate-best / truncate-rejected (chainSelection :874).
        Adopting a TRUNCATED prefix of a candidate continues the loop —
        the remaining candidates are compared against the new (prefix)
        chain, so a longer fully-valid fork is never shadowed by a
        better-ranked candidate that failed validation."""
        proto = self.ext.protocol
        anchor = self._anchor_point()
        rejected: list[list[bytes]] = []
        changed = False
        while True:
            cur_view = self._current_select_view()
            cand = self._best_candidate_from(anchor, rejected, via=block.hash_)
            if cand is None:
                return changed
            # rejection must always record the FULL candidate's hashes:
            # _best_candidate_from excludes by exact hash-list equality
            # against the maximal fragments it regenerates, so rejecting
            # only a truncated prefix would re-select the same candidate
            # forever when _try_adopt fails without changing any state
            # (e.g. rollback beyond the LedgerDB window)
            full_hashes = [b.hash_ for b in cand]
            if self.check_in_future is not None:
                kept, dropped = self.check_in_future.truncate(cand)
                if dropped:
                    self.trace(
                        f"{len(dropped)} in-future block(s) cut from "
                        f"candidate (first at slot {dropped[0].slot})"
                    )
                    # candidates were RANKED by untruncated tip, so a
                    # truncated loser must not end the loop — reject it
                    # and let the next-best (possibly all-present-slot)
                    # candidate have its turn
                    kept_view = (
                        proto.select_view(kept[-1].header) if kept else None
                    )
                    if not kept or proto.compare_candidates(
                        cur_view, kept_view
                    ) <= 0:
                        rejected.append(full_hashes)
                        continue
                    cand = kept
            cand_view = proto.select_view(cand[-1].header)
            # preferCandidate: only strictly better chains are adopted
            if proto.compare_candidates(cur_view, cand_view) <= 0:
                return changed
            n_rollback, suffix = self._diff_against_current(cand)
            outcome = self._try_adopt(n_rollback, suffix, full_candidate=cand)
            if outcome == "adopted":
                return True
            if outcome == "prefix":
                changed = True
            rejected.append(full_hashes)

    def _diff_against_current(self, cand: list[Block]):
        """ChainDiff (Fragment/Diff.hs): longest common prefix with the
        current chain -> (rollback count, new suffix)."""
        i = 0
        while (
            i < len(cand)
            and i < len(self.current_chain)
            and cand[i].hash_ == self.current_chain[i].hash_
        ):
            i += 1
        return len(self.current_chain) - i, cand[i:]

    def _try_adopt(
        self, n_rollback: int, suffix: list[Block], full_candidate: list[Block] | None = None
    ) -> str:
        """ledgerValidateCandidate (:1053): LedgerDB switch validates the
        suffix (batched header crypto). On invalid blocks, mark + truncate
        and adopt the valid prefix if it still beats the current chain
        (the truncate-rejected loop).

        Returns "adopted" (full candidate installed), "prefix" (an
        invalid block truncated it; the VALID PREFIX was installed), or
        "failed" (nothing changed)."""
        if not suffix and n_rollback == 0:
            return "failed"
        n_before = self.ledgerdb.volatile_length()
        state_before = self.ledgerdb.current()
        try:
            if not self.ledgerdb.switch(n_rollback, suffix):
                # rollback deeper than the LedgerDB holds (> k): the
                # candidate forks before our immutability window — reject
                self.trace(f"rollback {n_rollback} beyond LedgerDB window")
                return "failed"
        except InvalidBlock as e:
            self.invalid[e.point.hash_] = e.reason
            self.trace(f"invalid block at {e.point}: {type(e.reason).__name__}")
            self.tracer(self._T.InvalidBlockEvent(
                e.point.slot, e.point.hash_, type(e.reason).__name__
            ))
            # LedgerDB has adopted the valid prefix's states already;
            # roll its extra states back to match a prefix decision
            n_valid = next(
                (i for i, b in enumerate(suffix) if b.point == e.point),
                len(suffix),
            )
            prefix = suffix[:n_valid]
            if prefix:
                proto = self.ext.protocol
                cur_view = self._current_select_view()
                pref_view = proto.select_view(prefix[-1].header)
                if proto.compare_candidates(cur_view, pref_view) > 0:
                    self._install(n_rollback, prefix)
                    return "prefix"
            # restore: rollback the states LedgerDB pushed for the prefix
            pushed = self.ledgerdb.volatile_length() - (n_before - n_rollback)
            if pushed > 0:
                self.ledgerdb.rollback(pushed)
            # and re-push the states for the blocks we rolled back earlier
            if n_rollback > 0:
                restore = self.current_chain[len(self.current_chain) - n_rollback :]
                self.ledgerdb.push_many(restore, apply=False)
            return "failed"
        if suffix:
            self.tracer(
                self._T.ValidCandidate(len(suffix), suffix[-1].slot)
            )
        self._install(n_rollback, suffix)
        # InspectLedger (Ledger/Inspect.hs): trace ledger events of the
        # adoption — era transitions, protocol-update warnings
        for ev in inspect_ledger(
            self.ext.ledger,
            state_before.ledger_state,
            self.ledgerdb.current().ledger_state,
        ):
            self.trace(f"ledger event: {ev}")
        return "adopted"

    def _install(self, n_rollback: int, suffix: list[Block]) -> None:
        """switchTo (ChainSel.hs:703): swap the fragment, notify
        followers, run the copy/GC/snapshot background step."""
        if n_rollback:
            rollback_point = (
                self.current_chain[len(self.current_chain) - n_rollback - 1].point
                if n_rollback < len(self.current_chain)
                else self._anchor_point()
            )
            self.current_chain = self.current_chain[: len(self.current_chain) - n_rollback]
        else:
            rollback_point = None
        self.current_chain.extend(suffix)
        self._update_header_history(n_rollback, suffix)
        tip_slot = self.current_chain[-1].slot if self.current_chain else -1
        if n_rollback:
            self.tracer(
                self._T.SwitchedToAFork(n_rollback, len(suffix), tip_slot)
            )
        else:
            self.tracer(self._T.AddedToCurrentChain(len(suffix), tip_slot))
        for f in self.followers:
            f._notify_switch(n_rollback > 0, rollback_point, suffix)
        if self._background_decoupled:
            if self.runtime is not None:
                self.runtime.fire(self._chain_event)
        else:
            self._copy_and_gc()

    def close(self) -> None:
        """Clean shutdown: final ledger snapshot + index flush, so the
        next open resumes from the tip without a long replay."""
        if self.snap_dir is not None:
            self.ledgerdb.take_snapshot(self.snap_dir)
        self.immutable.flush()

    # -- background (Impl/Background.hs) -------------------------------------

    def _copy_step(self) -> int | None:
        """copyAndSnapshotRunner body: move blocks > k deep to the
        ImmutableDB, snapshot the ledger anchor on the DiskPolicy
        cadence. Returns the GC slot bound, or None if nothing moved."""
        excess = len(self.current_chain) - self.k
        if excess <= 0:
            return None
        to_copy, self.current_chain = (
            self.current_chain[:excess],
            self.current_chain[excess:],
        )
        for b in to_copy:
            self.immutable.append_block(b.slot, b.block_no, b.hash_, b.bytes_)
        self.tracer(
            self._T.CopiedToImmutableDB(len(to_copy), to_copy[-1].slot)
        )
        self._copied_since_snapshot += len(to_copy)
        if self.snap_dir is not None and self._should_snapshot():
            self.ledgerdb.take_snapshot(self.snap_dir)
            self.tracer(self._T.TookSnapshot(self._copied_since_snapshot))
            self._copied_since_snapshot = 0
            if self.disk_policy is not None:
                self.disk_policy.snapshot_taken(self._policy_now())
        return to_copy[-1].slot + 1

    def _policy_now(self) -> float:
        """Clock source for the DiskPolicy: virtual sim time when the
        node runtime is attached, wallclock otherwise."""
        if self.runtime is not None and hasattr(self.runtime, "now"):
            return float(self.runtime.now)
        return time.monotonic()

    def _should_snapshot(self) -> bool:
        if self.disk_policy is not None:
            return self.disk_policy.should_take_snapshot(
                self._copied_since_snapshot, self._policy_now()
            )
        return self._copied_since_snapshot >= self.snapshot_interval

    def _copy_and_gc(self) -> None:
        """Synchronous-mode step: copy + immediate GC."""
        gc_slot = self._copy_step()
        if gc_slot is not None:
            self.volatile.garbage_collect(gc_slot)
            self.ledgerdb.gc_prev_applied(gc_slot)
            self.tracer(self._T.PerformedGC(gc_slot))

    # -- decoupled mode (ChainSel.hs:217-246 + Background.hs:17-38) ----------

    def start_decoupled(self, runtime) -> list:
        """Switch to decoupled mode on `runtime` (a Sim or an adapter
        with .fire(Event)); returns the runner generators for the caller
        to spawn. Must be called before any add_block_async."""
        self.runtime = runtime
        self._background_decoupled = True
        return [self.add_block_runner(), self.background_runner()]

    def add_block_async(self, block: Block) -> AddBlockPromise:
        """addBlockAsync (API.hs:134): enqueue for the add-block runner
        and return a promise. Works in BOTH modes so call sites never
        branch: synchronous mode runs chain selection inline and returns
        an already-completed promise. Callers needing the verdict do
        `if p.result is None: yield Wait(p.processed)`."""
        p = AddBlockPromise(block, Event(f"processed-{block.slot}"))
        if not self._background_decoupled:
            p.result = self.add_block(block)
            return p
        # diffusion pipelining (ChainSel.hs:949-984): a block extending
        # the current tip is announced to tentative followers as a
        # header BEFORE its (possibly slow, batched) validation
        tip = self.tip_point()
        if block.prev_hash == (tip.hash_ if tip else None):
            if any(f.include_tentative for f in self.followers):
                self.tracer(
                    self._T.SetTentativeHeader(block.slot, block.hash_)
                )
            for f in self.followers:
                f._notify_tentative(block.header, tip)
        self._blocks_to_add.append(p)
        self.tracer(self._T.AddedBlockToQueue(
            block.slot, block.hash_, len(self._blocks_to_add)
        ))
        if self.runtime is not None:
            self.runtime.fire(self._queue_event)
        return p

    def add_block_runner(self):
        """Sim task (Background.hs addBlockRunner): the single consumer
        of the add-block queue — chain selection is serialized here no
        matter how many peer tasks feed the queue."""
        while True:
            while not self._blocks_to_add:
                yield Wait(self._queue_event)
            p = self._blocks_to_add.popleft()
            self.tracer(
                self._T.PoppedBlockFromQueue(p.block.slot, p.block.hash_)
            )
            p.result = self.add_block(p.block)
            if not p.result.selected:
                if any(f._tentative_hash == p.block.hash_
                       for f in self.followers):
                    self.tracer(self._T.TrapTentativeHeader(
                        p.block.slot, p.block.hash_
                    ))
                for f in self.followers:
                    f._retract_tentative(p.block.hash_)
            yield Fire(p.processed)

    def background_runner(self, gc_delay: float = 1.0):
        """Sim task (copyAndSnapshotRunner + GcSchedule): on every chain
        change, copy mature blocks to the ImmutableDB + snapshot; GC the
        VolatileDB only `gc_delay` later, so concurrent readers of the
        copied blocks (iterators, servers) drain first — the reference's
        scheduled-GC batching (Background.hs GcSchedule)."""
        while True:
            yield Wait(self._chain_event)
            # chain changes fired while we were sleeping below are not in
            # the waiter list — re-run the copy step until it finds
            # nothing, so no adoption's excess blocks are stranded
            while True:
                gc_slot = self._copy_step()
                if gc_slot is None:
                    break
                self.tracer(self._T.ScheduledGC(gc_slot))
                yield Sleep(gc_delay)
                self.volatile.garbage_collect(gc_slot)
                self.ledgerdb.gc_prev_applied(gc_slot)
                self.tracer(self._T.PerformedGC(gc_slot))
