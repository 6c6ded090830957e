"""LedgerDB: last-k ledger-state checkpoints + on-disk snapshots (the
port's copy of the JAX package's storage/ledgerdb.py; its snapshot files
are the reference's byte for byte).

Reference: `Ouroboros.Consensus.Storage.LedgerDB` (~1.6k LoC) — an
in-memory `AnchoredSeq` of `Checkpoint ExtLedgerState` (LedgerDB.hs:78,102)
anchored at the immutable tip's state, supporting `ledgerDbPush` (:294),
`ledgerDbSwitch` (:315 — rollback + pushMany), pruning to k; plus CBOR
snapshots on disk (Snapshots.hs:108), a keep-2 disk policy
(DiskPolicy.hs:87), and replay-on-init from the newest usable snapshot
with fallback to older/genesis (Init.hs:89-145) using `tickThenReapply`
(NO crypto).

The batched inversion: `push_many` with `apply=True` sends the header
crypto of a run of fresh blocks to the protocol's device batch
(`PraosProtocol.validate_batch(collect_states=True)`: one packed window
an epoch segment through the stage kernels, seeded from the segment's
ticked state) while ledger-body application stays a host fold — the `Ap`
GADT's Apply/Reapply distinction (Update.hs:89) becomes a flag. A batch
that fails to launch raises out of `push_many`: there is no fall back to
the C++ verifier.
"""

from __future__ import annotations

import os
import re
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Sequence

from ..block.abstract import Point
from ..block.praos_block import Block
from ..ledger.extended import ExtLedger, ExtLedgerState
from ..ledger.header_validation import AnnTip, HeaderState, validate_envelope
from ..utils.fs import REAL_FS
from ..utils.trace import ValidatedBatch
from . import serialize


@dataclass
class InvalidBlock(Exception):
    point: Point
    reason: Exception


def encode_snapshot(state: ExtLedgerState) -> bytes:
    """Snapshot file = u32 CRC32 (LE) ‖ CBOR ExtLedgerState. The CRC
    makes ANY on-disk corruption detectable at init — a silently
    bit-flipped nonce would otherwise replay into a divergent chain
    (the reference pairs snapshots with checksum files for the same
    reason)."""
    payload = serialize.encode_ext_state(state)
    return zlib.crc32(payload).to_bytes(4, "little") + payload


def decode_snapshot(data: bytes) -> ExtLedgerState:
    if len(data) < 4:
        raise ValueError("snapshot too short")
    crc, payload = int.from_bytes(data[:4], "little"), data[4:]
    if zlib.crc32(payload) == crc:
        return serialize.decode_ext_state(payload)
    # migration: snapshots written before the CRC framing are raw CBOR —
    # accept them iff the WHOLE byte string decodes (a corrupted CRC
    # snapshot cannot: its leading 4 CRC bytes are not valid CBOR here)
    try:
        return serialize.decode_ext_state(data)
    except Exception:
        raise ValueError("snapshot checksum mismatch") from None


class LedgerDB:
    """AnchoredSeq of (point, state): index 0 is the anchor (immutable
    tip); at most k volatile checkpoints follow."""

    def __init__(self, ext: ExtLedger, k: int, anchor: ExtLedgerState, fs=None):
        self.ext = ext
        self.k = k
        self.fs = fs if fs is not None else REAL_FS
        self._seq: list[tuple[Point | None, ExtLedgerState]] = [
            (ext.tip_point(anchor), anchor)
        ]
        # LgrDB's varPrevApplied (Impl/LgrDB.hs:86): hash -> slot of
        # blocks validated before — a fork switch re-crossing them
        # chooses ReapplyVal (no crypto) instead of ApplyVal
        # (LgrDB.hs:330); GC'd alongside the VolatileDB
        self._prev_applied: dict[bytes, int] = {}
        # typed event tracer: `_push_many_batched` emits one
        # ValidatedBatch (utils.trace) a device segment
        self.tracer = None

    # -- queries -------------------------------------------------------------

    def current(self) -> ExtLedgerState:
        return self._seq[-1][1]

    def anchor(self) -> ExtLedgerState:
        return self._seq[0][1]

    def tip_point(self) -> Point | None:
        return self._seq[-1][0]

    def volatile_length(self) -> int:
        return len(self._seq) - 1

    def past_state(self, point: Point | None) -> ExtLedgerState | None:
        """getPastLedger: state at `point` if within the last k blocks."""
        for p, st in self._seq:
            if p == point:
                return st
        return None

    def header_states(self) -> list[HeaderState]:
        """Header states of every checkpoint, anchor first — the seed
        for the ChainDB's HeaderStateHistory (HeaderStateHistory.hs
        `fromChain` over the in-memory checkpoints)."""
        return [st.header_state for _, st in self._seq]

    def last_header_states(self, n: int) -> list[HeaderState]:
        """Header states of the newest n checkpoints, oldest first."""
        return [st.header_state for _, st in self._seq[len(self._seq) - n :]] if n else []

    # -- updates -------------------------------------------------------------

    def push(self, block, apply: bool = True) -> ExtLedgerState:
        """ledgerDbPush + prune-to-k. `apply` requests full validation,
        downgraded to reapply for previously-applied blocks (the Ap GADT
        choice in LgrDB.validate, Impl/LgrDB.hs:330)."""
        st = self.current()
        requested_apply = apply
        if apply and block.hash_ in self._prev_applied:
            apply = False
        new = (
            self.ext.tick_then_apply(st, block)
            if apply
            else self.ext.tick_then_reapply(st, block)
        )
        if requested_apply:
            # only VALIDATION records prev-applied (LgrDB.hs adds in
            # validate, not during replay) — an immutable-replay push
            # (apply=False) must not grow an O(chain) dict
            self._prev_applied[block.hash_] = block.slot
        self._seq.append((block.point, new))
        if len(self._seq) > self.k + 1:
            self._seq = self._seq[len(self._seq) - (self.k + 1) :]
        return new

    def rollback(self, n: int) -> bool:
        """ledgerDbRollback: drop the last n states; fails beyond k."""
        if n > self.volatile_length():
            return False
        if n:
            self._seq = self._seq[:-n]
        return True

    def push_many(self, blocks: Sequence, apply: bool = True) -> None:
        """ledgerDbPushMany; with `apply` and a batching protocol, header
        crypto runs as fused device batches (epoch-segmented). Runs of
        previously-applied blocks skip the kernels entirely (Reapply)."""
        proto = self.ext.protocol
        if apply and getattr(proto, "use_device_batch", False) and len(blocks) > 1:
            i, n = 0, len(blocks)
            while i < n:
                fresh = blocks[i].hash_ not in self._prev_applied
                j = i
                while j < n and (blocks[j].hash_ not in self._prev_applied) == fresh:
                    j += 1
                run = blocks[i:j]
                if fresh:
                    self._push_many_batched(run)
                else:
                    for b in run:
                        try:
                            self.push(b, False)
                        except Exception as e:
                            raise InvalidBlock(b.point, e) from e
                i = j
        else:
            for b in blocks:
                try:
                    self.push(b, apply)
                except Exception as e:
                    raise InvalidBlock(b.point, e) from e

    def _push_many_batched(self, blocks: Sequence) -> None:
        """Bodies: sequential host fold. Headers: device batch per epoch
        segment (protocol/batch.py), envelope checks on host."""
        proto = self.ext.protocol
        params = proto.params
        i = 0
        n = len(blocks)
        while i < n:
            epoch = params.epoch_of(blocks[i].slot)
            j = i
            while j < n and params.epoch_of(blocks[j].slot) == epoch:
                j += 1
            segment = blocks[i:j]
            st = self.current()
            # envelope + ledger bodies first (reference order applies the
            # ledger before validateHeader, Extended.hs:142-156); a body/
            # envelope failure truncates the segment so header states for
            # the valid prefix are STILL pushed before raising (callers —
            # ChainSel's truncate-rejected loop — rely on that)
            ext_states = []
            tip = st.header_state.tip
            ledger_state = st.ledger_state
            pending: InvalidBlock | None = None
            for b in segment:
                try:
                    validate_envelope(tip, b.header)
                    ledger_state = self.ext.ledger.tick_then_apply(ledger_state, b)
                except Exception as e:
                    pending = InvalidBlock(b.point, e)
                    break
                tip = AnnTip(b.slot, b.block_no, b.hash_)
                ext_states.append(ledger_state)
            segment = segment[: len(ext_states)]
            if segment:
                # ticked ledger view for the segment's epoch from the
                # current state (mock: static; HFC: per-era summary)
                lt = self.ext.ledger.tick(st.ledger_state, segment[0].slot)
                view = self.ext.ledger.protocol_ledger_view(lt)
                ticked = proto.tick(
                    view, segment[0].slot, st.header_state.chain_dep_state
                )
                t0 = time.monotonic()
                res = proto.validate_batch(
                    ticked, [b.header.to_view() for b in segment], collect_states=True
                )
                if self.tracer is not None:
                    self.tracer(ValidatedBatch(
                        len(segment), res.n_valid, time.monotonic() - t0,
                    ))
                for idx in range(res.n_valid):
                    b = segment[idx]
                    hs = HeaderState(
                        AnnTip(b.slot, b.block_no, b.hash_), res.states[idx]
                    )
                    self._seq.append((b.point, ExtLedgerState(ext_states[idx], hs)))
                    self._prev_applied[b.hash_] = b.slot
                if len(self._seq) > self.k + 1:
                    self._seq = self._seq[len(self._seq) - (self.k + 1) :]
                if res.error is not None:
                    raise InvalidBlock(segment[res.n_valid].point, res.error)
            if pending is not None:
                raise pending
            i = j

    def gc_prev_applied(self, slot: int) -> None:
        """garbageCollectPrevApplied (Impl/LgrDB.hs): forget hashes with
        slot < `slot` — the VolatileDB no longer holds those blocks, so
        they can never be pushed again."""
        self._prev_applied = {
            h: s for h, s in self._prev_applied.items() if s >= slot
        }

    def switch(self, n_rollback: int, blocks: Sequence, apply: bool = True) -> bool:
        """ledgerDbSwitch (Update.hs:315): rollback then pushMany."""
        if not self.rollback(n_rollback):
            return False
        self.push_many(blocks, apply)
        return True

    # -- snapshots (Snapshots.hs, DiskPolicy.hs) -----------------------------

    SNAP_RE = re.compile(r"^snapshot-(\d+)$")

    def take_snapshot(self, snap_dir: str, keep: int = 2) -> str | None:
        """Write the ANCHOR state (immutable tip, Snapshots.hs:108) named
        by its slot; prune to `keep` newest (DiskPolicy: default 2)."""
        self.fs.makedirs(snap_dir)
        anchor_point, anchor = self._seq[0]
        slot = 0 if anchor_point is None else anchor_point.slot
        name = f"snapshot-{slot}"
        path = os.path.join(snap_dir, name)
        if self.fs.exists(path):
            return None
        self.fs.write_atomic(path, encode_snapshot(anchor))
        snaps = sorted(self.list_snapshots(snap_dir, fs=self.fs))
        for s in snaps[:-keep]:
            self.fs.remove(os.path.join(snap_dir, f"snapshot-{s}"))
        return name

    @classmethod
    def list_snapshots(cls, snap_dir: str, fs=None) -> list[int]:
        fs = fs if fs is not None else REAL_FS
        if not fs.isdir(snap_dir):
            return []
        out = []
        for f in fs.listdir(snap_dir):
            m = cls.SNAP_RE.match(f)
            if m:
                out.append(int(m.group(1)))
        return out

    @classmethod
    def init_from_snapshots(
        cls,
        ext: ExtLedger,
        k: int,
        snap_dir: str,
        genesis: ExtLedgerState,
        immutable_db,
        trace: Callable[[str], None] = lambda s: None,
        fs=None,
        decode_block=None,
    ) -> "LedgerDB":
        """initLedgerDB (Init.hs:89-145): newest snapshot first, fall back
        to older ones then genesis; replay immutable blocks after the
        snapshot with tickThenReapply (no crypto)."""
        if decode_block is None:
            decode_block = Block.from_bytes
        fs = fs if fs is not None else REAL_FS
        for slot in sorted(cls.list_snapshots(snap_dir, fs=fs), reverse=True):
            path = os.path.join(snap_dir, f"snapshot-{slot}")
            try:
                state = decode_snapshot(fs.read_bytes(path))
            except Exception:
                trace(f"snapshot-{slot} unreadable; falling back")
                fs.remove(path)
                continue
            db = cls(ext, k, state, fs=fs)
            tip_slot = ext.tip_slot(state)
            start = -1 if tip_slot is None else tip_slot  # None = genesis
            for entry, raw in immutable_db.stream_from(start):
                db.push(decode_block(raw), apply=False)
                db._seq = db._seq[-1:]  # replay keeps only the tip state
            trace(f"replayed from snapshot-{slot}")
            return db
        db = cls(ext, k, genesis, fs=fs)
        n = 0
        for entry, raw in immutable_db.stream_all():
            db.push(decode_block(raw), apply=False)
            db._seq = db._seq[-1:]
            n += 1
        trace(f"replayed {n} blocks from genesis")
        return db
