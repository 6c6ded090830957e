"""The store crash protocol: DB lock, chain-magic marker, clean-shutdown
marker.

Reference: `Node/{DbLock,DbMarker,Recovery}.hs` via `stdWithCheckedDB`
(Node.hs:546); the JAX package's storage/guard.py is the port's
reference, with the same file names and marker bytes, so that an open
by either package excludes the other through the same `flock`:

  * **DB lock** (``<db>/lock``): one process a DB directory. A flock on
    the real filesystem (the kernel drops it when the holder dies, so a
    stale lock file never wedges a restart); on a MockFS its advisory
    registry, which `MockFS.crash` clears. A live second opener raises
    `DbLocked`.
  * **DB marker** (``<db>/protocolMagicId``): the chain's network magic
    as decimal text. Created by a writer's first open, verified after;
    a mismatch raises `DbMarkerMismatch`.
  * **Clean-shutdown marker** (``<db>/clean``): present only while no
    writer runs. A writer removes it while it runs and writes it back
    on an orderly close; missing at an open (after a first run) means
    the last writer died, and the open escalates to the all-chunks
    validation with on-disk repair.

`StoreGuard` bundles the protocol for the tools: lock, marker, dirty
check, and (writer) clear the clean marker; `close(clean=...)` writes
it back through the chaos ``marker`` seam (`partial-rename@marker`
models a crash between the tmp write and the rename).
"""

from __future__ import annotations

import os

from ..utils.fs import REAL_FS

DB_LOCK = "lock"
DB_MARKER = "protocolMagicId"
CLEAN_SHUTDOWN = "clean"  # reference: absence of the marker = crashed
DEFAULT_MAGIC = 764824073  # mainnet protocolMagicId (node/run default)


class DbLocked(Exception):
    """Another process holds the DB (DbLock.hs DbLocked)."""


class DbMarkerMismatch(Exception):
    """DB belongs to a different chain/network (DbMarker.hs)."""


class DbLockFile:
    """Single-process guard (DbLock.hs, 2s timeout): flock on the real
    filesystem; on a mock FS, the MockFS advisory-lock registry — which
    MockFS.crash clears, mirroring flock's release-on-process-death."""

    def __init__(self, db_path: str, fs=None):
        self.path = os.path.join(db_path, DB_LOCK)
        self.fs = fs  # None = real FS (flock)
        self._fd: int | None = None
        self._held = False

    def acquire(self) -> None:
        if self.fs is not None:
            if self.path in self.fs.advisory_locks:
                raise DbLocked(self.path)
            self.fs.advisory_locks.add(self.path)
            self._held = True
            return
        import fcntl

        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            os.close(fd)
            raise DbLocked(self.path) from e
        self._fd = fd
        self._held = True

    def release(self) -> None:
        if not self._held:
            return  # never release a lock another instance holds
        self._held = False
        if self.fs is not None:
            self.fs.advisory_locks.discard(self.path)
            return
        if self._fd is not None:
            import fcntl

            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def check_db_marker(db_path: str, network_magic: int, fs=None) -> None:
    """checkDbMarker (DbMarker.hs): create on first open, verify after."""
    fs = fs if fs is not None else REAL_FS
    p = os.path.join(db_path, DB_MARKER)
    if fs.exists(p):
        found = read_db_marker(db_path, fs=fs)
        if found != network_magic:
            raise DbMarkerMismatch(
                f"DB is for magic {found}, node runs {network_magic}"
            )
    else:
        fs.makedirs(db_path)
        # durable: the marker must survive a crash (write_atomic fsyncs)
        fs.write_atomic(p, str(network_magic).encode())


def read_db_marker(db_path: str, fs=None) -> int | None:
    """The magic the marker binds this DB to; None = no marker yet. A
    marker that EXISTS but does not parse is not 'missing' — treating
    it so would let a writer re-stamp (or a reader silently accept) a
    store whose chain identity is unknown; refuse loudly instead."""
    fs = fs if fs is not None else REAL_FS
    p = os.path.join(db_path, DB_MARKER)
    if not fs.exists(p):
        return None
    raw = fs.read_bytes(p)
    try:
        return int(raw.decode().strip())
    except ValueError:
        raise DbMarkerMismatch(
            f"unparseable DB marker at {p}: {raw[:64]!r}"
        ) from None


def was_clean_shutdown(db_path: str, fs=None) -> bool:
    """Recovery.hs:24: the clean marker is REMOVED while running and
    written back on orderly shutdown; missing at start (after a first
    run) ⇒ crash ⇒ revalidate everything."""
    fs = fs if fs is not None else REAL_FS
    return fs.exists(os.path.join(db_path, CLEAN_SHUTDOWN))


def clear_clean_marker(db_path: str, fs=None) -> None:
    """A writer is running now: a crash must leave no clean marker."""
    fs = fs if fs is not None else REAL_FS
    p = os.path.join(db_path, CLEAN_SHUTDOWN)
    if fs.exists(p):
        fs.remove(p)


def write_clean_marker(db_path: str, fs=None) -> None:
    """Orderly shutdown: write the marker back. The write goes tmp →
    (chaos ``marker`` seam) → atomic rename, so the injected
    ``partial-rename@marker`` fault models the real crash shape: a
    durable tmp file, no final marker — the next open is dirty and a
    stray ``.tmp`` must be tolerated."""
    from ..testing import chaos

    fs = fs if fs is not None else REAL_FS
    p = os.path.join(db_path, CLEAN_SHUTDOWN)
    tmp = p + ".tmp"
    fs.write_bytes(tmp, b"clean\n")
    fs.fsync(tmp)
    chaos.fire("marker", marker=CLEAN_SHUTDOWN)
    fs.replace(tmp, p)


class StoreGuard:
    """The tools-plane open protocol bundled: lock → marker → dirty
    check. ``writer=True`` additionally clears the clean marker for
    the duration (a crash leaves the store dirty) and `close(clean=
    True)` writes it back. ``network_magic=None`` accepts whatever
    marker exists (creating the default on a virgin store) — the
    strict check is for callers that know their chain."""

    def __init__(self, db_path: str, network_magic: int | None = None,
                 fs=None, writer: bool = True):
        self.db_path = db_path
        self.network_magic = network_magic
        self.fs = fs
        self.writer = writer
        self.lock = DbLockFile(db_path, fs=fs)
        self.first_run = False
        self.opened_dirty = False
        self._open = False

    def open(self) -> "StoreGuard":
        vfs = self.fs if self.fs is not None else REAL_FS
        self.lock.acquire()
        try:
            self.first_run = not vfs.exists(
                os.path.join(self.db_path, "immutable")
            )
            self._check_or_create_marker()
            self.opened_dirty = (
                not self.first_run
                and not was_clean_shutdown(self.db_path, fs=self.fs)
            )
            if self.writer:
                clear_clean_marker(self.db_path, fs=self.fs)
            self._open = True
            return self
        except BaseException:
            self.lock.release()
            raise

    def _check_or_create_marker(self) -> None:
        """Verify the chain magic; CREATE a missing marker only in
        writer mode, and only with a magic the caller KNOWS (explicit
        `network_magic`) or on a virgin store this writer is about to
        forge. A magic-agnostic open of an existing marker-less store
        — a read-only analysis, OR a dirty-open escalation promoting
        it to writer mid-open — must never stamp the default: a
        testnet DB analysed once would be branded mainnet forever."""
        found = read_db_marker(self.db_path, fs=self.fs)
        want = self.network_magic
        if found is not None:
            if want is not None and found != want:
                raise DbMarkerMismatch(
                    f"DB is for magic {found}, node runs {want}"
                )
        elif self.writer and (want is not None or self.first_run):
            check_db_marker(
                self.db_path, want if want is not None else DEFAULT_MAGIC,
                fs=self.fs,
            )

    def promote_writer(self) -> None:
        """A reader discovered it must WRITE (dirty-open escalation
        forcing repair write-back; a synthesize that passed its
        refusal checks): adopt the writer half of the protocol
        mid-open — stamp a missing marker, clear the clean marker so
        a crash from here on leaves the store dirty."""
        if not self.writer:
            self.writer = True
            self._check_or_create_marker()
            clear_clean_marker(self.db_path, fs=self.fs)

    def close(self, clean: bool = True) -> None:
        """Release the protocol. ``clean=True`` (the orderly path —
        including a replay that ENDED at a validation error: the store
        itself is consistent) writes the marker back; ``clean=False``
        leaves the store dirty so the next open revalidates."""
        if not self._open:
            return
        self._open = False
        try:
            if self.writer and clean:
                write_clean_marker(self.db_path, fs=self.fs)
        finally:
            self.lock.release()

    def __enter__(self):
        return self.open()

    def __exit__(self, exc_type, exc, tb):
        # an exception unwinding through the guard is the crash shape:
        # writer mode leaves the store DIRTY (no clean marker), exactly
        # what forces the next open to deep-revalidate
        self.close(clean=exc_type is None)
        return False
