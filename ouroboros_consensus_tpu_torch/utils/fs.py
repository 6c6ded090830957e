"""HasFS: the filesystem seam of the storage layer.

Reference: the `fs-api` package's `HasFS m h` record (re-exported via
`Ouroboros.Consensus.Storage.FS`) and `fs-sim`'s in-memory
implementation with fault injection (`Test/Util/FS/Sim/MockFS.hs`,
`Test/Util/Corruption.hs`). The JAX package's utils/fs.py is the
port's reference; this is its copy, method for method.

  * `RealFS` — a thin shim over `os`/`open`, rooted at a directory.
  * `MockFS` — in-memory files with an fsync watermark. `crash()`
    reverts every file to its last-synced prefix and then tears the
    unsynced suffix at a caller-chosen fraction (the torn-write model);
    `corrupt_byte` / `truncate_file` / `wipe` are the corruption
    commands. Its advisory-lock registry stands in for `flock`, and a
    crash clears it, as the kernel drops a dead process's locks.

Paths are plain strings (POSIX-joined); no handle stays open across
calls, so each operation stands alone, which is what makes the mock's
crash model tractable.
"""

from __future__ import annotations

import os
import posixpath


class FsError(OSError):
    """Mock analog of the IO errors the real FS raises (FsError in
    fs-api): storage code catches OSError, so subclass it."""


class RealFS:
    """HasFS over the real filesystem, rooted at `root` (the reference's
    `ioHasFS` with a MountPoint)."""

    def __init__(self, root: str = "/"):
        self.root = root

    def _p(self, path: str) -> str:
        if self.root == "/":
            return path
        # a MountPoint must CONTAIN its paths: absolute inputs are
        # re-rooted, not allowed to escape (os.path.join would discard
        # the root for an absolute second argument)
        return os.path.join(self.root, path.lstrip("/"))

    # -- directories ---------------------------------------------------------

    def makedirs(self, path: str) -> None:
        os.makedirs(self._p(path), exist_ok=True)

    def listdir(self, path: str) -> list[str]:
        return os.listdir(self._p(path))

    def isdir(self, path: str) -> bool:
        return os.path.isdir(self._p(path))

    # -- queries -------------------------------------------------------------

    def exists(self, path: str) -> bool:
        return os.path.exists(self._p(path))

    def getsize(self, path: str) -> int:
        return os.path.getsize(self._p(path))

    # -- reads ---------------------------------------------------------------

    def read_bytes(self, path: str) -> bytes:
        with open(self._p(path), "rb") as f:
            return f.read()

    def read_at(self, path: str, offset: int, size: int) -> bytes:
        with open(self._p(path), "rb") as f:
            f.seek(offset)
            return f.read(size)

    # -- writes --------------------------------------------------------------

    def append(self, path: str, data: bytes) -> None:
        with open(self._p(path), "ab") as f:
            f.write(data)

    def write_bytes(self, path: str, data: bytes) -> None:
        with open(self._p(path), "wb") as f:
            f.write(data)

    def write_atomic(self, path: str, data: bytes) -> None:
        """tmp-write + fsync + rename — the snapshot/index discipline."""
        tmp = self._p(path) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._p(path))

    def replace(self, src: str, dst: str) -> None:
        """Atomic rename (the tail of write_atomic, for callers that
        staged + fsynced their own tmp file)."""
        os.replace(self._p(src), self._p(dst))

    def truncate(self, path: str, size: int) -> None:
        with open(self._p(path), "r+b") as f:
            f.truncate(size)

    def remove(self, path: str) -> None:
        if os.path.exists(self._p(path)):
            os.remove(self._p(path))

    def fsync(self, path: str) -> None:
        fd = os.open(self._p(path), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


class _MockFile:
    __slots__ = ("data", "synced", "durable")

    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.synced = len(data)  # fsync watermark (crash keeps ≤ this)
        # has the file's EXISTENCE been made durable (fsync/atomic
        # rename)? A created-but-never-synced file's directory entry
        # need not survive a crash.
        self.durable = False


class MockFS:
    """In-memory HasFS with crash/corruption injection (fs-sim analog)."""

    def __init__(self):
        self._files: dict[str, _MockFile] = {}
        self._dirs: set[str] = {""}
        # flock analog: held advisory locks live OUTSIDE the file data —
        # a crash (all processes die) releases them all, exactly like
        # the kernel dropping flocks on process death
        self.advisory_locks: set[str] = set()

    @staticmethod
    def _norm(path: str) -> str:
        p = posixpath.normpath(path).lstrip("/")
        return "" if p == "." else p

    # -- directories ---------------------------------------------------------

    def makedirs(self, path: str) -> None:
        p = self._norm(path)
        parts = p.split("/") if p else []
        for i in range(len(parts)):
            self._dirs.add("/".join(parts[: i + 1]))

    def listdir(self, path: str) -> list[str]:
        p = self._norm(path)
        if p not in self._dirs:
            raise FsError(f"no such directory: {path}")
        prefix = p + "/" if p else ""
        out = set()
        for f in self._files:
            if f.startswith(prefix):
                out.add(f[len(prefix):].split("/")[0])
        for d in self._dirs:
            if d != p and d.startswith(prefix):
                out.add(d[len(prefix):].split("/")[0])
        return sorted(out)

    def isdir(self, path: str) -> bool:
        return self._norm(path) in self._dirs

    # -- queries -------------------------------------------------------------

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        return p in self._files or p in self._dirs

    def getsize(self, path: str) -> int:
        f = self._files.get(self._norm(path))
        if f is None:
            raise FsError(f"no such file: {path}")
        return len(f.data)

    # -- reads ---------------------------------------------------------------

    def read_bytes(self, path: str) -> bytes:
        f = self._files.get(self._norm(path))
        if f is None:
            raise FsError(f"no such file: {path}")
        return bytes(f.data)

    def read_at(self, path: str, offset: int, size: int) -> bytes:
        return self.read_bytes(path)[offset : offset + size]

    # -- writes --------------------------------------------------------------

    def append(self, path: str, data: bytes) -> None:
        f = self._files.setdefault(self._norm(path), _MockFile())
        f.data.extend(data)

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._norm(path)
        f = self._files.get(p)
        if f is None:
            self._files[p] = _MockFile(data)
            self._files[p].synced = 0
        else:
            f.data = bytearray(data)
            f.synced = min(f.synced, 0)

    def write_atomic(self, path: str, data: bytes) -> None:
        # rename after fsync: atomic + durable in one step
        p = self._norm(path)
        nf = _MockFile(data)
        nf.synced = len(data)
        nf.durable = True
        self._files[p] = nf

    def replace(self, src: str, dst: str) -> None:
        # atomic rename: the destination inherits the source file whole
        # (synced/durable state included)
        s = self._norm(src)
        f = self._files.pop(s, None)
        if f is None:
            raise FsError(f"no such file: {src}")
        self._files[self._norm(dst)] = f

    def truncate(self, path: str, size: int) -> None:
        f = self._files.get(self._norm(path))
        if f is None:
            raise FsError(f"no such file: {path}")
        del f.data[size:]
        f.synced = min(f.synced, size)

    def remove(self, path: str) -> None:
        self._files.pop(self._norm(path), None)

    def fsync(self, path: str) -> None:
        f = self._files.get(self._norm(path))
        if f is not None:
            f.synced = len(f.data)
            f.durable = True

    # -- fault injection (fs-sim / Test/Util/Corruption.hs) ------------------

    def crash(self, keep_fraction: float = 0.0) -> None:
        """Simulated process/OS crash: unsynced suffixes survive only up
        to `keep_fraction` of their length (0 = lose all unsynced bytes,
        1 = lose nothing) — the torn-write model. Files whose EXISTENCE
        was never made durable (no fsync/atomic write) and that lose all
        their bytes vanish entirely — which is also how a crashed
        process's advisory lock file disappears."""
        self.advisory_locks.clear()  # every holder died with the crash
        for name in list(self._files):
            f = self._files[name]
            if len(f.data) > f.synced:
                keep = f.synced + int((len(f.data) - f.synced) * keep_fraction)
                del f.data[keep:]
            if not f.durable and not f.data:
                del self._files[name]

    def corrupt_byte(self, path: str, offset: int, xor: int = 0xFF) -> None:
        f = self._files[self._norm(path)]
        if 0 <= offset < len(f.data):
            f.data[offset] ^= xor

    def truncate_file(self, path: str, size: int) -> None:
        self.truncate(path, size)

    def wipe(self, path: str) -> None:
        """Remove a file or a whole directory tree (the directory node
        itself included — q-s-m's wipe command semantics)."""
        p = self._norm(path)
        for k in [k for k in self._files if k == p or k.startswith(p + "/")]:
            del self._files[k]
        for d in [d for d in self._dirs if d == p or d.startswith(p + "/")]:
            if d:  # never drop the root
                self._dirs.discard(d)

    def files(self) -> list[str]:
        return sorted(self._files)


REAL_FS = RealFS()
