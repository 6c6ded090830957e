"""The columnar sidecar (``NNNNN.cols``) of an ImmutableDB chunk.

A sidecar holds one chunk's header columns already in
`protocol/views.ViewColumns` shape, sealed to the chunk's bytes, so that
a replay builds its windows from the mapped file with no header scan.
The format is the JAX package's byte for byte (its
`storage/sidecar.py`), so that either package reads the other's files.

Format v1 (all little-endian):

    header   magic ``OCTCOLS1``, version, flags, n, kes_w, sgn_w,
             chunk_len, chunk_crc32, payload_crc32, layout digest
             (Blake2b-256 of the column plan below: a layout change
             reads as stale, never as wrong columns)
    payload  the fixed-width column blobs of `_FIXED_COLS`, one after
             another: the ViewColumns fields, `header_end` and
             `body_hash` (the body-hash compare without a scan), and the
             int32 (offset, length) spans of the three variable-width
             fields. When every row has one KES-signature and one
             signed-body width (FLAG_UNIFORM), the kes_sig and
             signed_bytes matrices follow, and the reader never touches
             the chunk's bytes for columns.

A sidecar is trusted no further than its seal: `load_sidecar` checks the
live chunk's length and CRC-32 and the payload's CRC-32 on every open
(``stale`` on a mismatch, or on a layout, version or entry-count
change), a short or unreadable file is ``torn``, a missing one ``miss``;
only ``hit`` returns columns. A FLAG_WALKED seal was built over bytes
that a full integrity walk had passed (forge time), so a hit on it
skips the per-block CRC sweep: the chunk CRC shows the bytes are the
walked ones. Sidecars are written only by writers: the forge
(`backfill_store`), db_truncater's repair, and a replay that opened the
store as a writer (validate_all=True, `repair`, or a dirty open), which
backfills the chunks it had to scan; a read-only replay never writes one.

Every file operation goes through the fs seam (utils/fs.py: `fs=None` is
the real filesystem). The chaos seams (testing/chaos.py) are the
reference's: ``sidecar-torn@build:N`` lands a torn prefix at the final
name, ``sigkill@build:N`` kills the process between the tmp write and
the rename, ``sidecar-stale@open:N`` makes the Nth probe say stale. None
of them may change a verdict: a rejected sidecar costs one scan.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import struct
from dataclasses import dataclass, field

import numpy as np

from .. import native, native_scan
from ..testing import chaos
from ..utils.fs import REAL_FS, RealFS
from .immutable import sidecar_name

MAGIC = b"OCTCOLS1"
VERSION = 1
FLAG_UNIFORM = 1
FLAG_WALKED = 2

# magic, version, flags, n, kes_w, sgn_w, chunk_len, chunk_crc,
# payload_crc, layout digest
_HEADER = struct.Struct("<8sIIIIIQII32s")
HEADER_SIZE = _HEADER.size

SIDECAR_OUTCOMES = ("hit", "miss", "stale", "rebuilt", "torn")

# the column plan: name, numpy dtype, row width (elements); the payload
# is these blobs in order, then (FLAG_UNIFORM) kes_sig [n, kes_w] and
# signed_bytes [n, sgn_w]
_FIXED_COLS = (
    ("slot", "<i8", 1),
    ("prev_hash", "u1", 32),
    ("has_prev", "u1", 1),
    ("vk_cold", "u1", 32),
    ("vrf_vk", "u1", 32),
    ("vrf_output", "u1", 64),
    ("vrf_proof", "u1", 128),
    ("vrf_proof_len", "<i8", 1),
    ("ocert_vk_hot", "u1", 32),
    ("ocert_counter", "<i8", 1),
    ("ocert_kes_period", "<i8", 1),
    ("ocert_sigma", "u1", 64),
    ("header_end", "<i8", 1),
    ("body_hash", "u1", 32),
    ("sig_off", "<i4", 1),
    ("sig_len", "<i4", 1),
    ("kes_off", "<i4", 1),
    ("kes_len", "<i4", 1),
    ("sgn_off", "<i4", 1),
    ("sgn_len", "<i4", 1),
)

_LAYOUT = "v1;" + ",".join(
    f"{name}:{dt}x{w}" for name, dt, w in _FIXED_COLS
) + ";uniform:kes_sig,signed_bytes"
LAYOUT_DIGEST = hashlib.blake2b(_LAYOUT.encode(), digest_size=32).digest()

_ROW_BYTES = sum(np.dtype(dt).itemsize * w for _, dt, w in _FIXED_COLS)


def _crc32(data) -> int:
    """The seals' CRC-32 (zlib's, by the host crypto library)."""
    return native.crc32(data)


def sidecar_path(db_dir: str, chunk: int) -> str:
    return os.path.join(db_dir, sidecar_name(chunk))


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_COUNTS = {k: 0 for k in SIDECAR_OUTCOMES}


def record(outcome: str) -> None:
    """Count one probe or build outcome."""
    _COUNTS[outcome] += 1


def counters() -> dict:
    """The outcome counts of this process since the last reset."""
    return dict(_COUNTS)


def reset_counters() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def build_bytes(hc, chunk_bytes, walked: bool = False) -> bytes | None:
    """One chunk's `native_scan.HeaderColumns` as a sealed sidecar, or
    None when the chunk does not columnarize (no entries, an OCert sigma
    that is not 64 bytes, spans past int32): the scan owns such a chunk,
    and a missing sidecar is always correct."""
    n = int(hc.n)
    if n == 0:
        return None
    if not bool((np.asarray(hc.sig_len) == 64).all()):
        return None
    if int(hc.sgn_off.max()) + int(hc.sgn_len.max()) >= 2**31:
        return None
    buf = hc._buf_u8
    sigma = np.ascontiguousarray(native_scan._span_matrix(buf, hc.sig_off, hc.sig_len))
    uniform = (np.unique(np.asarray(hc.kes_len)).size == 1
               and np.unique(np.asarray(hc.sgn_len)).size == 1)
    kes_w = int(hc.kes_len[0]) if uniform else 0
    sgn_w = int(hc.sgn_len[0]) if uniform else 0
    cols = {
        "slot": hc.slot, "prev_hash": hc.prev_hash, "has_prev": hc.has_prev,
        "vk_cold": hc.issuer_vk, "vrf_vk": hc.vrf_vk, "vrf_output": hc.vrf_output,
        "vrf_proof": hc.vrf_proof, "vrf_proof_len": hc.vrf_proof_len,
        "ocert_vk_hot": hc.ocert_vk, "ocert_counter": hc.ocert_counter,
        "ocert_kes_period": hc.ocert_kes_period, "ocert_sigma": sigma,
        "header_end": hc.header_end, "body_hash": hc.body_hash,
        "sig_off": hc.sig_off, "sig_len": hc.sig_len,
        "kes_off": hc.kes_off, "kes_len": hc.kes_len,
        "sgn_off": hc.sgn_off, "sgn_len": hc.sgn_len,
    }
    parts = []
    for name, dt, w in _FIXED_COLS:
        a = np.ascontiguousarray(cols[name], dtype=np.dtype(dt))
        if a.shape != ((n,) if w == 1 else (n, w)):
            return None
        parts.append(a.tobytes())
    flags = FLAG_WALKED if walked else 0
    if uniform:
        kes = native_scan._span_matrix(buf, hc.kes_off, hc.kes_len)
        sgn = native_scan._span_matrix(buf, hc.sgn_off, hc.sgn_len)
        if kes is None or sgn is None:
            kes_w = sgn_w = 0
        else:
            flags |= FLAG_UNIFORM
            parts.append(np.ascontiguousarray(kes, np.uint8).tobytes())
            parts.append(np.ascontiguousarray(sgn, np.uint8).tobytes())
    payload = b"".join(parts)
    header = _HEADER.pack(MAGIC, VERSION, flags, n, kes_w, sgn_w, len(chunk_bytes),
                          _crc32(chunk_bytes), _crc32(payload), LAYOUT_DIGEST)
    return header + payload


def write_sidecar(db_dir: str, chunk: int, blob: bytes, fs=None) -> bool:
    """Land a sealed sidecar at its name through `fs.write_atomic` (tmp
    ``NNNNN.cols.tmp``, fsync, atomic rename: a crash leaves the old file
    or the new one, never a torn one at the name; a stranded tmp is swept
    by the next writer open). The sidecar-build chaos seam fires here.
    -> True when the sealed sidecar landed."""
    fs = fs if fs is not None else REAL_FS
    path = sidecar_path(db_dir, chunk)
    kind = chaos.sidecar_fault("sidecar-build", chunk=chunk)
    if kind == "sidecar-torn":
        cut = min(len(blob) - 1, max(HEADER_SIZE + 7, len(blob) // 3))
        fs.write_bytes(path, blob[:cut])
        return False
    if kind == "sigkill":
        import signal

        fs.write_bytes(path + ".tmp", blob)
        os.kill(os.getpid(), signal.SIGKILL)
    fs.write_atomic(path, blob)
    return True


def backfill(db_dir: str, chunk: int, hc, chunk_bytes, walked: bool = False,
             fs=None) -> bool:
    """Build and write chunk `chunk`'s sidecar from a scan in hand.
    `walked` stamps FLAG_WALKED: pass it only when a full integrity walk
    of these bytes backs the seal. True when a sidecar landed; an
    unwritable one is a missed shortcut, not an error (the scan stays
    correct)."""
    blob = build_bytes(hc, chunk_bytes, walked=walked)
    if blob is None:
        return False
    try:
        return write_sidecar(db_dir, chunk, blob, fs=fs)
    except OSError:
        return False


def backfill_store(imm, walked: bool = False) -> int:
    """Write the sidecar of every chunk of a writer's ImmutableDB that
    lacks a fresh one (the forge calls this after its last flush, with
    `walked`). Chunks with a fresh seal are left alone; chunks the scan
    cannot parse get none. -> the number of sidecars written."""
    wrote = 0
    for n, entries in imm.chunk_entries():
        try:
            data = imm.read_chunk(n)
        except OSError:
            continue
        sc, _outcome = load_sidecar(imm.path, n, data, len(entries), fs=imm.fs)
        if sc is not None:
            continue
        try:
            hc = native_scan.extract_headers(data, [e.offset for e in entries])
        except native_scan.MalformedBlock:
            continue
        if backfill(imm.path, n, hc, data, walked=walked, fs=imm.fs):
            record("rebuilt")
            wrote += 1
    return wrote


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _payload_size(n: int, kes_w: int, sgn_w: int, flags: int) -> int:
    size = n * _ROW_BYTES
    if flags & FLAG_UNIFORM:
        size += n * (kes_w + sgn_w)
    return size


def _map_bytes(fs, path: str):
    """The file mapped read-only on the real filesystem (pages come in as
    the columns are read), a plain read through any other fs; b"" when
    it vanished or is empty. The arrays over a map hold it open; it is
    unmapped when the last of them goes."""
    if not isinstance(fs, RealFS):
        try:
            return fs.read_bytes(path)
        except OSError:
            return b""
    try:
        with open(fs._p(path), "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (OSError, ValueError):
        return b""
    return memoryview(mm)


@dataclass
class SidecarColumns:
    """One loaded, seal-checked sidecar: the fixed columns by name (views
    of the mapped file) and, for a uniform chunk, the kes_sig and
    signed_bytes matrices."""

    n: int
    uniform: bool
    arrays: dict
    kes_sig: np.ndarray | None = None
    signed_bytes: np.ndarray | None = None
    walked: bool = False
    _keepalive: object = field(default=None, repr=False)

    def pieces(self, data) -> list | None:
        """The chunk as rectangular `ViewColumns` pieces, cut where a span
        width changes, as `ViewColumns.pieces_from_header_columns` cuts
        a scan: a uniform chunk is one piece of the mapped matrices; the
        pieces of another gather their KES signatures and signed bodies
        from the chunk's bytes `data` by the sealed spans."""
        from ..protocol.views import ViewColumns

        a = self.arrays

        def piece(lo, hi, kes, sgn):
            return ViewColumns(
                slot=a["slot"][lo:hi], prev_hash=a["prev_hash"][lo:hi],
                has_prev=a["has_prev"][lo:hi], vk_cold=a["vk_cold"][lo:hi],
                vrf_vk=a["vrf_vk"][lo:hi], vrf_output=a["vrf_output"][lo:hi],
                vrf_proof=a["vrf_proof"][lo:hi], vrf_proof_len=a["vrf_proof_len"][lo:hi],
                ocert_vk_hot=a["ocert_vk_hot"][lo:hi],
                ocert_counter=a["ocert_counter"][lo:hi],
                ocert_kes_period=a["ocert_kes_period"][lo:hi],
                ocert_sigma=a["ocert_sigma"][lo:hi], kes_sig=kes, signed_bytes=sgn,
            )

        if self.uniform:
            return [piece(0, self.n, self.kes_sig, self.signed_bytes)]
        buf = np.frombuffer(data, np.uint8)
        kes_len, sgn_len, kes_off, sgn_off = (
            a[k].astype(np.int64) for k in ("kes_len", "sgn_len", "kes_off", "sgn_off"))
        widths = np.stack([kes_len, sgn_len], axis=1)
        cuts = np.flatnonzero((widths[1:] != widths[:-1]).any(axis=1)) + 1
        bounds = [0, *cuts.tolist(), self.n]
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            kes = native_scan._span_matrix(buf, kes_off[lo:hi], kes_len[lo:hi])
            sgn = native_scan._span_matrix(buf, sgn_off[lo:hi], sgn_len[lo:hi])
            if kes is None or sgn is None:
                return None
            out.append(piece(lo, hi, kes, sgn))
        return out


def load_sidecar(db_dir: str, chunk: int, chunk_bytes, n_entries: int,
                 fs=None) -> tuple[SidecarColumns | None, str]:
    """Probe and map chunk `chunk`'s sidecar against the live chunk
    bytes -> (columns, "hit") when every seal holds, else (None, "miss")
    for no file, "torn" for a short or unreadable one, "stale" for a seal,
    layout or entry-count mismatch (or the sidecar-open chaos seam)."""
    fs = fs if fs is not None else REAL_FS
    path = sidecar_path(db_dir, chunk)
    if chaos.sidecar_fault("sidecar-open", chunk=chunk) == "sidecar-stale":
        return None, "stale"
    if not fs.exists(path):
        return None, "miss"
    buf = _map_bytes(fs, path)
    if len(buf) < HEADER_SIZE:
        return None, "torn"
    (magic, version, flags, n, kes_w, sgn_w, chunk_len, chunk_crc,
     payload_crc, digest) = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC or version != VERSION:
        return None, "torn"
    end = HEADER_SIZE + _payload_size(n, kes_w, sgn_w, flags)
    if len(buf) < end:
        return None, "torn"
    if digest != LAYOUT_DIGEST or n != n_entries:
        return None, "stale"
    if chunk_len != len(chunk_bytes) or chunk_crc != _crc32(chunk_bytes):
        return None, "stale"
    if payload_crc != _crc32(buf[HEADER_SIZE:end]):
        return None, "stale"
    arrays: dict = {}
    off = HEADER_SIZE
    for name, dt, w in _FIXED_COLS:
        dtype = np.dtype(dt)
        a = np.frombuffer(buf, dtype=dtype, count=n * w, offset=off)
        arrays[name] = a if w == 1 else a.reshape(n, w)
        off += n * w * dtype.itemsize
    kes = sgn = None
    if flags & FLAG_UNIFORM:
        kes = np.frombuffer(buf, np.uint8, count=n * kes_w, offset=off).reshape(n, kes_w)
        off += n * kes_w
        sgn = np.frombuffer(buf, np.uint8, count=n * sgn_w, offset=off).reshape(n, sgn_w)
    return SidecarColumns(n=n, uniform=bool(flags & FLAG_UNIFORM), arrays=arrays,
                          kes_sig=kes, signed_bytes=sgn,
                          walked=bool(flags & FLAG_WALKED), _keepalive=buf), "hit"


# ---------------------------------------------------------------------------
# the body-hash check from the sealed columns
# ---------------------------------------------------------------------------


def integrity_batch_hook(sc: SidecarColumns):
    """`open.default_check_integrity_batch` without the scan: (data,
    entries) -> the index of the first block whose Blake2b-256 over
    [header end, block end) differs from its sealed body hash and that
    the per-block check (`open.default_check_integrity`) also fails
    (len(entries) when none does). A walked seal's hit calls it alone;
    an unwalked one's runs it under `ImmutableDB.deep_check_loaded`, after the
    CRC sweep."""

    def hook(data, entries) -> int:
        from .open import default_check_integrity

        m = len(entries)
        ends = np.asarray([e.offset + e.size for e in entries], np.int64)
        digests = native.blake2b_spans(data, sc.arrays["header_end"][:m], ends)
        bad = (digests != sc.arrays["body_hash"][:m]).any(axis=1)
        for i in np.flatnonzero(bad).tolist():
            e = entries[i]
            if not default_check_integrity(data[e.offset: e.offset + e.size]):
                return i
        return m

    return hook

