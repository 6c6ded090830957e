"""ctypes binding of the repo's C++ host crypto (native/hostcrypto.cpp).

Built with g++ on first use into the port's build directory (listed in
.gitignore), through a temporary name and an atomic rename so that
concurrent first uses never load a half-written library. The slice uses
the sign side (Ed25519 keys and signatures, draft-03 and
batch-compatible ECVRF proofs) for the forger, `validate_praos` as the
native replay backend, `ed25519_verify` as the native backend's Ed25519
verifier (the Byron segments of the mixed-era composite) and
`blake2b_spans` for the reader's body-hash sweep.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_REPO, "native", "hostcrypto.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SO = os.path.join(BUILD_DIR, "libhostcrypto.so")

_lib = None


def build_shared(src: str, so: str, opt: str = "-O3") -> str:
    """Compile `src` into the shared library `so` unless an up-to-date
    one exists: g++ into a temporary name in BUILD_DIR, then an atomic
    rename (concurrent first uses never load a half-written library).
    Raises on a failed build; -> the library's path."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", opt, "-shared", "-fPIC", "-o", tmp, src],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def build() -> str:
    """The host crypto library, built on first use; -> its path."""
    return build_shared(SRC, SO)


def lib():
    """The loaded library, building it on first use (raises on failure)."""
    global _lib
    if _lib is not None:
        return _lib
    so = ctypes.CDLL(build())
    so.oc_ed25519_public.restype = None
    so.oc_ed25519_public.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    so.oc_ed25519_verify.restype = ctypes.c_int
    so.oc_ed25519_verify.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    so.oc_ed25519_sign.restype = None
    so.oc_ed25519_sign.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    so.oc_ecvrf_prove.restype = None
    so.oc_ecvrf_prove.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    so.oc_ecvrf_prove_bc.restype = None
    so.oc_ecvrf_prove_bc.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    so.oc_ecvrf_proof_to_hash.restype = ctypes.c_int
    so.oc_ecvrf_proof_to_hash.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    so.oc_validate_praos2.restype = ctypes.c_long
    so.oc_validate_praos2.argtypes = (
        [ctypes.c_long] + [ctypes.c_void_p] * 6 + [ctypes.c_long]
        + [ctypes.c_void_p] * 4 + [ctypes.c_long]
        + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_long)]
    )
    so.oc_crc32.restype = ctypes.c_uint32
    so.oc_crc32.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    so.oc_blake2b_spans.restype = None
    so.oc_blake2b_spans.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int,
    ]
    _lib = so
    return _lib


def ed25519_public(seed: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    lib().oc_ed25519_public(seed, out)
    return out.raw


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    out = ctypes.create_string_buffer(64)
    lib().oc_ed25519_sign(seed, msg, len(msg), out)
    return out.raw


def ed25519_verify(pk: bytes, sig: bytes, msg: bytes) -> bool:
    """Cofactorless RFC 8032 verify of one signature (the native backend's
    verifier: the reference's native_loader.native_ed25519_verify)."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    return bool(lib().oc_ed25519_verify(pk, sig, msg, len(msg)))


def ecvrf_prove(seed: bytes, alpha: bytes) -> bytes:
    """80-byte draft-03 proof (Gamma ‖ c ‖ s)."""
    out = ctypes.create_string_buffer(80)
    lib().oc_ecvrf_prove(seed, alpha, len(alpha), out)
    return out.raw


def ecvrf_prove_bc(seed: bytes, alpha: bytes) -> bytes:
    """128-byte batch-compatible proof (Gamma ‖ U ‖ V ‖ s)."""
    out = ctypes.create_string_buffer(128)
    lib().oc_ecvrf_prove_bc(seed, alpha, len(alpha), out)
    return out.raw


def proof_to_hash(pi: bytes) -> bytes:
    """beta = SHA-512(suite ‖ 3 ‖ 8·Gamma) of a proof."""
    out = ctypes.create_string_buffer(64)
    if not lib().oc_ecvrf_proof_to_hash(pi, out):
        raise ValueError("proof Gamma does not decode")
    return out.raw


def crc32(data, value: int = 0) -> int:
    """CRC-32 of `data` (any buffer) continuing from `value`: zlib's
    polynomial and result bit for bit, by the library's PCLMULQDQ fold
    where the CPU has it."""
    buf = np.frombuffer(data, np.uint8)
    return int(lib().oc_crc32(buf.ctypes.data, buf.size, value & 0xFFFFFFFF))


def blake2b_spans(data: bytes, starts, ends, digest_size: int = 32) -> np.ndarray:
    """Blake2b of every span data[starts[i]:ends[i]) in one C call ->
    [n, digest_size] uint8."""
    buf = np.frombuffer(data, np.uint8)
    s = np.ascontiguousarray(starts, np.int64)
    e = np.ascontiguousarray(ends, np.int64)
    if s.shape != e.shape or (len(s) and (s.min() < 0 or e.max() > len(buf))):
        raise ValueError("spans out of the buffer")
    out = np.empty((len(s), digest_size), np.uint8)
    if len(s):
        lib().oc_blake2b_spans(buf.ctypes.data, len(s), s.ctypes.data,
                               e.ctypes.data, out.ctypes.data, digest_size)
    return out


def validate_praos(
    cold_vk, ocert_sig, ocert_msg, kes_vk, kes_t, kes_sig, kes_depth,
    body: bytes, body_off, vrf_vk, vrf_proof, vrf_alpha, vrf_output,
):
    """Sequential C++ verification of a window, stopping at the first
    failing header: -> (first_bad or -1, kind 1:ocert|2:kes|3:vrf,
    leader_values [n, 32] uint8, etas [n, 32] uint8)."""
    n = len(cold_vk)
    lv = np.zeros((n, 32), np.uint8)
    eta = np.zeros((n, 32), np.uint8)

    def u8(a):
        return np.ascontiguousarray(a, np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    arrs = [u8(cold_vk), u8(ocert_sig), u8(ocert_msg), u8(kes_vk),
            np.ascontiguousarray(kes_t, np.int64), u8(kes_sig)]
    proof = u8(vrf_proof)
    tail = [u8(vrf_vk), proof]
    tail2 = [u8(vrf_alpha), u8(vrf_output)]
    boff = np.ascontiguousarray(body_off, np.int64)
    body_arr = np.frombuffer(body, np.uint8) if body else np.zeros(1, np.uint8)
    kind = ctypes.c_long(0)
    rc = lib().oc_validate_praos2(
        n, *[ptr(a) for a in arrs], kes_depth,
        ptr(body_arr), ptr(boff), *[ptr(a) for a in tail], proof.shape[-1],
        *[ptr(a) for a in tail2], ptr(lv), ptr(eta), ctypes.byref(kind),
    )
    return int(rc), int(kind.value), lv, eta
