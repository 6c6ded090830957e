"""Host staging of the three Praos checks into batch-first numpy columns.

The generic staging of a window (protocol/batch.stage) for the windows
the packed staging does not take: any body width per lane, fields that
the KES-signed body does not embed, integers past int32. Each helper
columnarizes one check's inputs; SHA-512 messages are padded on the host
into per-lane blocks, masked by per-lane block counts on the device.

Column forms are the stage kernels' batch-first inputs (see
ops/pk/kernels.staged_to_limb_first): [B, n] uint8 byte rows,
[B, NB, 128] uint8 padded SHA-512 blocks, [B] int32 block counts and
KES periods, [B, depth, 32] uint8 Merkle siblings.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

BLOCK = 128


def nblocks_for_len(n: int) -> int:
    """SHA-512 blocks of an n-byte message, padding included."""
    return (n + 1 + 16 + BLOCK - 1) // BLOCK


def pad_messages_np(msgs: Sequence[bytes]):
    """Messages -> (blocks [B, NB, 128] uint8, nblocks [B] int32): standard
    SHA-512 padding (0x80, zeros, 128-bit big-endian bit length), NB the
    longest message's count; blocks past a lane's count are zero and
    masked on the device."""
    nb = max((nblocks_for_len(len(m)) for m in msgs), default=1)
    n = len(msgs)
    buf = np.zeros((n, nb * BLOCK), np.uint8)
    nblocks = np.zeros((n,), np.int32)
    for i, m in enumerate(msgs):
        k = nblocks_for_len(len(m))
        buf[i, :len(m)] = np.frombuffer(m, np.uint8)
        buf[i, len(m)] = 0x80
        buf[i, k * BLOCK - 16: k * BLOCK] = np.frombuffer(
            (8 * len(m)).to_bytes(16, "big"), np.uint8)
        nblocks[i] = k
    return buf.reshape(n, nb, BLOCK), nblocks


def pad_matrix_np(mat: np.ndarray):
    """pad_messages_np for a [B, n] uint8 matrix of messages of one
    length (the columnar staging's whole message columns): the same
    bytes, without a bytes object per row."""
    b, n = mat.shape
    k = nblocks_for_len(n)
    buf = np.zeros((b, k * BLOCK), np.uint8)
    buf[:, :n] = mat
    buf[:, n] = 0x80
    buf[:, k * BLOCK - 16:] = np.frombuffer((8 * n).to_bytes(16, "big"), np.uint8)
    return buf.reshape(b, k, BLOCK), np.full((b,), k, np.int32)


def byte_rows(parts: Sequence[bytes], n: int) -> np.ndarray:
    """Equal-length byte strings -> [B, n] uint8."""
    if any(len(p) != n for p in parts):
        raise ValueError(f"expected {n}-byte rows")
    return np.frombuffer(b"".join(parts), np.uint8).reshape(len(parts), n).copy()


class Ed25519Batch(NamedTuple):
    pk: np.ndarray  # [B, 32] uint8
    r: np.ndarray  # [B, 32] uint8
    s: np.ndarray  # [B, 32] uint8
    hblocks: np.ndarray  # [B, NB, 128] uint8 — padded R ‖ A ‖ M
    hnblocks: np.ndarray  # [B] int32


def stage_ed(pks: Sequence[bytes], sigs: Sequence[bytes],
             msgs: Sequence[bytes]) -> Ed25519Batch:
    """(pk, sig, msg) triples -> the ed stage's columns."""
    pk = byte_rows(pks, 32)
    rs = byte_rows(sigs, 64)
    hblocks, hnblocks = pad_messages_np(
        [sig[:32] + p + m for p, sig, m in zip(pks, sigs, msgs)])
    return Ed25519Batch(pk, rs[:, :32].copy(), rs[:, 32:].copy(), hblocks, hnblocks)


class KesBatch(NamedTuple):
    vk: np.ndarray  # [B, 32] uint8 — declared root vk
    period: np.ndarray  # [B] int32
    r: np.ndarray  # [B, 32] uint8 — leaf signature R
    s: np.ndarray  # [B, 32] uint8 — leaf signature s
    vk_leaf: np.ndarray  # [B, 32] uint8
    siblings: np.ndarray  # [B, depth, 32] uint8, bottom-up
    hblocks: np.ndarray  # [B, NB, 128] uint8 — padded R ‖ vk_leaf ‖ M
    hnblocks: np.ndarray  # [B] int32


def stage_kes(vks: Sequence[bytes], periods: Sequence[int],
              msgs: Sequence[bytes], sigs: Sequence[bytes],
              depth: int) -> KesBatch:
    """CompactSum signatures (ed sig 64 ‖ leaf vk 32 ‖ depth siblings)
    -> the kes stage's columns."""
    b = len(vks)
    sg = byte_rows(sigs, 64 + 32 + 32 * depth)
    hblocks, hnblocks = pad_messages_np(
        [sig[:32] + sig[64:96] + m for sig, m in zip(sigs, msgs)])
    return KesBatch(
        byte_rows(vks, 32), np.asarray(periods, np.int32), sg[:, :32].copy(),
        sg[:, 32:64].copy(), sg[:, 64:96].copy(),
        sg[:, 96:].reshape(b, depth, 32).copy(), hblocks, hnblocks)


class EcvrfBatch(NamedTuple):
    """Draft-03 (80-byte) proofs: Γ ‖ c ‖ s."""

    pk: np.ndarray  # [B, 32] uint8
    gamma: np.ndarray  # [B, 32] uint8
    c: np.ndarray  # [B, 16] uint8
    s: np.ndarray  # [B, 32] uint8
    alpha: np.ndarray  # [B, 32] uint8


class EcvrfBcBatch(NamedTuple):
    """Batch-compatible (128-byte) proofs: Γ ‖ U ‖ V ‖ s; the challenge is
    derived on the device from the announced U, V."""

    pk: np.ndarray  # [B, 32] uint8
    gamma: np.ndarray  # [B, 32] uint8
    u: np.ndarray  # [B, 32] uint8
    v: np.ndarray  # [B, 32] uint8
    s: np.ndarray  # [B, 32] uint8
    alpha: np.ndarray  # [B, 32] uint8


def stage_vrf(pks: Sequence[bytes], proofs: Sequence[bytes],
              alphas: Sequence[bytes]) -> EcvrfBatch | EcvrfBcBatch:
    """A proof column of one format (80 or 128 bytes, read off the
    length) -> the VRF stages' columns."""
    plen = len(proofs[0]) if proofs else 80
    if plen not in (80, 128):
        raise ValueError(f"proof length {plen} is neither 80 nor 128")
    pr = byte_rows(proofs, plen)
    pk, alpha = byte_rows(pks, 32), byte_rows(alphas, 32)
    if plen == 128:
        return EcvrfBcBatch(pk, pr[:, :32].copy(), pr[:, 32:64].copy(),
                            pr[:, 64:96].copy(), pr[:, 96:].copy(), alpha)
    return EcvrfBatch(pk, pr[:, :32].copy(), pr[:, 32:48].copy(),
                      pr[:, 48:].copy(), alpha)
