"""Praos header / ledger views — the exact inputs of header validation.

Reference: Praos/Views.hs:22-51 (`HeaderView`, `LedgerView`) and
cardano-protocol-tpraos `OCert`. A window of views comes as a list of
`HeaderView`s or as `ViewColumns`, their columnar twin, which the reader
builds from the native chunk scan without a Python object per header.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from fractions import Fraction
from functools import lru_cache
from typing import Mapping, Sequence

import numpy as np

from ..native_scan import _span_matrix
from ..utils.hashes import blake2b_224, blake2b_256


@lru_cache(maxsize=65536)
def hash_key(vk_cold: bytes) -> bytes:
    """KeyHash (Blake2b-224) of an Ed25519 cold verification key."""
    return blake2b_224(vk_cold)


def hash_vrf_vk(vrf_vk: bytes) -> bytes:
    """Blake2b-256 hash of a VRF verification key (pool registration)."""
    return blake2b_256(vrf_vk)


@dataclass(frozen=True)
class OCert:
    """Operational certificate: cold key delegates to a hot KES key. The
    DSIGN-signable form is vk_hot ‖ counter_be8 ‖ kes_period_be8."""

    vk_hot: bytes  # 32 — KES root verification key
    counter: int  # issue number
    kes_period: int  # start period c0
    sigma: bytes  # 64 — Ed25519 signature by the cold key

    def signable(self) -> bytes:
        return (
            self.vk_hot
            + self.counter.to_bytes(8, "big")
            + self.kes_period.to_bytes(8, "big")
        )


@dataclass(frozen=True)
class HeaderView:
    """Exactly the header fields validation consumes (Praos/Views.hs:22-39)."""

    prev_hash: bytes | None  # None = genesis
    vk_cold: bytes  # 32 — issuer cold key
    vrf_vk: bytes  # 32
    vrf_output: bytes  # 64 — certified VRF output beta
    vrf_proof: bytes  # ECVRF proof pi: 80 (draft-03) or 128 (batch-compat)
    ocert: OCert
    slot: int
    signed_bytes: bytes  # KES-signed representation (header body CBOR)
    kes_sig: bytes  # CompactSum signature (64 + 32 + 32*depth)


@dataclass
class ViewColumns:
    """A window of header views as row-major numpy columns, one row a
    header. Slicing (`vc[i:j]`) shares the buffers; `vc[i]` and
    `vc.views()` build HeaderViews, which only the paths that need one
    object per header call (a window with a failing lane, the generic
    staging of a list). The columns are rectangular by construction:
    `from_header_columns` and `from_views` return None when the
    KES-signed bodies or the signatures differ in width, and the caller
    keeps a HeaderView list for that window."""

    slot: np.ndarray  # [n] int64
    prev_hash: np.ndarray  # [n, 32] uint8
    has_prev: np.ndarray  # [n] uint8, 0 = genesis (prev_hash None)
    vk_cold: np.ndarray  # [n, 32] uint8
    vrf_vk: np.ndarray  # [n, 32] uint8
    vrf_output: np.ndarray  # [n, 64] uint8
    vrf_proof: np.ndarray  # [n, 128] uint8, zero-padded past the proof
    vrf_proof_len: np.ndarray  # [n] int64: 80 (draft-03) or 128 (bc)
    ocert_vk_hot: np.ndarray  # [n, 32] uint8
    ocert_counter: np.ndarray  # [n] int64
    ocert_kes_period: np.ndarray  # [n] int64
    ocert_sigma: np.ndarray  # [n, 64] uint8
    kes_sig: np.ndarray  # [n, 96 + 32 depth] uint8
    signed_bytes: np.ndarray  # [n, body_len] uint8

    def __len__(self) -> int:
        return int(self.slot.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ViewColumns(*(getattr(self, f.name)[i] for f in fields(self)))
        return self.view(int(i))

    def view(self, i: int) -> HeaderView:
        """Lane i as a HeaderView."""
        return HeaderView(
            prev_hash=self.prev_hash[i].tobytes() if self.has_prev[i] else None,
            vk_cold=self.vk_cold[i].tobytes(),
            vrf_vk=self.vrf_vk[i].tobytes(),
            vrf_output=self.vrf_output[i].tobytes(),
            vrf_proof=self.vrf_proof[i, : int(self.vrf_proof_len[i])].tobytes(),
            ocert=OCert(self.ocert_vk_hot[i].tobytes(), int(self.ocert_counter[i]),
                        int(self.ocert_kes_period[i]), self.ocert_sigma[i].tobytes()),
            slot=int(self.slot[i]),
            signed_bytes=self.signed_bytes[i].tobytes(),
            kes_sig=self.kes_sig[i].tobytes(),
        )

    def views(self) -> list[HeaderView]:
        """The window as HeaderViews (each column turned to bytes once,
        then sliced per row)."""

        def rows(a):
            w = a.shape[1]
            b = np.ascontiguousarray(a).tobytes()
            return [b[w * i: w * (i + 1)] for i in range(len(self))]

        prev, cold, vrf_vk, out = (rows(a) for a in (
            self.prev_hash, self.vk_cold, self.vrf_vk, self.vrf_output))
        proof, vk_hot, sigma, kes, body = (rows(a) for a in (
            self.vrf_proof, self.ocert_vk_hot, self.ocert_sigma, self.kes_sig,
            self.signed_bytes))
        return [
            HeaderView(
                prev_hash=prev[i] if has else None, vk_cold=cold[i], vrf_vk=vrf_vk[i],
                vrf_output=out[i], vrf_proof=proof[i][:plen],
                ocert=OCert(vk_hot[i], counter, period, sigma[i]),
                slot=slot, signed_bytes=body[i], kes_sig=kes[i],
            )
            for i, (has, plen, counter, period, slot) in enumerate(zip(
                self.has_prev.tolist(), self.vrf_proof_len.tolist(),
                self.ocert_counter.tolist(), self.ocert_kes_period.tolist(),
                self.slot.tolist()))
        ]

    @classmethod
    def concat(cls, parts: Sequence["ViewColumns"]) -> "ViewColumns | None":
        """Windows of one body and signature width as one; None when the
        widths differ."""
        if len(parts) == 1:
            return parts[0]
        if (len({p.signed_bytes.shape[1] for p in parts}) > 1
                or len({p.kes_sig.shape[1] for p in parts}) > 1):
            return None
        return cls(*(np.concatenate([getattr(p, f.name) for p in parts], axis=0)
                     for f in fields(cls)))

    @classmethod
    def from_header_columns(cls, hc, lo: int = 0, hi: int | None = None
                            ) -> "ViewColumns | None":
        """Rows [lo, hi) of a native_scan.HeaderColumns chunk scan; None
        when their OCert sigma, KES signature or signed-body spans differ
        in width (or a sigma is not 64 bytes)."""
        hi = hc.n if hi is None else hi
        if lo == 0 and hi == hc.n:
            sigma, kes, body = hc.ocert_sigma_mat, hc.kes_sig_mat, hc.signed_bytes_mat
        else:
            buf = hc._buf_u8
            sigma = _span_matrix(buf, hc.sig_off[lo:hi], hc.sig_len[lo:hi])
            kes = _span_matrix(buf, hc.kes_off[lo:hi], hc.kes_len[lo:hi])
            body = _span_matrix(buf, hc.sgn_off[lo:hi], hc.sgn_len[lo:hi])
        if sigma is None or kes is None or body is None or sigma.shape[1] != 64:
            return None
        s = slice(lo, hi)
        return cls(
            slot=hc.slot[s], prev_hash=hc.prev_hash[s], has_prev=hc.has_prev[s],
            vk_cold=hc.issuer_vk[s], vrf_vk=hc.vrf_vk[s], vrf_output=hc.vrf_output[s],
            vrf_proof=hc.vrf_proof[s], vrf_proof_len=hc.vrf_proof_len[s],
            ocert_vk_hot=hc.ocert_vk[s], ocert_counter=hc.ocert_counter[s],
            ocert_kes_period=hc.ocert_kes_period[s],
            ocert_sigma=sigma, kes_sig=kes, signed_bytes=body,
        )

    @classmethod
    def pieces_from_header_columns(cls, hc) -> "list[ViewColumns] | None":
        """A chunk scan as the fewest rectangular pieces: cut wherever a
        span width changes (a CBOR integer growing a byte moves the body
        width a few times a chain). None when a run of one width still
        does not columnarize (a sigma not 64 bytes)."""
        widths = np.stack([hc.sig_len, hc.kes_len, hc.sgn_len], axis=1)
        cuts = np.flatnonzero((widths[1:] != widths[:-1]).any(axis=1)) + 1
        bounds = [0, *cuts.tolist(), hc.n]
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            vc = cls.from_header_columns(hc, lo, hi)
            if vc is None:
                return None
            out.append(vc)
        return out

    @classmethod
    def from_views(cls, hvs: Sequence[HeaderView]) -> "ViewColumns | None":
        """Columns of a HeaderView list; None when the list is empty or its
        KES signatures, sigmas or signed bodies differ in width."""
        n = len(hvs)
        if n == 0:
            return None
        kw, sw = len(hvs[0].kes_sig), len(hvs[0].signed_bytes)
        if any(len(hv.kes_sig) != kw or len(hv.signed_bytes) != sw
               or len(hv.ocert.sigma) != 64 for hv in hvs):
            return None
        plen = np.asarray([len(hv.vrf_proof) for hv in hvs], np.int64)
        proof = np.zeros((n, 128), np.uint8)
        for i, hv in enumerate(hvs):
            proof[i, : plen[i]] = np.frombuffer(hv.vrf_proof, np.uint8)

        def col(get, w):
            return np.frombuffer(b"".join(get(hv) for hv in hvs),
                                 np.uint8).reshape(n, w).copy()

        return cls(
            slot=np.asarray([hv.slot for hv in hvs], np.int64),
            prev_hash=col(lambda hv: hv.prev_hash if hv.prev_hash is not None
                          else bytes(32), 32),
            has_prev=np.asarray([hv.prev_hash is not None for hv in hvs], np.uint8),
            vk_cold=col(lambda hv: hv.vk_cold, 32),
            vrf_vk=col(lambda hv: hv.vrf_vk, 32),
            vrf_output=col(lambda hv: hv.vrf_output, 64),
            vrf_proof=proof, vrf_proof_len=plen,
            ocert_vk_hot=col(lambda hv: hv.ocert.vk_hot, 32),
            ocert_counter=np.asarray([hv.ocert.counter for hv in hvs], np.int64),
            ocert_kes_period=np.asarray([hv.ocert.kes_period for hv in hvs], np.int64),
            ocert_sigma=col(lambda hv: hv.ocert.sigma, 64),
            kes_sig=col(lambda hv: hv.kes_sig, kw),
            signed_bytes=col(lambda hv: hv.signed_bytes, sw),
        )


@dataclass(frozen=True)
class IndividualPoolStake:
    """Relative stake + registered VRF key hash (SL.IndividualPoolStake)."""

    stake: Fraction
    vrf_key_hash: bytes  # Blake2b-256 of the pool's VRF vk


@dataclass(frozen=True)
class LedgerView:
    """Praos ledger view (Praos/Views.hs:41-51): the pool stake
    distribution plus the envelope size limits."""

    pool_distr: Mapping[bytes, IndividualPoolStake]  # KeyHash -> stake
    max_header_size: int = 1100
    max_body_size: int = 90112
    protocol_version: tuple[int, int] = (9, 0)
