"""The forge's prove and sign side: host staging and the plain PyTorch
twins of the two forge kernels (csrc/forge.cu), beside verify.py.

  forge_sweep_plain — the leader-election sweep of one election window:
                      lane i is pool i % P at slot slot0 + i / P; alpha =
                      Blake2b-256(slot_be8 ‖ η0) (the 8 bytes alone under
                      the neutral nonce), the ECVRF prove (H =
                      8·Elligator2(SHA-512(suite ‖ 1 ‖ pk ‖ alpha)), Γ = x·H,
                      k = SHA-512(prefix ‖ H) mod L, U = k·B, V = k·H, c =
                      SHA-512(suite ‖ 2 ‖ H ‖ Γ ‖ U ‖ V)[:16], s = k + c·x
                      mod L), β = SHA-512(suite ‖ 3 ‖ 8Γ), and the leader
                      value Blake2b-256('L' ‖ β) against the pool's
                      threshold rows (win, and amb: neither a win nor a
                      certain loss).
  ed_sign_plain     — RFC 8032 Ed25519 signing of SHA-512-padded messages:
                      r = SHA-512(prefix ‖ M) mod L, R = r·B, h = SHA-512(R
                      ‖ A ‖ M) mod L, s = r + h·a mod L.

Both twins do the kernel's integer steps in the kernel's order, in the
port's radix (ops/pk/field.py, curve.py, hashes.py, scalar.py), so twin
and kernel agree byte for byte. The staging (`stage_prove_np`,
`pool_table`, `stage_sign_np`) expands each seed on the host, as the
reference's `ops/ecvrf_batch.stage_prove_np` (:317) and
`ops/ed25519_batch.stage_sign_np` (:120) do; `encode_proofs_np` splices
the sweep's columns into either wire proof.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ... import native
from . import curve as pc
from . import field as fe
from . import hashes as ph
from . import scalar as ps
from . import verify as pv

# the pool table's row: x ‖ prefix ‖ pk ‖ lo ‖ hi (csrc/forge.cuh FS_POOL)
POOL_BYTES = 160
# the sweep's output row (csrc/forge.cuh FS_OUT): Γ ‖ c16 ‖ U ‖ V ‖ s ‖ β ‖
# win ‖ amb
OUT_BYTES = 210
COLUMNS = {"gamma": (0, 32), "c16": (32, 48), "u": (48, 80), "v": (80, 112),
           "s": (112, 144), "beta": (144, 208), "win": (208, 209), "amb": (209, 210)}


def expand_seed(seed: bytes) -> tuple[bytes, bytes, bytes]:
    """An Ed25519 / ECVRF secret seed -> (x, prefix, pk): the clamped
    scalar (little-endian, 256 bits, not reduced mod L), the nonce
    prefix, the public key (RFC 8032 5.1.5)."""
    h = hashlib.sha512(seed).digest()
    x = bytearray(h[:32])
    x[0] &= 248
    x[31] &= 127
    x[31] |= 64
    return bytes(x), h[32:], native.ed25519_public(seed)


def stage_prove_np(seeds) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each VRF seed expanded -> (x, prefix, pk), [P, 32] uint8 each."""
    rows = [expand_seed(s) for s in seeds]
    return tuple(np.frombuffer(b"".join(r[k] for r in rows), np.uint8)
                 .reshape(len(rows), 32).copy() for k in range(3))


def pool_table(x, prefix, pk, lo, hi) -> np.ndarray:
    """The sweep's pool table [P, POOL_BYTES] uint8 from five [P, 32]
    columns (lo, hi: the big-endian threshold rows)."""
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(c, np.uint8).reshape(-1, 32) for c in (x, prefix, pk, lo, hi)], axis=1))


def encode_proofs_np(g, c16, u, v, s, batch_compat: bool) -> np.ndarray:
    """The sweep's columns -> wire proofs: [B, 128] (batch-compatible,
    Γ ‖ U ‖ V ‖ s) or [B, 80] (draft-03, Γ ‖ c ‖ s) uint8."""
    cols = (g, u, v, s) if batch_compat else (g, c16, s)
    return np.concatenate([np.asarray(c, np.uint8) for c in cols], axis=-1)


def pad_sha512_np(msgs, nb: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """SHA-512 padding of byte strings -> (blocks [B, NB, 128] uint8,
    block counts [B] int32); NB the most any message needs, or `nb`."""
    counts = [(len(m) + 17 + 127) // 128 for m in msgs]
    nb = max(counts, default=1) if nb is None else nb
    out = np.zeros((len(msgs), nb, 128), np.uint8)
    flat = out.reshape(len(msgs), -1)
    for i, (m, c) in enumerate(zip(msgs, counts)):
        padded = m + b"\x80" + bytes(128 * c - len(m) - 17) + (8 * len(m)).to_bytes(16, "big")
        flat[i, : len(padded)] = np.frombuffer(padded, np.uint8)
    return out, np.asarray(counts, np.int32)


def stage_sign_np(seeds, msgs):
    """Seeds and messages -> (a, A [B, 32] uint8; rblocks [B, NB, 128]
    uint8, rnblocks [B] int32: prefix ‖ M padded; hblocks, hnblocks: a
    64-byte hole ‖ M padded, the hole R ‖ A spliced by the kernel)."""
    exp = [expand_seed(s) for s in seeds]
    a = np.frombuffer(b"".join(e[0] for e in exp), np.uint8).reshape(-1, 32).copy()
    pk = np.frombuffer(b"".join(e[2] for e in exp), np.uint8).reshape(-1, 32).copy()
    rmsgs = [e[1] + m for e, m in zip(exp, msgs)]
    hmsgs = [bytes(64) + m for m in msgs]
    nb = max([(len(m) + 17 + 127) // 128 for m in rmsgs + hmsgs], default=1)
    rb, rn = pad_sha512_np(rmsgs, nb)
    hb, hn = pad_sha512_np(hmsgs, nb)
    return a, pk, rb, rn, hb, hn


def _lane_columns(pools: torch.Tensor, b: int):
    """Per-lane [32, b] columns of the pool table, lane i reading row i % P."""
    p = pools.shape[0]
    idx = torch.arange(b, device=pools.device) % p
    rows = pools.to(torch.int64)[idx]  # [b, POOL_BYTES]
    return [rows[:, o: o + 32].T for o in range(0, POOL_BYTES, 32)]


def forge_sweep_plain(pools: torch.Tensor, slot0: int, b: int, nonce) -> torch.Tensor:
    """The sweep's twin: pools [P, POOL_BYTES] uint8, lanes 0 .. b - 1,
    nonce [32] uint8 or None (neutral) -> [b, OUT_BYTES] uint8."""
    dev = pools.device
    x, prefix, pk, lo, hi = _lane_columns(pools, b)
    slots = slot0 + torch.arange(b, device=dev, dtype=torch.int64) // pools.shape[0]
    data = [(slots >> (56 - 8 * k)) & 255 for k in range(8)]
    if nonce is not None:
        data += list(nonce.to(torch.int64).reshape(32, 1).expand(32, b))
    alpha = ph.blake2b_fixed(torch.stack(data), 32)
    h = pv.hash_to_curve(pk, alpha)
    # the Γ warp
    gamma = pc.scalar_mul_w4(fe.nibbles_msb(x, 32), h)
    # the k warp
    (henc,) = pc.compress_many([h])
    k = fe.reduce512(ph.sha512_fixed(torch.cat([prefix, henc])))
    kb = pc.base_mul_w8(k)
    kh = pc.scalar_mul_w4(fe.nibbles_msb(k, 32), h)
    # the finish
    g_enc, u_enc, v_enc, g8_enc = pc.compress_many([gamma, kb, kh, pc.mul_cofactor(gamma)])
    c16 = ph.sha512_fixed(torch.cat([pv._rows([pv.SUITE, 0x02], b, dev), henc, g_enc, u_enc,
                                     v_enc]))[:16]
    s = fe.reduce512(ps.carry_bytes(k + ps.mul_mod_l(c16, x)))
    beta = ph.sha512_fixed(torch.cat([pv._rows([pv.SUITE, 0x03], b, dev), g8_enc]))
    lv = ph.blake2b_fixed(torch.cat([pv._rows([ord("L")], b, dev), beta]), 32)
    win = pv._lt_be(lv, lo)
    amb = ~win & pv._lt_be(lv, hi)
    out = torch.cat([g_enc, c16, u_enc, v_enc, s, beta, win[None].to(torch.int64),
                     amb[None].to(torch.int64)])
    return out.T.to(torch.uint8).contiguous()


def _sha512_lanes(blocks: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """SHA-512 of [B, NB, 128] padded blocks with per-lane counts -> [64, B]."""
    return ph.sha512_blocks(blocks.to(torch.int64).permute(1, 2, 0), counts.to(torch.int64))


def ed_sign_plain(a, a_enc, rblocks, rnblocks, hblocks, hnblocks) -> torch.Tensor:
    """The signer's twin over stage_sign_np's arrays as tensors -> [B, 64]
    uint8 signatures R ‖ s."""
    r = fe.reduce512(_sha512_lanes(rblocks, rnblocks))
    (r_enc,) = pc.compress_many([pc.base_mul_w8(r)])
    hb = hblocks.to(torch.int64).clone()
    hb[:, 0, :32] = r_enc.T
    hb[:, 0, 32:64] = a_enc.to(torch.int64)
    h = fe.reduce512(_sha512_lanes(hb, hnblocks))
    s = fe.reduce512(ps.carry_bytes(r + ps.mul_mod_l(h, a.to(torch.int64).T)))
    return torch.cat([r_enc, s]).T.to(torch.uint8).contiguous()
