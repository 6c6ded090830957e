"""Batched Ed25519 verification (cofactorless, RFC 8032), the verify half
of the reference's ops/ed25519_batch.py (:27-117, :192-210).

Per lane: decompress A, reject a non-canonical s, h = SHA-512(R ‖ A ‖ M)
mod L over the lane's own SHA-512 blocks, P = s·B − h·A, and accept iff
the canonical compression of P equals the signature's 32 R bytes. A valid
R decompresses to exactly one point whose compression is itself, and a
non-canonical or off-curve R equals no canonical compression, so the
byte compare is the reference's decompress-then-compare. Failures are
verdict lanes, never exceptions. Messages of different lengths share a
batch (per-lane block counts).

On the card the lanes run through the hand-written `ed_verify` kernel
(ops/pk/kernels.ed_verify, csrc/ed_verify.cu); CPU tensors take its plain
PyTorch twin. The sign half is the forge's `ed_sign` kernel
(ops/pk/kernels.ed_sign). The host's sequential verifier is
native.ed25519_verify (native/hostcrypto.cpp).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve
from . import stage_np as _stage
from .pk import kernels as pk_kernels

Ed25519Batch = _stage.Ed25519Batch


def stage_np(pks: Sequence[bytes], sigs: Sequence[bytes],
             msgs: Sequence[bytes]) -> Ed25519Batch:
    """(pk, sig, msg) triples -> batch-first host columns: pk, R, s [B, 32]
    uint8, the padded R ‖ A ‖ M [B, NB, 128] uint8 with NB the longest
    message's block count, and each lane's own count [B] int32."""
    if not len(pks) == len(sigs) == len(msgs):
        raise ValueError("pks, sigs and msgs differ in length")
    return _stage.stage_ed(pks, sigs, msgs)


def limb_columns(batch: Ed25519Batch, device) -> tuple:
    """The staged columns on `device` in the kernel's limb-first int32
    layout (lanes last): pk, r, s [32, B], hblocks [NB, 128, B], hnblocks
    [1, B]. The uint8 columns cross to the device and widen there. A lane
    block count outside 1..NB raises a ValueError."""
    dev = torch.device(device)
    nb = batch.hblocks.shape[1]
    if len(batch.hnblocks) and not (1 <= batch.hnblocks.min() and batch.hnblocks.max() <= nb):
        raise ValueError(f"ed25519_batch: a message's SHA-512 block count lies outside "
                         f"1..{nb} (got {batch.hnblocks.min()}..{batch.hnblocks.max()})")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(torch.int32)

    return (up(batch.pk).T.contiguous(), up(batch.r).T.contiguous(),
            up(batch.s).T.contiguous(), up(batch.hblocks).permute(1, 2, 0).contiguous(),
            up(batch.hnblocks).reshape(1, -1).contiguous())


def verify_batch(pks: Sequence[bytes], sigs: Sequence[bytes], msgs: Sequence[bytes],
                 device=None) -> np.ndarray:
    """-> [B] bool, lane i = Ed25519 verify of sigs[i] over msgs[i] under
    pks[i]. `device` None is the card (raises without CUDA); "cpu" runs the
    plain twin."""
    dev = resolve(device)
    if not len(pks):
        return np.zeros((0,), bool)
    ok = pk_kernels.ed_verify(*limb_columns(stage_np(pks, sigs, msgs), dev))
    return ok[0].cpu().numpy() != 0
