"""The forge's election and assembly, split where the chain dependency is.

Reference: ouroboros_consensus_tpu/protocol/forge.py:78-560 (the
`runForge` loop of Tools/DBSynthesizer/Forging.hs:54-57, split in two):

* **Election has no chain dependency.** The VRF input is mkInputVRF(slot,
  η0) and η0 is constant within an epoch, so every (slot, pool) pair of
  an election window is decided at once: on the card by the
  `forge_sweep` kernel (ops/pk/kernels.py, csrc/forge.cu; its plain twin
  on the CPU), which proves each pair, returns both proof serialisations
  and brackets the leader value against the pool's threshold rows; or on
  the host by native per-pair proves and one vectorised bracket. Only
  the ambiguous band (empty in practice) takes the exact Fraction check.
  The first winning pool of a slot forges, in list order.
* **Assembly keeps one chain dependency**: each body embeds the previous
  header's hash inside the KES-signed bytes. Everything else is hoisted:
  the OCert signatures dedupe per (pool, counter, evolution window) and
  are signed in one `ed_sign` launch (device engine), the KES leaf seed
  and sibling path per (pool, period) come from `host_kes.leaf_path`. A
  block costs a CBOR body, one native Ed25519 leaf signature and one
  Blake2b.

Every engine, the per-slot loop included, assembles through
BlockAssembler, the one definition of the header format and of the
OCert's evolution window; the bytes are the JAX package's
(tests/test_torch_forge.py).
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..block.praos_block import Block, Header, HeaderBody, body_hash
from ..ops import host_kes
from ..ops.pk import kernels as pk_kernels
from ..ops.pk import prove as pk_prove
from ..utils.hashes import blake2b_256
from . import batch as pbatch
from . import nonces
from .leader import check_leader_value
from .praos import PraosParams
from .views import LedgerView, OCert

# (slot, pool) pairs of an election window, at most: the reference's four
# buckets of 4,096 lanes (its FORGE_BUCKET; the port pads nothing)
WINDOW_PAIRS = 4 * 4096


class Elected(NamedTuple):
    """One won slot: the first winning pool (its index in the credentials
    list), β and the slot's proof in the formats asked for ({80: draft-03,
    128: batch-compatible})."""

    slot: int
    pool: int
    beta: bytes
    proofs: dict


class PoolStaging(NamedTuple):
    """The pools' expanded VRF keys, staged once per synthesis run."""

    x: np.ndarray  # [P, 32] clamped scalars
    prefix: np.ndarray  # [P, 32] nonce prefixes
    pk: np.ndarray  # [P, 32] VRF verification keys


def stage_pools(pools) -> PoolStaging:
    return PoolStaging(*pk_prove.stage_prove_np([p.vrf_seed for p in pools]))


def pool_thresholds(params: PraosParams, lview: LedgerView, pools):
    """(lo [P, 32], hi [P, 32] uint8, sigmas): each pool's clamped
    big-endian leader bracket (batch.threshold_rows) under `lview`; a
    pool missing from the view has stake 0 and never leads."""
    f = Fraction(params.active_slot_coeff)
    lo, hi, sigmas = [], [], []
    for pool in pools:
        entry = lview.pool_distr.get(pool.pool_id)
        sigma = entry.stake if entry is not None else Fraction(0)
        a, b = pbatch.threshold_rows(Fraction(sigma), f)
        lo.append(a)
        hi.append(b)
        sigmas.append(sigma)
    rows = (np.frombuffer(b"".join(r), np.uint8).reshape(len(pools), 32).copy()
            for r in (lo, hi))
    return (*rows, sigmas)


def window_slots(n_pools: int) -> int:
    """Slots of an election window: WINDOW_PAIRS pairs, at least one slot.
    The blocks limit's overshoot and `n_slots` depend on it."""
    return max(1, WINDOW_PAIRS // max(1, n_pools))


def _first_winners(params: PraosParams, slots, sigmas, win: np.ndarray, amb: np.ndarray,
                   lv_of, beta_of, proofs_of) -> list[Elected]:
    """The election's tail: the ambiguous band by the exact Fraction
    check, then the first winning pool of each slot (the pairs are
    slot-major, so list order)."""
    p = len(sigmas)
    win = win.copy()
    f = Fraction(params.active_slot_coeff)
    for idx in np.flatnonzero(amb).tolist():
        win[idx] = check_leader_value(int.from_bytes(lv_of(idx), "big"), sigmas[idx % p], f)
    winm = win.reshape(len(slots), p)
    first = winm.argmax(axis=1)
    out = []
    for j in np.flatnonzero(winm.any(axis=1)).tolist():
        idx = j * p + int(first[j])
        out.append(Elected(int(slots[j]), int(first[j]), beta_of(idx), proofs_of(idx)))
    return out


def _leader_rows(betas: list) -> np.ndarray:
    return np.frombuffer(b"".join(blake2b_256(b"L" + b) for b in betas),
                         np.uint8).reshape(len(betas), 32)


def _elect_window_host(params: PraosParams, pools, thr, slots, eta0,
                       formats: frozenset) -> list[Elected]:
    """The host engine: a native prove per pair, then one vectorised
    bracket over the window. Each pair is proved batch-compatible (β is
    the same in both formats); a winner that may need a draft-03 proof
    is proved again in that format."""
    lo, hi, sigmas = thr
    p = len(pools)
    proofs, betas = [], []
    for s in slots:
        alpha = nonces.mk_input_vrf(int(s), eta0)
        for pool in pools:
            pi = native.ecvrf_prove_bc(pool.vrf_seed, alpha)
            proofs.append(pi)
            betas.append(native.proof_to_hash(pi))
    lv = _leader_rows(betas)
    ns = len(slots)
    win = pbatch._lt_be_rows(lv, np.tile(lo, (ns, 1)))
    amb = ~win & pbatch._lt_be_rows(lv, np.tile(hi, (ns, 1)))

    def proofs_of(idx):
        out = {128: proofs[idx]}
        if 80 in formats:
            alpha = nonces.mk_input_vrf(int(slots[idx // p]), eta0)
            out[80] = native.ecvrf_prove(pools[idx % p].vrf_seed, alpha)
        return out

    return _first_winners(params, slots, sigmas, win, amb, lambda i: lv[i].tobytes(),
                          lambda i: betas[i], proofs_of)


def _elect_window_device(params: PraosParams, table: torch.Tensor, sigmas, slots, eta0,
                         formats: frozenset) -> list[Elected]:
    """The device engine: the window's pairs through one `forge_sweep`
    launch on the pool table's device (its plain twin on the CPU), the
    verdicts and columns copied back once."""
    dev = table.device
    nonce = None if eta0 is None else torch.frombuffer(bytearray(eta0), dtype=torch.uint8).to(dev)
    rows = pk_kernels.forge_sweep(table, int(slots[0]), len(slots) * table.shape[0],
                                  nonce).cpu().numpy()
    col = {k: rows[:, a:b] for k, (a, b) in pk_prove.COLUMNS.items()}
    win = col["win"][:, 0] != 0
    amb = col["amb"][:, 0] != 0
    beta = col["beta"]

    def proofs_of(idx):
        parts = [col[k][idx] for k in ("gamma", "c16", "u", "v", "s")]
        return {n: pk_prove.encode_proofs_np(*parts, n == 128).tobytes() for n in formats}

    return _first_winners(params, slots, sigmas, win, amb,
                          lambda i: blake2b_256(b"L" + beta[i].tobytes()),
                          lambda i: beta[i].tobytes(), proofs_of)


def elect_window(params: PraosParams, pools, thr, slots, eta0, engine: str,
                 table: torch.Tensor | None = None,
                 formats: frozenset = frozenset({128})) -> list[Elected]:
    """One election window `slots` (a range within one epoch) under the
    epoch nonce `eta0`, with the pools' threshold rows `thr`
    (pool_thresholds): engine "device" through the sweep over `table`,
    the pool table on its device (device_table), "host" with native
    proves. Each winner carries its proof in the `formats` (80, 128)."""
    if engine == "device":
        return _elect_window_device(params, table, thr[2], slots, eta0, formats)
    if engine == "host":
        return _elect_window_host(params, pools, thr, slots, eta0, formats)
    raise ValueError(f"unknown election engine {engine!r}")


def device_table(stg: PoolStaging, thr, device) -> torch.Tensor:
    """The sweep's pool table [P, 160] uint8 on `device`."""
    table = pk_prove.pool_table(stg.x, stg.prefix, stg.pk, thr[0], thr[1])
    return torch.from_numpy(table).to(device)


def sign_ocerts_batch(pools, triples, device) -> dict:
    """The OCert issue signatures of the (pool index, counter, evolution
    window start) triples in one `ed_sign` launch on `device` (its plain
    twin on the CPU) -> {triple: OCert}."""
    triples = sorted(triples)
    if not triples:
        return {}
    protos = [OCert(pools[i].kes_vk, n, kp0, b"") for i, n, kp0 in triples]
    staged = pk_prove.stage_sign_np([pools[i].cold_seed for i, _n, _k in triples],
                                    [oc.signable() for oc in protos])
    sigs = pk_kernels.ed_sign(*(torch.from_numpy(a).to(device) for a in staged)).cpu().numpy()
    return {t: OCert(oc.vk_hot, oc.counter, oc.kes_period, sigs[k].tobytes())
            for k, (t, oc) in enumerate(zip(triples, protos))}


class BlockAssembler:
    """The sequential tail with what does not depend on the message
    cached: the OCert per (pool, counter, evolution window) and the KES
    leaf seed and path per (pool, period). A block costs its CBOR body,
    one Ed25519 leaf signature and one Blake2b. The OCert is issued at
    the start of the slot's evolution window (ocert_window), so the KES
    evolution t is below max_kes_evolutions."""

    def __init__(self, params: PraosParams, pools):
        self.params = params
        self.pools = pools
        self.ocerts: dict = {}

    def ocert_window(self, slot: int) -> int:
        """The evolution window's first KES period, where the OCert of a
        block at `slot` is issued (0 <= t < max evolutions)."""
        kp = self.params.kes_period_of(slot)
        return max(0, kp - (kp % self.params.max_kes_evolutions))

    def ocert(self, pool_i: int, counter: int, kp0: int) -> OCert:
        key = (pool_i, counter, kp0)
        if key not in self.ocerts:
            self.ocerts[key] = self.pools[pool_i].make_ocert(counter, kp0)
        return self.ocerts[key]

    def forge(self, pool_i: int, *, slot: int, block_no: int, prev_hash: bytes | None,
              txs: tuple, ocert_counter: int, vrf_output: bytes, vrf_proof: bytes) -> Block:
        pool = self.pools[pool_i]
        kp = self.params.kes_period_of(slot)
        kp0 = self.ocert_window(slot)
        body = HeaderBody(
            block_no=block_no, slot=slot, prev_hash=prev_hash,
            issuer_vk=pool.vk_cold, vrf_vk=pool.vrf_vk,
            vrf_output=vrf_output, vrf_proof=vrf_proof,
            body_size=sum(len(t) for t in txs), body_hash=body_hash(txs),
            ocert=self.ocert(pool_i, ocert_counter, kp0),
        )
        kes_sig = host_kes.sign(pool.kes_seed, pool.kes_depth, kp - kp0, body.signed_bytes)
        return Block(Header(body, kes_sig), tuple(txs))
