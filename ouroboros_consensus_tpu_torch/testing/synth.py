"""Host forger of Praos chains (the replay's test and smoke input).

Reference: `Cardano.Tools.DBSynthesizer`'s forging loop — per slot, check
leadership for every credential, forge and append the winner's block to
the ImmutableDB, threading the protocol state with the crypto-free
`reupdate`. Credentials derive deterministically from integer seeds; all
signing goes through the repo's C++ host crypto (`native.py`). For the
same seeds, parameters and limit, the chunk and index files are byte for
byte the JAX package's `tools/db_synthesizer.synthesize(vrf_backend="host")`
output (its draft-03 output under `OCT_VRF_BATCH=0` for
`proof_format="draft03"`).

The VRF proof format is an argument: "bc" forges 128-byte
batch-compatible proofs (Gamma ‖ U ‖ V ‖ s), "draft03" 80-byte ECVRF
draft-03 proofs (Gamma ‖ c ‖ s), and a callable `block_no -> 80 | 128`
switches format within one chain. Both formats certify the same output
beta, so the leader schedule does not depend on the format.

CompactSum KES (cardano-crypto-class `KES.CompactSum`): seeds split top
down (left = Blake2b-256(0x01 ‖ seed), right = Blake2b-256(0x02 ‖ seed)),
a node's vk is Blake2b-256(vk_left ‖ vk_right), and a signature is the
leaf Ed25519 signature ‖ leaf vk ‖ one sibling vk per level, bottom-up.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from fractions import Fraction
from functools import cached_property, lru_cache

from .. import native
from ..block.praos_block import Block, Header, HeaderBody, body_hash
from ..protocol import nonces, praos
from ..protocol.leader import is_leader
from ..protocol.praos import PraosParams, PraosState
from ..protocol.views import IndividualPoolStake, LedgerView, OCert, hash_key, hash_vrf_vk
from ..storage.immutable import ImmutableDB
from ..utils.hashes import blake2b_256


def _kes_left(seed: bytes) -> bytes:
    return blake2b_256(b"\x01" + seed)


def _kes_right(seed: bytes) -> bytes:
    return blake2b_256(b"\x02" + seed)


@lru_cache(maxsize=1 << 14)
def kes_derive_vk(seed: bytes, depth: int) -> bytes:
    """Verification key of the KES subtree rooted at `seed`."""
    if depth == 0:
        return native.ed25519_public(seed)
    return blake2b_256(
        kes_derive_vk(_kes_left(seed), depth - 1)
        + kes_derive_vk(_kes_right(seed), depth - 1)
    )


def kes_sign(seed: bytes, depth: int, period: int, msg: bytes) -> bytes:
    """CompactSum signature for `period` (0 <= period < 2^depth)."""
    if not 0 <= period < (1 << depth):
        raise ValueError(f"period {period} out of range for depth {depth}")
    if depth == 0:
        return native.ed25519_sign(seed, msg) + native.ed25519_public(seed)
    half = 1 << (depth - 1)
    s0, s1 = _kes_left(seed), _kes_right(seed)
    if period < half:
        return kes_sign(s0, depth - 1, period, msg) + kes_derive_vk(s1, depth - 1)
    return kes_sign(s1, depth - 1, period - half, msg) + kes_derive_vk(s0, depth - 1)


def _seed(tag: bytes, n: int) -> bytes:
    return blake2b_256(tag + n.to_bytes(8, "big"))


@dataclass(frozen=True)
class PoolCredentials:
    """One pool's signing identity (cold key, VRF key, KES tree)."""

    cold_seed: bytes
    vrf_seed: bytes
    kes_seed: bytes
    kes_depth: int

    @cached_property
    def vk_cold(self) -> bytes:
        return native.ed25519_public(self.cold_seed)

    @cached_property
    def vrf_vk(self) -> bytes:
        return native.ed25519_public(self.vrf_seed)

    @cached_property
    def kes_vk(self) -> bytes:
        return kes_derive_vk(self.kes_seed, self.kes_depth)

    @cached_property
    def pool_id(self) -> bytes:
        return hash_key(self.vk_cold)

    def make_ocert(self, counter: int, kes_period: int) -> OCert:
        oc = OCert(self.kes_vk, counter, kes_period, b"")
        return OCert(self.kes_vk, counter, kes_period,
                     native.ed25519_sign(self.cold_seed, oc.signable()))


def make_pool(n: int, kes_depth: int = 6) -> PoolCredentials:
    return PoolCredentials(
        _seed(b"cold", n), _seed(b"vrf", n), _seed(b"kes", n), kes_depth
    )


def make_ledger_view(pools: list[PoolCredentials]) -> LedgerView:
    """Equal stake for every pool."""
    share = Fraction(1, len(pools))
    return LedgerView(
        pool_distr={
            p.pool_id: IndividualPoolStake(share, hash_vrf_vk(p.vrf_vk))
            for p in pools
        }
    )


def forge_block(params: PraosParams, pool: PoolCredentials, *, slot: int,
                block_no: int, prev_hash: bytes | None, txs: tuple = (),
                ocert_counter: int = 0, vrf_output: bytes,
                vrf_proof: bytes) -> Block:
    """Assemble and KES-sign the block of a won slot. The OCert is issued
    at the containing evolution-window start, so 0 <= t < max evolutions."""
    kp = params.kes_period_of(slot)
    c0 = max(0, kp - (kp % params.max_kes_evolutions))
    ocert = pool.make_ocert(ocert_counter, c0)
    body = HeaderBody(
        block_no=block_no, slot=slot, prev_hash=prev_hash,
        issuer_vk=pool.vk_cold, vrf_vk=pool.vrf_vk,
        vrf_output=vrf_output, vrf_proof=vrf_proof,
        body_size=sum(len(t) for t in txs), body_hash=body_hash(txs),
        ocert=ocert,
    )
    kes_sig = kes_sign(pool.kes_seed, pool.kes_depth, kp - c0, body.signed_bytes)
    return Block(Header(body, kes_sig), tuple(txs))


def proof_length(proof_format, block_no: int) -> int:
    """The proof length (80 or 128) that `proof_format` gives block
    `block_no`: "draft03", "bc", or a callable block_no -> 80 | 128."""
    if callable(proof_format):
        n = proof_format(block_no)
    else:
        n = {"draft03": 80, "bc": 128}.get(proof_format)
    if n not in (80, 128):
        raise ValueError(f"unknown proof format {proof_format!r} at block {block_no}")
    return n


_PROVERS = {80: native.ecvrf_prove, 128: native.ecvrf_prove_bc}


def synthesize(db_path: str, params: PraosParams, pools: list[PoolCredentials],
               lview: LedgerView, n_blocks: int, chunk_size: int = 21600,
               txs_per_block: int = 0, proof_format="bc") -> PraosState:
    """Forge `n_blocks` blocks into `<db_path>/immutable`; -> final state.
    Per slot the first winning credential forges (one block per slot);
    `proof_format` picks each block's VRF proof format (module doc)."""
    proof_length(proof_format, 0)  # refuse an unknown format before forging
    imm = ImmutableDB(os.path.join(db_path, "immutable"), chunk_size=chunk_size)
    if not imm.is_empty:
        raise RuntimeError(f"refusing to forge into non-empty DB at {db_path}")
    st = PraosState()
    prev_hash = None
    block_no = slot = 0
    counters: dict[bytes, int] = {}
    while block_no < n_blocks:
        ticked = praos.tick(params, lview, slot, st)
        alpha = nonces.mk_input_vrf(slot, ticked.state.epoch_nonce)
        for pool in pools:
            entry = lview.pool_distr.get(pool.pool_id)
            if entry is None:
                continue
            prove = _PROVERS[proof_length(proof_format, block_no)]
            proof = prove(pool.vrf_seed, alpha)
            beta = native.proof_to_hash(proof)
            if not is_leader(nonces.vrf_leader_value(beta), entry.stake,
                             params.active_slot_coeff):
                continue
            n = counters.get(pool.pool_id, 0)
            txs = tuple(b"tx-%d-%d" % (slot, i) for i in range(txs_per_block))
            block = forge_block(
                params, pool, slot=slot, block_no=block_no,
                prev_hash=prev_hash, txs=txs, ocert_counter=n,
                vrf_output=beta, vrf_proof=proof,
            )
            imm.append_block(slot, block_no, block.hash_, block.bytes_)
            st = praos.reupdate(params, block.header.to_view(), slot, ticked)
            counters[pool.pool_id] = n
            prev_hash = block.hash_
            block_no += 1
            break
        slot += 1
    imm.flush()
    return st
