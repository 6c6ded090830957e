"""Host forger of Praos chains (the replay's test and smoke input).

Reference: `Cardano.Tools.DBSynthesizer`'s forging loop — per slot, check
leadership for every credential, forge and append the winner's block to
the ImmutableDB, threading the protocol state with the crypto-free
`reupdate`. Credentials derive deterministically from integer seeds; all
signing goes through the repo's C++ host crypto (`native.py`). For the
same seeds, parameters and limit, the chunk and index files are byte for
byte the JAX package's `tools/db_synthesizer.synthesize(vrf_backend="host")`
output (its draft-03 output under `OCT_VRF_BATCH=0` for
`proof_format="draft03"`), and so are the walked sidecars (`NNNNN.cols`,
storage/sidecar.py) sealed for every chunk after the last flush.

The VRF proof format is an argument: "bc" forges 128-byte
batch-compatible proofs (Gamma ‖ U ‖ V ‖ s), "draft03" 80-byte ECVRF
draft-03 proofs (Gamma ‖ c ‖ s), and a callable `block_no -> 80 | 128`
switches format within one chain. Both formats certify the same output
beta, so the leader schedule does not depend on the format.

KES signatures are CompactSum (ops/host_kes.py). Blocks are assembled
by protocol/forge.BlockAssembler, the one definition of the header
format, whatever the engine.

`synthesize` is the per-slot loop, the "loop" engine of
tools/db_synthesizer.py (which also has the windowed "device" and "host"
engines, with the same bytes).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from functools import cached_property

from .. import native
from ..ops import host_kes
from ..protocol.praos import PraosParams, PraosState
from ..protocol.views import IndividualPoolStake, LedgerView, OCert, hash_key, hash_vrf_vk
from ..utils.hashes import blake2b_256


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
        return host_kes.derive_vk(self.kes_seed, self.kes_depth)

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


def make_ledger_view(pools: list[PoolCredentials], stakes=None) -> LedgerView:
    """Each pool's stake (equal shares by default) and VRF key hash."""
    if stakes is None:
        stakes = [Fraction(1, len(pools))] * len(pools)
    return LedgerView(
        pool_distr={
            p.pool_id: IndividualPoolStake(Fraction(st), hash_vrf_vk(p.vrf_vk))
            for p, st in zip(pools, stakes)
        }
    )


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


def synthesize(db_path: str, params: PraosParams, pools: list[PoolCredentials],
               lview: LedgerView, n_blocks: int, chunk_size: int = 21600,
               txs_per_block: int = 0, proof_format="bc") -> PraosState:
    """Forge `n_blocks` blocks into `<db_path>/immutable` with the per-slot
    loop (db_synthesizer's "loop" engine); -> the final state. Per slot
    the first winning credential forges (one block per slot);
    `proof_format` picks each block's VRF proof format (module doc)."""
    from ..tools import db_synthesizer

    return db_synthesizer.synthesize(
        db_path, params, pools, lview, db_synthesizer.ForgeLimit(blocks=n_blocks),
        txs_per_block=txs_per_block, chunk_size=chunk_size, engine="loop",
        proof_format=proof_format).final_state
