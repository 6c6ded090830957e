"""Per-block forging: assemble and KES-sign one Praos block, the port's
copy of the reference's block/forge.py:29-79.

Reference: `forgeBlock`/`mkHeader` — Block/Forging.hs:143 and the Praos
`mkHeader` instance (shelley Protocol/Praos.hs:102). The certified VRF
result is a batch-compatible proof (the reference forge's default
format, native.ecvrf_prove_bc); the OCert is a throwaway one issued at
the start of the slot's evolution window, and the header is assembled
and KES-signed by protocol/forge.BlockAssembler, the one definition of
the header format, so the bytes are the reference's. The mixed-era
composite (hardfork/composite.py) forges its Praos-class eras here.
"""

from __future__ import annotations

from .. import native
from ..protocol import nonces
from ..protocol.forge import BlockAssembler
from ..protocol.instances import PraosIsLeader
from ..protocol.praos import PraosParams
from .praos_block import Block


def evaluate_vrf(pool, slot: int, epoch_nonce: nonces.Nonce) -> PraosIsLeader:
    """VRF.evalCertified at InputVRF(slot, eta0) (Praos.hs:397)."""
    proof = native.ecvrf_prove_bc(pool.vrf_seed, nonces.mk_input_vrf(slot, epoch_nonce))
    return PraosIsLeader(native.proof_to_hash(proof), proof)


def forge_block(params: PraosParams, pool, *, slot: int, block_no: int,
                prev_hash: bytes | None, epoch_nonce: nonces.Nonce,
                txs: tuple[bytes, ...] = (), ocert_counter: int = 0,
                is_leader: PraosIsLeader | None = None,
                assembler: BlockAssembler | None = None) -> Block:
    """Forge a protocol-valid block for `slot` (the caller has won the
    slot). `assembler`: a BlockAssembler over credentials that include
    `pool`, whose OCert cache a run of blocks shares (None: one for this
    block)."""
    if is_leader is None:
        is_leader = evaluate_vrf(pool, slot, epoch_nonce)
    asm = assembler if assembler is not None else BlockAssembler(params, [pool])
    return asm.forge(asm.pools.index(pool), slot=slot, block_no=block_no,
                     prev_hash=prev_hash, txs=tuple(txs), ocert_counter=ocert_counter,
                     vrf_output=is_leader.vrf_output, vrf_proof=is_leader.vrf_proof)
