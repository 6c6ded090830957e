"""Shared fixture code of the port's replay tests: a small bc-proof chain
forged by the JAX package's synthesizer, byte corruptions that keep the
storage layer's CRCs consistent, and the comparison of the port's replay
with the JAX package's sequential host fold."""

import os
import shutil
import zlib
from fractions import Fraction

from ouroboros_consensus_tpu.protocol.praos import PraosParams
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu.utils import cbor
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.block.praos_block import Block
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB, chunk_name, index_name
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

# 1 pool, KES depth 3, 32-slot epochs (~16 blocks each: the 48-block chain
# crosses two epoch boundaries), 24-slot chunks
PARAMS = PraosParams(
    slots_per_kes_period=20, max_kes_evolutions=62, security_param=2,
    active_slot_coeff=Fraction(1, 2), epoch_length=32, kes_depth=3,
)
N_BLOCKS = 48
CHUNK = 24
MID = 24  # the corrupted header's chain index


def forge(path: str):
    pools, lview = jds.make_credentials(1, kes_depth=PARAMS.kes_depth)
    jds.synthesize(path, PARAMS, pools, lview, jds.ForgeLimit(blocks=N_BLOCKS),
                   chunk_size=CHUNK, vrf_backend="host")
    return lview


def corrupt_copy(src: str, dst: str, field: str, index: int = MID) -> None:
    """Copy the chain and flip one byte of header `index`'s `field`
    ("kes_sig", "vrf_proof" or "ocert_sigma"), re-sealing that block's
    index CRC so only the protocol check can catch the change."""
    shutil.copytree(src, dst)
    imm = ImmutableDB(os.path.join(dst, "immutable"))
    entries = [(n, k, e) for n in imm._chunks for k, e in enumerate(imm._entries[n])]
    n, k, e = entries[index]
    cpath = os.path.join(imm.path, chunk_name(n))
    with open(cpath, "rb") as f:
        data = bytearray(f.read())
    blob = bytes(data[e.offset: e.offset + e.size])
    h = Block.from_bytes(blob).header
    target = {"kes_sig": h.kes_sig, "vrf_proof": h.body.vrf_proof,
              "ocert_sigma": h.body.ocert.sigma}[field]
    data[e.offset + blob.index(target) + 40] ^= 0x01
    with open(cpath, "wb") as f:
        f.write(bytes(data))
    rows = [e2.to_cbor_obj() for e2 in imm._entries[n]]
    rows[k][5] = zlib.crc32(bytes(data[e.offset: e.offset + e.size]))
    with open(os.path.join(imm.path, index_name(n)), "wb") as f:
        f.write(b"".join(cbor.encode(r) for r in rows))


def reference(path: str, lview):
    return jda.revalidate(path, PARAMS, lview, backend="host")


def port(path: str, lview, backend: str = "device"):
    return pda.revalidate(path, carry.params_from_reference(PARAMS),
                          carry.lview_from_reference(lview), backend=backend,
                          max_batch=16, device="cpu" if backend == "device" else None)


def assert_same(ref, got) -> None:
    assert got.n_valid == ref.n_valid
    assert carry.error_to_plain(got.error) == carry.error_to_plain(ref.error)
    assert carry.state_to_plain(got.final_state) == carry.state_to_plain(ref.final_state)
