"""Shared fixture code of the port's replay tests: a small chain forged
by the JAX package's synthesizer (bc proofs by default, draft-03 under
OCT_VRF_BATCH=0), byte corruptions that keep the storage layer's CRCs
consistent, and the comparison of the port's replay with the JAX
package's sequential host fold."""

import shutil
from fractions import Fraction

import pytest

from ouroboros_consensus_tpu.protocol.praos import PraosParams
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.testing import corrupt, synth
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


def forge(path: str, draft03: bool = False):
    """Forge the test chain with the JAX synthesizer: bc proofs, or
    draft-03 ones (the reference's OCT_VRF_BATCH=0)."""
    pools, lview = jds.make_credentials(1, kes_depth=PARAMS.kes_depth)
    with pytest.MonkeyPatch.context() as mp:
        if draft03:
            mp.setenv("OCT_VRF_BATCH", "0")
        jds.synthesize(path, PARAMS, pools, lview, jds.ForgeLimit(blocks=N_BLOCKS),
                       chunk_size=CHUNK, vrf_backend="host")
    return lview


def corrupt_copy(src: str, dst: str, field: str, index: int = MID,
                 resign: bool = False) -> None:
    """Copy the chain and flip one byte of header `index`'s `field`
    ("kes_sig", "vrf_proof" or "ocert_sigma"), re-sealing that block's
    index CRC so only the protocol check can catch the change. With
    `resign`, the header body is KES-signed again by the forging pool, so
    a flipped VRF proof reaches the VRF check."""
    shutil.copytree(src, dst)
    extra = {}
    if resign:
        extra = dict(params=carry.params_from_reference(PARAMS),
                     pool=synth.make_pool(0, kes_depth=PARAMS.kes_depth))
    corrupt.flip_header_byte(dst, index, field, **extra)


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
