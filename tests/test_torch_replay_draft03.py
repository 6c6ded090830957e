"""The port's replay of draft-03 (80-byte proof) and mixed-format chains
on the CPU: a 48-block draft-03 chain forged by the JAX package
(OCT_VRF_BATCH=0) replayed by the port's `revalidate(backend="device",
device="cpu")` (plain versions of ed, kes, vrf_prep, vrf_ladders and
finish) and by its `backend="native"`, each held to the JAX package's
sequential host fold; so is a copy with one VRF-proof byte flipped and
the header KES-signed again (VRFKeyBadProof). A chain forged by the
port that switches from draft-03 to batch-compatible proofs at block 24
replays the same way, and its windows are cut at the switch."""

import pytest
import torch

from torch_port_chain import (CHUNK, MID, N_BLOCKS, PARAMS, assert_same, corrupt_copy,
                              forge, port, reference)

from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.testing import synth

torch.set_num_threads(1)

SWITCH = 24  # the mixed chain's first batch-compatible block


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    lview = forge(path, draft03=True)
    ref = reference(path, lview)
    assert ref.n_valid == N_BLOCKS and ref.error is None
    return path, lview, ref


@pytest.mark.parametrize("backend", ["device", "native"])
def test_draft03_replay_matches_host_fold(chain, backend):
    path, lview, ref = chain
    assert_same(ref, port(path, lview, backend))


@pytest.mark.parametrize("backend", ["device", "native"])
def test_flipped_proof_fails_the_vrf_check(chain, tmp_path, backend):
    path, lview, _ = chain
    bad = str(tmp_path / "bad")
    corrupt_copy(path, bad, "vrf_proof", resign=True)
    ref = reference(bad, lview)
    assert ref.n_valid == MID and type(ref.error).__name__ == "VRFKeyBadProof"
    assert_same(ref, port(bad, lview, backend))


def test_mixed_chain_matches_host_fold_and_cuts_at_the_switch(tmp_path, monkeypatch):
    path = str(tmp_path / "mixed")
    _, lview = jds.make_credentials(1, kes_depth=PARAMS.kes_depth)
    pools = [synth.make_pool(0, kes_depth=PARAMS.kes_depth)]
    synth.synthesize(path, carry.params_from_reference(PARAMS), pools,
                     carry.lview_from_reference(lview), N_BLOCKS, chunk_size=CHUNK,
                     proof_format=lambda n: 80 if n < SWITCH else 128)
    windows = []
    host_prechecks = pbatch.host_prechecks  # once a window

    def spy(params, lview_, hvs):
        windows.append([len(hv.vrf_proof) for hv in hvs])
        return host_prechecks(params, lview_, hvs)

    monkeypatch.setattr(pbatch, "host_prechecks", spy)
    ref = reference(path, lview)
    assert ref.n_valid == N_BLOCKS and ref.error is None
    assert_same(ref, port(path, lview, "device"))
    lens = [n for w in windows for n in w]
    assert lens == [80] * SWITCH + [128] * (N_BLOCKS - SWITCH)
    assert all(len(set(w)) == 1 for w in windows)
    starts = [sum(len(w) for w in windows[:k]) for k in range(len(windows))]
    assert SWITCH in starts



def test_packed_staging_takes_one_proof_length_per_window(chain):
    """stage_packed takes a window of 80-byte proofs (layout and the 21
    unpacked columns, gamma ‖ c ‖ s split at 32 / 48) and refuses a
    window that mixes 80- and 128-byte proofs."""
    import dataclasses

    from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

    path, lview, _ = chain
    hvs = pda.read_header_views(path)[30:34]  # one epoch, one body width
    params = carry.params_from_reference(PARAMS)
    plview = carry.lview_from_reference(lview)
    layout, packed = pbatch.stage_packed(params, plview, None, hvs)
    assert layout.vrf_proof_len == 80
    cols = pbatch.unpack_packed(layout, packed, "cpu")
    assert len(cols) == 21
    proof = bytes(hvs[2].vrf_proof)
    for k, (lo, hi) in enumerate([(0, 32), (32, 48), (48, 80)]):
        assert bytes(cols[14 + k][2].tolist()) == proof[lo:hi]
    mixed = hvs[:2] + [dataclasses.replace(hv, vrf_proof=hv.vrf_proof + bytes(48))
                       for hv in hvs[2:]]
    with pytest.raises(pbatch.NotStagedError, match="proof-format"):
        pbatch.stage_packed(params, plview, None, mixed)


def test_draft03_block_round_trips_through_the_codec(chain):
    from ouroboros_consensus_tpu_torch.block.praos_block import Block
    from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB

    path, _, _ = chain
    imm = ImmutableDB(f"{path}/immutable")
    blocks = list(imm.stream_validated(lambda b: (b, Block.from_bytes(b)), lambda _: True))
    assert len(blocks) == N_BLOCKS
    for raw, block in blocks:
        assert len(block.header.body.vrf_proof) == 80
        assert block.bytes_ == raw
