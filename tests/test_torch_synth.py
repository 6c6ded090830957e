"""The port's forger (ouroboros_consensus_tpu_torch/testing/synth.py)
writes byte for byte the chunk, index and sidecar files of the JAX
package's synthesizer, for the same seeds, parameters and block limit,
in both proof formats (the JAX side forges draft-03 under
OCT_VRF_BATCH=0)."""

import filecmp
import os

import pytest

from torch_port_chain import CHUNK, N_BLOCKS, PARAMS, forge

from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.testing import synth


@pytest.mark.parametrize("proof_format", ["bc", "draft03"])
def test_chain_files_byte_identical(tmp_path, proof_format):
    ref = str(tmp_path / "ref")
    lview = forge(ref, draft03=proof_format == "draft03")
    out = str(tmp_path / "port")
    pools = [synth.make_pool(0, kes_depth=PARAMS.kes_depth)]
    plview = synth.make_ledger_view(pools)
    assert plview == carry.lview_from_reference(lview)
    synth.synthesize(out, carry.params_from_reference(PARAMS), pools, plview,
                     N_BLOCKS, chunk_size=CHUNK, proof_format=proof_format)
    want = sorted(f for f in os.listdir(os.path.join(ref, "immutable"))
                  if f.endswith((".chunk", ".index", ".cols")))
    got = sorted(os.listdir(os.path.join(out, "immutable")))
    assert got == want and len(got) >= 9  # several chunks, each with its sidecar
    for f in got:
        assert filecmp.cmp(os.path.join(ref, "immutable", f),
                           os.path.join(out, "immutable", f), shallow=False), f


def test_unknown_proof_format_is_refused(tmp_path):
    pools = [synth.make_pool(0, kes_depth=PARAMS.kes_depth)]
    with pytest.raises(ValueError, match="proof format"):
        synth.synthesize(str(tmp_path / "x"), carry.params_from_reference(PARAMS), pools,
                         synth.make_ledger_view(pools), 4, proof_format="draft13")
    assert not os.path.exists(tmp_path / "x")
