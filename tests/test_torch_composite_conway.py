"""The five-era composite (`CFG5`, tests/test_torch_composite_eras.py)
with one KES-signature byte flipped in a Conway header: the port's
device backend on the CPU (the plain twins) and its native backend stop
where the JAX host and native backends stop, with the same error and
state."""

import shutil

import pytest
import torch

from ouroboros_consensus_tpu_torch.hardfork import composite as PX
from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB
from ouroboros_consensus_tpu_torch.testing import corrupt

from test_torch_composite_eras import CFG5, N_SLOTS5, backends

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    w = tmp_path_factory.mktemp("composite5c")
    PX.synthesize(str(w / "port"), PX.CardanoMockConfig(**CFG5), N_SLOTS5)
    return w


def test_tampered_conway_header_matches_reference_backends(chain, tmp_path):
    w = chain
    bad = str(tmp_path / "bad")
    shutil.copytree(str(w / "port"), bad)
    entries = [e for e, _raw in ImmutableDB(bad + "/immutable").stream_all()]
    k = next(i for i, e in enumerate(entries) if 155 <= e.slot < 225)
    corrupt.flip_mixed_byte(bad, k, "kes_sig")
    out = backends(bad)
    want = out["ref-host"]
    assert want["n_valid"] == k and want["error"][0] == "InvalidKesSignatureOCERT"
    for key, v in out.items():
        assert v == want, key
