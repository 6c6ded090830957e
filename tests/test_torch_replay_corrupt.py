"""The port's replay on corrupted copies of the test chain: one byte
flipped in a mid-chain header's KES signature, VRF proof or OCert
signature (CRC re-sealed). The port's device replay (plain versions on
the CPU) must stop at the same header with the same error and state as
the JAX package's host fold."""

import pytest
import torch

from torch_port_chain import MID, assert_same, corrupt_copy, forge, port, reference

torch.set_num_threads(1)

# the VRF proof lies inside the KES-signed header body, so its flip is
# caught by the KES check, which the reference runs first
EXPECTED = {
    "kes_sig": "InvalidKesSignatureOCERT",
    "vrf_proof": "InvalidKesSignatureOCERT",
    "ocert_sigma": "InvalidSignatureOCERT",
}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    return path, forge(path)


@pytest.mark.parametrize("field", sorted(EXPECTED))
def test_corrupted_header_truncates_identically(chain, tmp_path, field):
    path, lview = chain
    bad = str(tmp_path / "bad")
    corrupt_copy(path, bad, field)
    ref = reference(bad, lview)
    assert ref.n_valid == MID and type(ref.error).__name__ == EXPECTED[field]
    assert_same(ref, port(bad, lview, "device"))
