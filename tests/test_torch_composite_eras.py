"""The port's five-era composite (`CFG5` of tests/test_mixed_era.py:
PBFT → TPraos → Praos → Praos with a doubled epoch length and f = 1/2 →
Praos with a shorter epoch) against the JAX package's: `synthesize`
writes the same bytes, and `revalidate` on the port's device backend on
the CPU (the plain twins) and its native backend equals the JAX host and
native backends on the clean chain (a copy with a flipped Conway
KES-signature byte: test_torch_composite_conway.py)."""

from fractions import Fraction

import pytest
import torch

from ouroboros_consensus_tpu.hardfork import composite as JX
from ouroboros_consensus_tpu_torch.hardfork import composite as PX

from test_torch_composite import outcome, same_tree

torch.set_num_threads(1)

CFG5 = dict(byron_epochs=1, byron_epoch_length=30, shelley_epochs=2, epoch_length=40,
            n_delegs=2, shelley_d=Fraction(1, 2), k=5, kes_depth=3, conway_epochs=1,
            conway_f=Fraction(1, 2), conway_epoch_length=80, leios_epochs=1,
            leios_f=Fraction(1), leios_epoch_length=20)
N_SLOTS5 = 30 + 80 + 40 + 80 + 45


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    w = tmp_path_factory.mktemp("composite5")
    n = PX.synthesize(str(w / "port"), PX.CardanoMockConfig(**CFG5), N_SLOTS5)
    assert JX.synthesize(str(w / "ref"), JX.CardanoMockConfig(**CFG5), N_SLOTS5) == n
    return w, n


def test_synthesize_writes_the_reference_bytes(chains):
    w, _n = chains
    same_tree(str(w / "port"), str(w / "ref"))


def backends(path: str) -> dict:
    return {
        "ref-host": outcome(JX.revalidate(path, JX.CardanoMockConfig(**CFG5), "host")),
        "ref-native": outcome(JX.revalidate(path, JX.CardanoMockConfig(**CFG5), "native")),
        "port-native": outcome(PX.revalidate(path, PX.CardanoMockConfig(**CFG5), "native")),
        "port-device": outcome(PX.revalidate(path, PX.CardanoMockConfig(**CFG5), "device",
                                             device="cpu")),
    }


def test_clean_chain_matches_reference_backends(chains):
    w, n = chains
    out = backends(str(w / "port"))
    want = out["ref-native"]
    assert want["error"] is None and want["n_valid"] == n
    assert set(want["per_era"]) == {"byron", "shelley", "babbage", "conway", "leios"}
    assert 0 < want["per_era"]["conway"] < 80 and want["state"]["era"] == 4
    for k, v in out.items():
        assert v == want, k
