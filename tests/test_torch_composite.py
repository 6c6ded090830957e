"""The port's mixed-era composite (ouroboros_consensus_tpu_torch
hardfork/composite.py) against the JAX package's on the 3-era chain of
tests/test_mixed_era.py (`CFG`): `synthesize` writes the same ImmutableDB
files byte for byte; `revalidate` through the port's device backend on
the CPU (the plain twins: the `ed_verify` twin on the Byron segment, the
five stage twins on each TPraos epoch, the packed path's twins on each
Praos epoch) and its native backend equals the JAX host and native
backends in n_blocks, n_valid, per_era, the error and the final state, on
the clean chain and on a copy with one Byron signature byte flipped; the
ledger-backed composite is refused; both `--cardano` CLIs print the JAX
CLIs' JSON line."""

import json
import os
import shutil
from fractions import Fraction

import pytest
import torch

from ouroboros_consensus_tpu.hardfork import composite as JX
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.hardfork import composite as PX
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.testing import corrupt

torch.set_num_threads(1)

CFG = dict(byron_epochs=1, byron_epoch_length=30, shelley_epochs=2, epoch_length=40,
           n_delegs=2, shelley_d=Fraction(1, 2), k=5, kes_depth=3)
N_SLOTS = 30 + 2 * 40 + 35


def same_tree(a: str, b: str) -> list:
    """The relative paths of every file under a and b, after checking
    that both hold the same files with the same bytes."""
    rel = []
    for root, _dirs, files in os.walk(a):
        for f in files:
            rel.append(os.path.relpath(os.path.join(root, f), a))
    other = [os.path.relpath(os.path.join(r, f), b) for r, _d, fs in os.walk(b) for f in fs]
    assert sorted(rel) == sorted(other)
    for r in rel:
        with open(os.path.join(a, r), "rb") as fa, open(os.path.join(b, r), "rb") as fb:
            assert fa.read() == fb.read(), r
    return sorted(rel)


def outcome(res) -> dict:
    return {"n_blocks": res.n_blocks, "n_valid": res.n_valid, "per_era": dict(res.per_era),
            "error": carry.error_to_plain(res.error),
            "state": carry.state_to_plain(res.final_state)}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    w = tmp_path_factory.mktemp("composite")
    n_port = PX.synthesize(str(w / "port"), PX.CardanoMockConfig(**CFG), N_SLOTS)
    n_ref = JX.synthesize(str(w / "ref"), JX.CardanoMockConfig(**CFG), N_SLOTS)
    assert n_port == n_ref
    return w, n_port


def test_synthesize_writes_the_reference_bytes(chains):
    w, n = chains
    assert same_tree(str(w / "port"), str(w / "ref")) == ["immutable/00000.chunk",
                                                          "immutable/00000.index"]
    assert n == 145


def _all_backends(path: str) -> dict:
    out = {"ref-host": outcome(JX.revalidate(path, JX.CardanoMockConfig(**CFG), "host")),
           "ref-native": outcome(JX.revalidate(path, JX.CardanoMockConfig(**CFG), "native")),
           "port-native": outcome(PX.revalidate(path, PX.CardanoMockConfig(**CFG), "native"))}
    K.reset_launches()
    out["port-device"] = outcome(PX.revalidate(path, PX.CardanoMockConfig(**CFG), "device",
                                               device="cpu"))
    assert sum(K.LAUNCHES.values()) == 0  # the twins launch nothing
    return out


def test_revalidate_matches_reference_backends(chains):
    w, n = chains
    out = _all_backends(str(w / "port"))
    want = out["ref-host"]
    assert want["error"] is None and want["n_valid"] == n
    assert want["per_era"] == {"byron": 30, "shelley": 80, "babbage": 35}
    assert want["state"]["era"] == 2
    for k, v in out.items():
        assert v == want, k


def test_tampered_byron_signature_stops_every_backend_alike(chains, tmp_path):
    w, _n = chains
    bad = str(tmp_path / "bad")
    shutil.copytree(str(w / "port"), bad)
    corrupt.flip_mixed_byte(bad, 17, "byron_sig")
    out = _all_backends(bad)
    want = out["ref-host"]
    assert want["n_valid"] == 17 and want["error"] == ("PBftInvalidSignature", {"slot": 17})
    for k, v in out.items():
        assert v == want, k


def test_reference_config_carries_across():
    assert carry.cardano_config_from_reference(JX.CardanoMockConfig(**CFG)) == \
        PX.CardanoMockConfig(**CFG)


def test_ledger_backed_composite_is_refused(tmp_path):
    with pytest.raises(ValueError, match="A.11"):
        PX.CardanoMock(PX.CardanoMockConfig(with_ledgers=True))
    with pytest.raises(ValueError, match="backend"):
        PX.revalidate(str(tmp_path), PX.CardanoMockConfig(**CFG), "host")


def test_cardano_clis_print_the_reference_line(tmp_path, capsys):
    from ouroboros_consensus_tpu.tools import db_analyser as j_analyser
    from ouroboros_consensus_tpu.tools import db_synthesizer as j_synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser as p_analyser
    from ouroboros_consensus_tpu_torch.tools import db_synthesizer as p_synth

    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    assert p_synth.main(["--out", p, "--cardano", "--slots", "230"]) == 0
    j_synth.main(["--out", j, "--cardano", "--slots", "230"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"forged 230 blocks over 230 slots at {p}"
    same_tree(p, j)
    assert p_analyser.main(["--db", p, "--cardano", "--backend", "native"]) == 0
    j_analyser.main(["--db", j, "--cardano", "--backend", "native"])
    ours, ref = capsys.readouterr().out.splitlines()
    assert ours == ref
    doc = json.loads(ours)
    assert doc["valid"] == doc["blocks"] == 230 and len(doc["per_era"]) == 3
    with pytest.raises(SystemExit):
        p_analyser.main(["--db", p, "--cardano", "--with-ledgers", "--backend", "native"])
    with pytest.raises(SystemExit):
        p_synth.main(["--out", str(tmp_path / "q"), "--cardano", "--with-ledgers",
                      "--slots", "10"])


def test_analyser_cli_replays_a_praos_chain(tmp_path, capsys):
    """The port's db_analyser CLI without --cardano: the reference CLI's
    parameters and credentials, its verdict line and a CSV row."""
    from ouroboros_consensus_tpu_torch.tools import db_analyser as p_analyser
    from ouroboros_consensus_tpu_torch.tools import db_synthesizer as p_synth

    db, csv = str(tmp_path / "c"), str(tmp_path / "r.csv")
    assert p_synth.main(["--out", db, "--blocks", "40", "--kes-depth", "3",
                         "--engine", "loop"]) == 0
    assert p_analyser.main(["--db", db, "--kes-depth", "3", "--backend", "native",
                            "--out-csv", csv]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("validated 40/40 headers")
    with open(csv) as f:
        assert f.read().splitlines()[1].startswith("40,40,,")
    with pytest.raises(SystemExit):
        p_analyser.main(["--db", db, "--resume"])  # a resume needs its record's path
