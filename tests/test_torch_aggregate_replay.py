"""The port's replay with the window aggregate on and off, on the CPU
(device="cpu": the aggregate's and the stages' plain twins), against the
JAX package's sequential host fold: the 48-block batch-compatible chain
forged by the JAX package and a port-forged chain that switches from
draft-03 to batch-compatible proofs at block 24, through `revalidate`
(which runs validate_chain) at pipeline_depth 1 and 3. With the
aggregate on, every batch-compatible packed window goes through
aggregate_window and none of the clean chains' windows is re-dispatched;
with it off, none does."""

import pytest
import torch

from torch_port_chain import (CHUNK, N_BLOCKS, PARAMS, assert_same_replay, forge,
                              reference)

from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)

SWITCH = 24  # the mixed chain's first batch-compatible block


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("chains")
    bc = str(root / "bc")
    lview = forge(bc)
    mixed = str(root / "mixed")
    _, mlview = jds.make_credentials(1, kes_depth=PARAMS.kes_depth)
    synth.synthesize(mixed, carry.params_from_reference(PARAMS),
                     [synth.make_pool(0, kes_depth=PARAMS.kes_depth)],
                     carry.lview_from_reference(mlview), N_BLOCKS, chunk_size=CHUNK,
                     proof_format=lambda n: 80 if n < SWITCH else 128)
    out = {}
    for name, path, lv in (("bc", bc, lview), ("mixed", mixed, mlview)):
        ref = reference(path, lv)
        assert ref.n_valid == N_BLOCKS and ref.error is None
        out[name] = (path, lv, ref)
    return out


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("aggregate", [True, False], ids=["agg", "lanes"])
@pytest.mark.parametrize("name", ["bc", "mixed"])
def test_replay_matches_host_fold(chains, monkeypatch, name, aggregate, depth):
    path, lview, ref = chains[name]
    calls = []
    agg = pa.aggregate_window

    def spy(*cols, **kw):
        calls.append(cols[0].shape[-1])
        return agg(*cols, **kw)

    monkeypatch.setattr(pa, "aggregate_window", spy)
    before = pbatch.AGG_REDISPATCH
    got = pda.revalidate(path, carry.params_from_reference(PARAMS),
                         carry.lview_from_reference(lview), max_batch=16, device="cpu",
                         pipeline_depth=depth, aggregate=aggregate)
    assert_same_replay(ref, got)
    assert pbatch.AGG_REDISPATCH == before
    if not aggregate:
        assert calls == []
    else:
        # every batch-compatible block went through the aggregate once
        assert sum(calls) >= (N_BLOCKS if name == "bc" else N_BLOCKS - SWITCH)
