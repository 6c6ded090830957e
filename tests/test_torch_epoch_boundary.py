"""A corruption at an epoch's first header: a flipped byte of header 16's
KES signature in the 48-block batch-compatible chain
(`tests/torch_port_chain.py`; header 16 is slot 32, the first header of
epoch 1). The reference's two paths part there on the final state: its
host fold keeps the state from before the new epoch's tick, its batched
path (the native backend; the device path shares its epilogue) returns
the ticked state, the epoch nonce rotated and the last-epoch-block nonce
latched. The port returns the ticked state, as the batched path does.
So `n_valid` and the error are held to the host fold, and the final
state to the JAX package's `revalidate(backend="native")`, on the
window aggregate's path, with `aggregate=False` and on the port's native
backend."""

import pytest
import torch

from torch_port_chain import PARAMS, corrupt_copy, forge, reference

from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)

FIRST = 16  # the first header of epoch 1


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("chain") / "db")
    lview = forge(src)
    dst = str(tmp_path_factory.mktemp("bad") / "db")
    corrupt_copy(src, dst, "kes_sig", index=FIRST)
    return dst, lview


@pytest.fixture(scope="module")
def ref(chain):
    path, lview = chain
    return reference(path, lview), jda.revalidate(path, PARAMS, lview, backend="native")


def test_the_corrupted_header_opens_an_epoch(chain, ref):
    """Header 16 is the first of epoch 1, and the reference's host fold
    and native path agree on the verdict and part on the state there."""
    path, _lview = chain
    slots = [hv.slot for hv in pda.read_header_views(path)]
    assert slots[FIRST] // PARAMS.epoch_length == 1 > slots[FIRST - 1] // PARAMS.epoch_length
    host, native = ref
    assert host.n_valid == native.n_valid == FIRST
    assert type(host.error).__name__ == type(native.error).__name__ == \
        "InvalidKesSignatureOCERT"
    assert carry.state_to_plain(host.final_state) != carry.state_to_plain(native.final_state)


@pytest.mark.parametrize("backend,aggregate", [("device", True), ("device", False),
                                               ("native", True)],
                         ids=["aggregate", "per-lane", "native"])
def test_port_at_an_epochs_first_header(chain, ref, backend, aggregate):
    path, lview = chain
    host, native = ref
    before = pbatch.AGG_REDISPATCH
    got = pda.revalidate(path, carry.params_from_reference(PARAMS),
                         carry.lview_from_reference(lview), backend=backend, max_batch=16,
                         device="cpu" if backend == "device" else None, aggregate=aggregate)
    assert got.n_valid == host.n_valid == FIRST
    assert carry.error_to_plain(got.error) == carry.error_to_plain(host.error)
    assert carry.state_to_plain(got.final_state) == carry.state_to_plain(native.final_state)
    redispatched = pbatch.AGG_REDISPATCH - before
    assert redispatched == (1 if backend == "device" and aggregate else 0)
