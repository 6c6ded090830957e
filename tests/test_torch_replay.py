"""The port's slice end to end on the CPU: a 48-block chain forged by the
JAX package replayed by the port's `revalidate(backend="device",
device="cpu", max_batch=16)` (the five stage functions' plain versions)
and by its `backend="native"`, both held to the JAX package's sequential
host fold: n_valid, first error and final PraosState all equal."""

import pytest
import torch

from torch_port_chain import N_BLOCKS, assert_same, forge, port, reference

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    lview = forge(path)
    ref = reference(path, lview)
    assert ref.n_valid == N_BLOCKS and ref.error is None
    return path, lview, ref


def test_device_replay_matches_host_fold(chain):
    path, lview, ref = chain
    got = port(path, lview, "device")
    assert_same(ref, got)
    # the chain crosses epoch boundaries: the epoch nonce rotated
    assert got.final_state.epoch_nonce is not None


def test_native_replay_matches_host_fold(chain):
    path, lview, ref = chain
    assert_same(ref, port(path, lview, "native"))
