"""The wire kernels' one-thread Blake2b-256 compression
(ouroboros_consensus_tpu_torch ops/pk/csrc/wire.cuh: b2b_256_1, the
state and the message schedule in registers), compiled as host C++,
against hashlib for the message lengths the port hashes: the VRF alpha
(8 and 40 bytes), the eta's second hash (32), the fold's combine (64)
and "N" ‖ β (65); and the compression instrument's chains (nonce_fold.cu,
b2b_bench_kernel): the one-thread compression, pk.cuh's looped one and
the fold chain's four-lane one (wire.cuh: b2b_compress4, whose columns
the host build runs in one thread)."""

import hashlib

import numpy as np
import pytest

from ouroboros_consensus_tpu_torch.ops.pk import build

LANES = 5


@pytest.mark.parametrize("n", [8, 32, 40, 64, 65, 0, 128])
def test_one_thread_compression_matches_hashlib(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (LANES, n)).astype(np.uint8)
    msg = np.zeros((LANES, 128), np.uint8)
    msg[:, :n] = data
    out = np.zeros((LANES, 32), np.uint8)
    build.build_host_emu().pk_b2b_one(LANES, msg.ctypes.data,
                                      np.full(LANES, n, np.int32).ctypes.data,
                                      out.ctypes.data)
    for i in range(LANES):
        assert out[i].tobytes() == hashlib.blake2b(data[i].tobytes(), digest_size=32).digest()


@pytest.mark.parametrize("mode", [0, 1, 2],
                         ids=["b2b_256_1", "looped_blake2b_256", "four_lane"])
def test_compression_instrument_chains_as_hashlib(mode):
    """The instrument's chain of dependent compressions, ev <- Blake2b-256(
    ev ‖ e), in either mode, ends where hashlib's does."""
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2**63, 8, dtype=np.uint64)
    out, cycles = np.zeros(4, np.uint64), np.zeros(1, np.int64)
    assert build.build_host_emu().pk_b2b_bench(
        7, mode, words.ctypes.data, out.ctypes.data, cycles.ctypes.data, None) == 0
    ev, e = words[:4].tobytes(), words[4:].tobytes()
    for _ in range(7):
        ev = hashlib.blake2b(ev + e, digest_size=32).digest()
    assert out.tobytes() == ev
