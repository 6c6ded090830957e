"""The port's scalars mod L (ouroboros_consensus_tpu_torch/ops/pk/scalar.py,
plain PyTorch on the CPU) against Python integers, and the CUDA side's
sc_mul, sc_add and agg_tables row body (csrc/pk.cuh, csrc/agg.cuh, built
as host C++) against the same, byte for byte."""

import random

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import field as fe
from ouroboros_consensus_tpu_torch.ops.pk import scalar as sc

torch.set_num_threads(1)
L = sc.L
EDGES = [0, 1, L - 1, L, L + 1, 2**252, 2**253 - 1, 2**256 - 1]


def _operands(seed: int, n: int = 6) -> list[int]:
    rng = random.Random(seed)
    return EDGES + [rng.randrange(2**256) for _ in range(n)] + [rng.randrange(L) for _ in range(n)]


@pytest.fixture(scope="module")
def host():
    return build.build_host_emu()


def test_mul_and_add_mod_l_match_python():
    a = _operands(1)
    b = list(reversed(_operands(2)))
    got_mul = sc.to_int(sc.mul_mod_l(sc.from_ints(a), sc.from_ints(b)))
    # a sum of two byte rows, un-carried, as agg_tables reduces the slot sums
    got_add = sc.to_int(sc.reduce_raw_sums(sc.from_ints(a) + sc.from_ints(b)))
    assert got_mul == [x * y % L for x, y in zip(a, b)]
    assert got_add == [(x + y) % L for x, y in zip(a, b)]
    # a 16-byte coefficient against a 32-byte scalar, as the aggregate forms them
    z = [x % 2**128 for x in a]
    assert sc.to_int(sc.mul_mod_l(sc.from_ints(z, 16), sc.from_ints(b))) == \
        [x * y % L for x, y in zip(z, b)]


def test_reduce512_and_reduce_raw_sums_match_python():
    rng = random.Random(3)
    wide = [0, 2**512 - 1, L * (2**259), rng.randrange(2**512)]
    assert sc.to_int(fe.reduce512(sc.from_ints(wide, 64))) == [x % L for x in wide]
    raw = torch.tensor([[rng.randrange(1 << 40) for _ in range(32)] for _ in range(5)],
                       dtype=torch.int64).T
    want = [sum(int(raw[k, j]) << (8 * k) for k in range(32)) % L for j in range(5)]
    assert sc.to_int(sc.reduce_raw_sums(raw)) == want


def test_sum_mod_l_matches_python():
    terms = [sc.from_ints(_operands(s)[2:]) for s in (4, 5, 6)]
    cols = [sc.to_int(t) for t in terms]
    want = sum(sum(c) for c in cols) % L
    assert sc.to_int(sc.sum_mod_l(terms)) == [want]


def test_sum_mod_l_no_overflow_at_scale():
    """40 terms x 8,192 lanes of 2^252 - 1: the row sums stay exact."""
    t = sc.from_ints([2**252 - 1]).expand(32, 8192)
    assert sc.to_int(sc.sum_mod_l([t] * 40)) == [40 * 8192 * (2**252 - 1) % L]


def test_canonical_and_byte_rows():
    vals = _operands(7)
    assert fe.scalar_lt_l(sc.from_ints(vals)).tolist() == [v < L for v in vals]
    low = [v % 2**128 for v in vals]
    assert sc.to_int(sc.bytes_to_limbs(sc.from_ints(low, 16))) == low
    assert sc.to_int(sc.carry_bytes(sc.from_ints(vals) * 3)) == [3 * v for v in vals]


def _rows(vals, n=32) -> np.ndarray:
    return np.stack([np.frombuffer(v.to_bytes(n, "little"), np.uint8) for v in vals])


def test_host_sc_mul_and_sc_add_match_python(host):
    a, b = _operands(8), list(reversed(_operands(9)))
    ra, rb = _rows(a), _rows(b)
    out = np.zeros_like(ra)
    for fn, want in ((host.pk_sc_mul, [x * y % L for x, y in zip(a, b)]),
                     (host.pk_sc_add, [(x + y) % L for x, y in zip(a, b)])):
        assert fn(len(a), ra.ctypes.data, rb.ctypes.data, out.ctypes.data) == 0
        assert [int.from_bytes(r.tobytes(), "little") for r in out] == want


def test_host_agg_tables_matches_twin(host):
    rng = np.random.default_rng(10)
    raw = rng.integers(0, 1 << 40, size=(9, 32), dtype=np.int64)
    raw[0] = 8192 * 3 * 255  # the window's B sum at its largest
    out = np.zeros((9, 32), np.uint8)
    assert host.pk_agg_tables(9, raw.ctypes.data, out.ctypes.data, None) == 0
    assert np.array_equal(out, pa.agg_tables_plain(torch.from_numpy(raw)).numpy())
