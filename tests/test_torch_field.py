"""The port's field and scalar arithmetic (ouroboros_consensus_tpu_torch
ops/pk/field.py) against Python big ints and the JAX package's limb code.

All comparisons are exact: integer code, no tolerance."""

import numpy as np
import pytest
import torch
from jax import numpy as jnp

from ouroboros_consensus_tpu.ops.pk import limbs as jlimbs
from ouroboros_consensus_tpu_torch.ops.pk import field as fe

torch.set_num_threads(1)
P = fe.P
L = fe.L


def _col(vals, nbytes=32):
    return torch.tensor([[(v >> (8 * k)) & 0xFF for v in vals] for k in range(nbytes)])


def _ints(t):
    by = fe.to_bytes(t)
    return [int.from_bytes(bytes(by[:, i].tolist()), "little") for i in range(t.shape[1])]


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(11)
    edge = [0, 1, P - 1, P, P + 7, 2**255 - 1, 2**255 - 20, 19]
    a = edge + [int.from_bytes(rng.bytes(32), "little") & (2**255 - 1) for _ in range(8)]
    b = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(len(a))]
    return a, b


def test_bytes_roundtrip_reduces_mod_p(operands):
    a, _ = operands
    assert _ints(fe.from_bytes(_col(a))) == [v % P for v in a]


def test_geq_p_flags_noncanonical(operands):
    a, _ = operands
    assert fe.geq_p(fe.from_bytes(_col(a))).tolist() == [v >= P for v in a]


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "sqr"])
def test_ring_ops(operands, op):
    a, b = operands
    x, y = fe.from_bytes(_col(a)), fe.from_bytes(_col(b))
    got = {
        "add": lambda: fe.add(x, y), "sub": lambda: fe.sub(x, y),
        "mul": lambda: fe.mul(x, y), "neg": lambda: fe.neg(x),
        "sqr": lambda: fe.sqr(x),
    }[op]()
    want = {
        "add": [(u + v) % P for u, v in zip(a, b)],
        "sub": [(u - v) % P for u, v in zip(a, b)],
        "mul": [(u * v) % P for u, v in zip(a, b)],
        "neg": [(-u) % P for u in a],
        "sqr": [(u * u) % P for u in a],
    }[op]
    assert _ints(got) == want


def test_loose_bound_holds_over_long_chains(operands):
    """Products of sums and differences stay in the loose form (limb i <
    2^W[i] + 2^14): the bound the CUDA kernels' 64-bit sums rely on."""
    a, b = operands
    x, y = fe.from_bytes(_col(a)), fe.from_bytes(_col(b))
    ref = [v % P for v in a]
    for _ in range(40):
        x = fe.mul(fe.add(x, y), fe.sub(x, y))
        ref = [((r + v) * (r - v)) % P for r, v in zip(ref, b)]
        lim = torch.tensor([(1 << w) + (1 << 14) for w in fe.W]).reshape(10, 1)
        assert bool((x < lim).all()) and bool((x >= 0).all())
    assert _ints(x) == ref


def test_inv_pow22523_sqrt_ratio(operands):
    a, b = operands
    y = fe.from_bytes(_col(b))
    assert _ints(fe.inv(y)) == [pow(v, P - 2, P) for v in b]
    assert _ints(fe.pow22523(y)) == [pow(v, (P - 5) // 8, P) for v in b]
    x = fe.from_bytes(_col(a))
    ok, r = fe.sqrt_ratio(x, y)
    for i, (u, v) in enumerate(zip(a, b)):
        q = u * pow(v, P - 2, P) % P if v else 0
        is_sq = v != 0 and (q == 0 or pow(q, (P - 1) // 2, P) == 1)
        assert bool(ok[i]) == is_sq or v == 0
        if is_sq:
            root = _ints(r)[i]
            assert root * root % P == q and root % 2 == 0


def test_eq_is_zero_parity(operands):
    a, _ = operands
    x = fe.from_bytes(_col(a))
    assert fe.is_zero(x).tolist() == [v % P == 0 for v in a]
    assert fe.parity(x).tolist() == [(v % P) & 1 for v in a]
    shifted = fe.add(x, fe.from_bytes(_col([P - 1] * len(a))))  # x - 1
    assert fe.eq(fe.add(shifted, fe.ones(len(a))), x).all()


def test_reduce512_and_scalar_checks():
    rng = np.random.default_rng(3)
    vals = [0, 1, L - 1, L, 2**512 - 1, L * (2**259)] + [
        int.from_bytes(rng.bytes(64), "little") for _ in range(10)]
    got = fe.reduce512(_col(vals, 64))
    assert [int.from_bytes(bytes(got[:, i].tolist()), "little")
            for i in range(len(vals))] == [v % L for v in vals]
    s = [0, L - 1, L, L + 1, 2**256 - 1, 2**252]
    assert fe.scalar_lt_l(_col(s)).tolist() == [v < L for v in s]


def test_nibbles_msb():
    v = 0x0123456789ABCDEF << 192
    d = fe.nibbles_msb(_col([v]), 32)[:, 0].tolist()
    assert d[:16] == list(range(16)) and d[16:] == [0] * 48


def test_matches_jax_limbs_eagerly(operands):
    """The port's radix-2^25.5 arithmetic and the JAX package's 13-bit
    limb arithmetic agree on canonical bytes (JAX eager at T=2)."""
    a, b = operands
    aa, bb = a[:2], b[:2]
    ja = jlimbs.from_bytes32(jnp.asarray(_col(aa).numpy(), jnp.int32))
    jb = jlimbs.from_bytes32(jnp.asarray(_col(bb).numpy(), jnp.int32))
    pa, pb = fe.from_bytes(_col(aa)), fe.from_bytes(_col(bb))
    for jf, pf in ((jlimbs.mul, fe.mul), (jlimbs.sub, fe.sub), (jlimbs.add, fe.add)):
        want = np.asarray(jlimbs.to_bytes(jf(ja, jb)))
        assert (fe.to_bytes(pf(pa, pb)).numpy() == want).all()
    want = np.asarray(jlimbs.to_bytes(jlimbs.inv(jb)))
    assert (fe.to_bytes(fe.inv(pb)).numpy() == want).all()


def test_bound_counts_squarings_apart(operands):
    """chip_smoke's operation bound: an inversion is 254 squarings and 11
    multiplies (55 and 100 wide products), and the count leaves field.py
    as it found it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    a, _ = operands
    x = fe.from_bytes(_col(a[:2]))
    mul, sqr = fe.mul, fe.sqr
    ops = cs.count_field_ops(lambda: fe.inv(x))
    assert ops == {"mul": 11, "sqr": 254}
    assert cs.wide_products(ops) == 11 * 100 + 254 * 55
    assert (fe.mul, fe.sqr) == (mul, sqr)
