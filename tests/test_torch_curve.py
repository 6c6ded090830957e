"""The port's edwards25519 code (ouroboros_consensus_tpu_torch
ops/pk/curve.py) against the JAX package's host Ed25519 reference and,
eagerly at T=2, its pk curve ladders."""

import numpy as np
import pytest
import torch
from jax import numpy as jnp

from ouroboros_consensus_tpu.ops.host import ed25519 as he
from ouroboros_consensus_tpu.ops.pk import curve as jcurve
from ouroboros_consensus_tpu.ops.pk import limbs as jlimbs
from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
from ouroboros_consensus_tpu_torch.ops.pk import field as fe

torch.set_num_threads(1)


def _col(blobs):
    return torch.tensor([list(b) for b in blobs]).T


def _off_curve_y():
    for y in range(2, 1000):
        x2 = (y * y - 1) * pow(fe.D * y * y + 1, fe.P - 2, fe.P) % fe.P
        if pow(x2, (fe.P - 1) // 2, fe.P) == fe.P - 1:
            return y


@pytest.fixture(scope="module")
def encodings():
    rng = np.random.default_rng(4)
    pts = [he.point_compress(he.base_point_mul(int(rng.integers(1, 2**62)) * 7919))
           for _ in range(4)]
    edge = [
        (0).to_bytes(31, "little") + b"\x80",  # y = 0 with the sign bit
        (1).to_bytes(32, "little"),  # identity, x = 0
        (1 | 1 << 255).to_bytes(32, "little"),  # x = 0 with the sign bit
        (fe.P).to_bytes(32, "little"),  # y = p: non-canonical
        (fe.P + 1).to_bytes(32, "little"),  # y = p + 1: non-canonical identity
        _off_curve_y().to_bytes(32, "little"),  # no x on the curve
        (fe.P - 1).to_bytes(32, "little"),  # y = -1
    ]
    return pts + edge


def test_decompress_matches_host(encodings):
    ok, p = pc.decompress(_col(encodings))
    enc = pc.compress_many([p])[0]
    for i, e in enumerate(encodings):
        ref = he.point_decompress(e)
        assert bool(ok[i]) == (ref is not None), e.hex()
        if ref is not None:
            assert bytes(enc[:, i].tolist()) == he.point_compress(ref)


def test_ladders_match_host():
    rng = np.random.default_rng(8)
    scal = [int.from_bytes(rng.bytes(32), "little") for _ in range(3)] + [0, fe.L - 1, 2**256 - 1]
    s_col = _col([s.to_bytes(32, "little") for s in scal])
    sb = pc.compress_many([pc.base_mul_w8(s_col)])[0]
    base = [he.point_decompress(he.point_compress(he.base_point_mul(k + 5))) for k in range(len(scal))]
    ok, p = pc.decompress(_col([he.point_compress(q) for q in base]))
    assert ok.all()
    h = [s % (1 << 128) for s in scal]
    digits = fe.nibbles_msb(_col([v.to_bytes(16, "little") for v in h]), 16)
    sm = pc.compress_many([pc.scalar_mul_w4(digits, p)])[0]
    dd = pc.double_scalar_mul_w4(fe.nibbles_msb(s_col, 32), p, digits, pc.neg(p))
    dm = pc.compress_many([dd])[0]
    for i, s in enumerate(scal):
        assert bytes(sb[:, i].tolist()) == he.point_compress(he.base_point_mul(s))
        assert bytes(sm[:, i].tolist()) == he.point_compress(he.point_mul(h[i], base[i]))
        want = he.point_mul((s - h[i]) % fe.L, base[i])
        assert bytes(dm[:, i].tolist()) == he.point_compress(want)


def test_cofactor_and_compress_many_share_one_inversion():
    ok, p = pc.decompress(_col([he.point_compress(he.base_point_mul(k)) for k in (3, 9)]))
    q = pc.mul_cofactor(p)
    a, b = pc.compress_many([p, q])
    for i, k in enumerate((3, 9)):
        assert bytes(b[:, i].tolist()) == he.point_compress(he.base_point_mul(8 * k))
        assert bytes(a[:, i].tolist()) == he.point_compress(he.base_point_mul(k))


def test_base_mul_matches_jax_pk_eagerly():
    """The JAX pk fixed-base walk (eager, T=2) and the port's agree."""
    rng = np.random.default_rng(12)
    blobs = [rng.bytes(32) for _ in range(2)]
    want = np.asarray(jcurve.compress(jcurve.base_mul_w8(
        jlimbs.windows8_from_bytes(jnp.asarray(_col(blobs).numpy(), jnp.int32), 256))))
    got = pc.compress_many([pc.base_mul_w8(_col(blobs))])[0].numpy()
    assert (got == want).all()


# edge scalars of the signed-digit ladders: 0, 1, L - 1, all-ones nibbles,
# all-eights (every recoded digit 0 with a carry), all-sevens (no carry),
# nibbles 8..15 (negative recoded digits), the top nibble 15 (carry out)
_EDGE32 = [0, 1, fe.L - 1, 2**256 - 1, int("88" * 32, 16), int("77" * 32, 16),
           int("fedcba98" * 8, 16), int("f" + "0" * 63, 16), 8, 9]


def _int_of_signed(e) -> int:
    k = e.shape[0] - 1
    return sum(int(e[i]) * 16 ** (k - i) for i in range(k + 1))


def test_signed_digits_recompose():
    for nbytes in (16, 32):
        vals = [v % (1 << (8 * nbytes)) for v in _EDGE32]
        digits = fe.nibbles_msb(_col([v.to_bytes(nbytes, "little") for v in vals]), nbytes)
        e = pc.signed_digits(digits)
        assert e.shape == (2 * nbytes + 1, len(vals))
        assert bool((e[1:] >= -8).all()) and bool((e[1:] < 8).all())
        assert set(e[0].tolist()) <= {0, 1}
        assert bool((e[1:] < 0).any())
        for i, v in enumerate(vals):
            assert _int_of_signed(e[:, i]) == v


def test_table8_and_signed_select_match_python_ints():
    """Entry j of the cached table is (j + 1)·P, and the signed lookup of
    e in [-8, 8] added to the identity is e·P (negative digits included)."""
    base = [he.base_point_mul(k) for k in (3, 11)]
    ok, p = pc.decompress(_col([he.point_compress(q) for q in base]))
    assert ok.all()
    tbl = pc.table8(p)
    ident = pc.identity(2)
    for e in range(-8, 9):
        q = pc.add_cached(ident, pc.select(tbl, torch.full((2,), e)))
        enc = pc.compress_many([q])[0]
        for i, b in enumerate(base):
            assert bytes(enc[:, i].tolist()) == he.point_compress(he.point_mul(e % fe.L, b)), e


def test_signed_ladders_match_python_ints_on_edge_scalars():
    n = len(_EDGE32)
    base = [he.point_decompress(he.point_compress(he.base_point_mul(k + 2))) for k in range(n)]
    ok, p = pc.decompress(_col([he.point_compress(q) for q in base]))
    assert ok.all()
    s_col = _col([v.to_bytes(32, "little") for v in _EDGE32])
    c_vals = [v % (1 << 128) for v in _EDGE32]
    c_col = _col([v.to_bytes(16, "little") for v in c_vals])
    sm = pc.compress_many([pc.scalar_mul_w4(fe.nibbles_msb(s_col, 32), p)])[0]
    q = pc.neg(p)
    dd = pc.double_scalar_mul_w4(fe.nibbles_msb(s_col, 32), p, fe.nibbles_msb(c_col, 16), q)
    dm = pc.compress_many([dd])[0]
    for i, s in enumerate(_EDGE32):
        assert bytes(sm[:, i].tolist()) == he.point_compress(he.point_mul(s % fe.L, base[i])), i
        want = he.point_mul((s - c_vals[i]) % fe.L, base[i])
        assert bytes(dm[:, i].tolist()) == he.point_compress(want), i


def test_doubling_skips_only_t():
    """A doubling without T has the same X, Y, Z as with it; the cofactor
    chain (two doublings without T, one with) is 8·P."""
    base = [he.base_point_mul(k) for k in (5, 77)]
    ok, p = pc.decompress(_col([he.point_compress(q) for q in base]))
    full, short = pc.double(p), pc.double(p, False)
    assert short.t is None
    assert all(torch.equal(a, b) for a, b in zip(full[:3], short[:3]))
    enc = pc.compress_many([pc.mul_cofactor(p)])[0]
    for i, b in enumerate(base):
        assert bytes(enc[:, i].tolist()) == he.point_compress(he.point_mul(8, b))
