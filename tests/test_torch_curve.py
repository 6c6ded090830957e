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
