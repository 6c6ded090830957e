"""The batched Ed25519 verify on the R encodings where a byte compare and a
decompress-then-compare could part: y = p and y = p + 1 (non-canonical,
with and without the sign bit), x = 0 with the sign bit set, an off-curve
y, small-order R (the identity, the points of order 2 and 4, one of order
8; true verdicts among them), R = −P (the sign bit of a valid R flipped),
each beside a valid signature. The `ed_verify` kernel's lane code (compiled
as host C++: R decompressed in phase 1 and compared projectively with P)
and its plain twin (P compressed and its bytes compared) are held lane by
lane to the JAX package's batched verify (ops/ed25519_batch.verify_batch)
and its host reference (ops/host/ed25519.verify), and the C++ verifier
(native.ed25519_verify) to the same verdicts; then the host build at lane
counts around its 32-lane block."""

import hashlib

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.ops import ed25519_batch as jeb
from ouroboros_consensus_tpu.ops.host import ed25519 as he
from ouroboros_consensus_tpu_torch import native
from ouroboros_consensus_tpu_torch.ops import ed25519_batch as eb
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

torch.set_num_threads(1)

P, L = he.P, he.L
B = 64  # the batch of tests/test_torch_ed25519_batch.py (so the JAX compile is shared)


def _enc(y: int, sign: int = 0) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


def _off_curve_y() -> int:
    for y in range(2, 1000):
        if he.point_decompress(_enc(y)) is None:
            return y
    raise AssertionError


def _torsion():
    """The 8-torsion: {L·Q} for points Q, as (order, point)."""
    pts = {}
    for y in range(2, 200):
        q = he.point_decompress(_enc(y))
        if q is None:
            continue
        t = he.point_mul(he.L, q)
        order = next(n for n in (1, 2, 4, 8) if he.point_compress(he.point_mul(n, t))
                     == _enc(1))
        pts.setdefault(order, t)
        if len(pts) == 4:
            return pts
    raise AssertionError


def _seed(k: int) -> bytes:
    return hashlib.sha256(b"edge%d" % k).digest()


def _sign_with_r(seed: bytes, msg: bytes, r_enc: bytes) -> bytes:
    """A signature whose R bytes are `r_enc` and s = h·a mod L (so s·B = h·A:
    true exactly when R decodes to the identity)."""
    a, _ = he.secret_expand(seed)
    pk = he.secret_to_public(seed)
    h = int.from_bytes(hashlib.sha512(r_enc + pk + msg).digest(), "little") % L
    return r_enc + (h * a % L).to_bytes(32, "little")


def _edge_lanes():
    """(pk, sig, msg, case) rows: each edge case beside a valid signature;
    messages of 0 to 300 bytes (one to three SHA-512 blocks)."""
    rows = []
    k = 0

    def valid(msg):
        nonlocal k
        k += 1
        sd = _seed(k)
        rows.append((he.secret_to_public(sd), he.sign(sd, msg), msg, "valid"))
        return sd

    def edge(case, sig_of, msg=b"edge"):
        sd = valid(msg)
        pk = he.secret_to_public(sd)
        rows.append((pk, sig_of(sd, pk, he.sign(sd, msg), msg), msg, case))

    def with_r(r_enc):
        return lambda sd, pk, sig, msg: r_enc + sig[32:]

    for y, name in ((P, "y = p"), (P + 1, "y = p + 1"), (2 ** 255 - 1, "y = 2^255 - 1")):
        for sign in (0, 1):
            edge(f"R {name}, sign {sign}", with_r(_enc(y, sign)))
    edge("R y = 1, x = 0, sign set", with_r(_enc(1, 1)))
    # s = h·a: s·B − h·A is the identity, so only R's decoding refuses these
    edge("R y = p + 1 (the identity, non-canonical), s = h·a",
         lambda sd, pk, sig, msg: _sign_with_r(sd, msg, _enc(P + 1)))
    edge("R y = 1, x = 0, sign set, s = h·a",
         lambda sd, pk, sig, msg: _sign_with_r(sd, msg, _enc(1, 1)))
    edge("R y = p - 1, x = 0, sign set", with_r(_enc(P - 1, 1)))
    edge("R off-curve y", with_r(_enc(_off_curve_y())))
    edge("R off-curve y, sign set", with_r(_enc(_off_curve_y(), 1)))
    for order, t in sorted(_torsion().items()):
        enc = he.point_compress(t)
        edge(f"R of order {order}, s of the valid signature", with_r(enc))
        edge(f"R of order {order}, s = h·a", lambda sd, pk, sig, msg, e=enc: _sign_with_r(sd, msg, e))
    edge("R = -R (sign bit flipped)",
         lambda sd, pk, sig, msg: bytes(sig[:31]) + bytes([sig[31] ^ 0x80]) + sig[32:])
    # a small-order key whose h·A is the identity: s = 0 and R the identity
    t8 = _torsion()[8]
    a8 = he.point_compress(t8)
    for n in range(1000):
        msg = b"torsion-%d" % n
        h = int.from_bytes(hashlib.sha512(_enc(1) + a8 + msg).digest(), "little") % L
        if h % 8 == 0:
            break
    valid(b"x" * 150)
    rows.append((a8, _enc(1) + bytes(32), msg, "A of order 8, R the identity, s = 0"))
    valid(b"y" * 300)
    rows.append((a8, _enc(1, 1) + bytes(32), msg, "A of order 8, R the identity with sign"))
    while len(rows) < B:
        valid(bytes([len(rows)]) * (len(rows) % 7))
    assert len(rows) == B
    return rows


@pytest.fixture(scope="module")
def edges():
    return _edge_lanes()


@pytest.fixture(scope="module")
def reference(edges):
    """The JAX host reference's verdicts, which its batched verify equals."""
    return np.array([he.verify(pk, m, s) for pk, s, m, _ in edges])


def _cols(edges):
    return eb.limb_columns(eb.stage_np(*zip(*[(pk, s, m) for pk, s, m, _ in edges])), "cpu")


def test_edge_cases_hit_both_verdicts(edges, reference):
    """Some edge cases pass (the identity R with s = h·a, the small-order
    key) and the non-canonical and off-curve R fail."""
    by_case = {c: bool(v) for (_, _, _, c), v in zip(edges, reference)}
    assert by_case["R of order 1, s = h·a"] and by_case["A of order 8, R the identity, s = 0"]
    for case, v in by_case.items():
        if case.startswith(("R y", "R off-curve", "R = -R")) or "with sign" in case:
            assert not v, case


def test_jax_batch_matches_host_reference(edges, reference):
    got = np.asarray(jeb.verify_batch(*zip(*[(pk, s, m) for pk, s, m, _ in edges])))
    assert got.tolist() == reference.tolist()


def test_twin_matches_reference(edges, reference):
    got = K.ed_verify(*_cols(edges))[0].numpy() != 0
    bad = [edges[i][3] for i in np.flatnonzero(got != reference)]
    assert not bad, bad


def test_host_build_matches_reference(edges, reference):
    """R decoded and compared projectively (the kernel's lane code) gives
    the byte compare's verdicts."""
    got = K._ed_verify_launch(build.build_host_emu().pk_ed_verify, None, *_cols(edges))
    bad = [edges[i][3] for i in np.flatnonzero((got[0].numpy() != 0) != reference)]
    assert not bad, bad


def test_native_verifier_matches_reference(edges, reference):
    got = np.array([native.ed25519_verify(pk, s, m) for pk, s, m, _ in edges])
    bad = [edges[i][3] for i in np.flatnonzero(got != reference)]
    assert not bad, bad


def _tile(t: torch.Tensor, n: int) -> torch.Tensor:
    reps = -(-n // t.shape[-1])
    return torch.cat([t] * reps, dim=-1)[..., :n].contiguous()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 70])
def test_host_build_around_its_block(edges, reference, n):
    """1 lane, one short of a 32-lane block, a block, a block and one, two
    blocks and a ragged tail: the host build equals the twin and the
    reference's verdicts tiled."""
    cols = [_tile(c, n) for c in _cols(edges)]
    got = K._ed_verify_launch(build.build_host_emu().pk_ed_verify, None, *cols)
    assert torch.equal(got, K.ed_verify(*cols))
    want = _tile(torch.from_numpy(reference.astype(np.int32))[None], n)
    assert torch.equal(got, want)
