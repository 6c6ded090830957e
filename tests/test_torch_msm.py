"""The window aggregate's bucket machine (ouroboros_consensus_tpu_torch/
ops/pk/msm.py, plain PyTorch on the CPU) against big-integer point
arithmetic (the JAX package's ops/host/ed25519), and the phases of the
`msm` kernel (csrc/agg.cuh, built as host C++) against the twin: the
recode, the bucket sums, the segments of the weighted sums, and the
whole machine with its B term and identity test."""

import ctypes
import random

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.ops.host import ed25519 as he
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
from ouroboros_consensus_tpu_torch.ops.pk import field as fe
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.ops.pk import msm as pm
from ouroboros_consensus_tpu_torch.ops.pk import scalar as sc

torch.set_num_threads(1)


def _points(hps) -> pc.Point:
    cols = [[fe.int_to_limbs(p[k]) for p in hps] for k in range(4)]
    return pc.Point(*(torch.tensor(c, dtype=torch.int64).T.contiguous() for c in cols))


def _enc(p: pc.Point) -> list[bytes]:
    (e,) = pc.compress_many([p])
    return [bytes(r) for r in e.T.tolist()]


def _torsion8():
    """A point of exact order 8."""
    for b0 in range(256):
        q = he.point_decompress(bytes([b0]) + bytes(31))
        if q is None:
            continue
        t = he.point_mul(he.L, q)
        if not he.point_equal(he.point_mul(4, t), he.IDENT):
            return t
    raise AssertionError("no order-8 point")


@pytest.fixture(scope="module")
def host():
    return build.build_host_emu()


@pytest.mark.parametrize("nbits", [128, 253])
def test_recode_signed_round_trips_within_bounds(nbits):
    rng = random.Random(nbits)
    ks = [0, 1, 2**nbits - 1, 2048, 2049, 4095] + [rng.randrange(2**nbits) for _ in range(60)]
    d = pm.recode_signed(sc.from_ints(ks), nbits)
    assert d.shape[0] == pm.signed_digit_windows(nbits) == {128: 11, 253: 22}[nbits]
    assert int(d.max()) <= 2048 and int(d.min()) > -2048
    assert [sum(int(d[w, i]) << (12 * w) for w in range(d.shape[0]))
            for i in range(len(ks))] == ks


def _two_groups(seed: int, n_small: int, n_wide: int):
    rng = random.Random(seed)
    hps = [he.point_mul(rng.randrange(1, he.L), he.B) for _ in range(n_small + n_wide)]
    ks = [rng.randrange(2**128) for _ in range(n_small)] + \
        [rng.randrange(he.L) for _ in range(n_wide)]
    return hps, ks


def test_msm_shared_matches_big_ints():
    hps, ks = _two_groups(11, 5, 4)
    want = he.IDENT
    for k, p in zip(ks, hps):
        want = he.point_add(want, he.point_mul(k, p))
    pts = _points(hps)
    got = pm.msm_shared([
        (sc.from_ints(ks[:5]), pc.Point(*(c[:, :5] for c in pts)), 128),
        (sc.from_ints(ks[5:]), pc.Point(*(c[:, 5:] for c in pts)), 253),
    ])
    assert _enc(got) == [he.point_compress(want)]
    assert not bool(pm.is_identity(got)[0])


def test_cancellation_is_the_identity():
    rng = random.Random(12)
    p = he.point_mul(rng.randrange(1, he.L), he.B)
    k = rng.randrange(he.L)
    pts = _points([p, he.point_neg(p)])
    got = pm.msm_shared([(sc.from_ints([k, k]), pts, 253)])
    assert bool(pm.is_identity(got)[0])


def test_lone_torsion_point_times_odd_scalar_is_not_the_identity():
    t8 = _torsion8()
    rng = random.Random(13)
    odd = [rng.randrange(2**127) * 2 + 1 for _ in range(3)]
    for k in odd:
        got = pm.msm_shared([(sc.from_ints([k]), _points([t8]), 128)])
        assert not bool(pm.is_identity(got)[0])
    # the control: a multiple of 8 kills it
    got = pm.msm_shared([(sc.from_ints([8 * odd[0]]), _points([t8]), 128)])
    assert bool(pm.is_identity(got)[0])


def _host_msm(host, points, scalars, n_small, base):
    """pk_msm of the host build -> (total [40], identity, buckets, segs)."""
    n = points.shape[0]
    ws, ww = 11, 22
    i32 = dict(dtype=torch.int32)
    entries = n_small * ws + (n - n_small) * ww
    bufs = [torch.empty((ww, n), **i32), torch.zeros((ww * pm.NBUCKETS + 1,), **i32),
            torch.empty((ww * pm.NBUCKETS + 1,), **i32), torch.empty((ww * pm.NBUCKETS,), **i32),
            torch.zeros((entries // (pm.SMALL + 1) + 1,), **i32),
            torch.empty((max(entries, 1),), **i32),
            torch.empty((ww * pm.HALF, 40), **i32), torch.empty((2, ww * pm.NSEG, 40), **i32),
            torch.empty((40,), **i32), torch.empty((1,), **i32)]
    rc = host.pk_msm(n, n_small, ws, ww, K._base8(torch.device("cpu")).data_ptr(),
                     points.data_ptr(), scalars.data_ptr(), base.data_ptr(),
                     *(b.data_ptr() for b in bufs), None)
    assert rc == 0
    return bufs[8], int(bufs[9][0]), bufs[6], bufs[7]


def _flat(hps) -> torch.Tensor:
    return pc.stack(_points(hps)).T.contiguous().to(torch.int32)


def test_host_msm_phases_match_the_twin(host):
    hps, ks = _two_groups(14, 6, 5)
    points = _flat(hps)
    scalars = torch.from_numpy(np.stack([np.frombuffer(k.to_bytes(32, "little"), np.uint8)
                                         for k in ks])).contiguous()
    base = torch.from_numpy(np.frombuffer((1234567).to_bytes(32, "little"), np.uint8).copy())
    total, ident, buckets, segs = _host_msm(host, points, scalars, 6, base)
    want_total, want_ident = pm.msm_plain(points, scalars, 6, base)
    assert ident == int(want_ident[0]) == 0
    assert _enc(pc.unstack(total.to(torch.int64).reshape(40, 1))) == \
        _enc(pc.unstack(want_total.to(torch.int64).reshape(40, 1)))
    # the bucket sums, bucket by bucket (as points)
    p = pc.unstack(points.T.to(torch.int64))
    digits = [pm.recode_signed(sc.bytes_to_limbs(scalars[:6].T), 128),
              pm.recode_signed(sc.bytes_to_limbs(scalars[6:].T), 253)]
    digits = [torch.cat([digits[0], torch.zeros(11, 6, dtype=torch.int64)]), digits[1]]
    twin = pm.bucket_sums(p, digits, 22)
    got = pc.unstack(buckets.T.to(torch.int64))
    used = torch.nonzero(~pm.is_identity(twin))[:, 0]
    assert used.numel() > 0
    assert bool(pm.is_identity(pc.Point(*(c[:, ~torch.isin(torch.arange(22 * pm.HALF), used)]
                                          for c in got))).all())
    assert _enc(pc.Point(*(c[:, used] for c in got))) == \
        _enc(pc.Point(*(c[:, used] for c in twin)))
    # the segments of the weighted sums: run and acc of every segment
    run, acc = pm.segment_sums(twin, 22)
    for k, want in enumerate((run, acc)):
        assert _enc(pc.unstack(segs[k].T.to(torch.int64))) == _enc(want)


def test_host_msm_big_bucket_matches_big_ints(host):
    """Three hundred points with digit 1 in window 0 and nothing above:
    one bucket of more than SMALL entries, summed by a block's tree."""
    rng = random.Random(16)
    hps = [he.point_mul(rng.randrange(1, he.L), he.B) for _ in range(300)]
    want = he.IDENT
    for p in hps:
        want = he.point_add(want, p)
    one = np.zeros((300, 32), np.uint8)
    one[:, 0] = 1
    base = torch.zeros(32, dtype=torch.uint8)
    total, ident, _, _ = _host_msm(host, _flat(hps), torch.from_numpy(one), 0, base)
    assert ident == 0
    assert _enc(pc.unstack(total.to(torch.int64).reshape(40, 1))) == [he.point_compress(want)]


def test_host_msm_identity_is_exact(host):
    """Σ k·P + (−k)·P + 0·B is the identity; adding an 8-torsion point
    with an odd scalar is not."""
    rng = random.Random(15)
    p = he.point_mul(rng.randrange(1, he.L), he.B)
    k = rng.randrange(he.L)
    z = rng.randrange(2**127) * 2 + 1
    hps = [he.point_neg(p), p]
    scalars = torch.from_numpy(np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                                         for v in (k, k)])).contiguous()
    zero = torch.zeros(32, dtype=torch.uint8)
    assert _host_msm(host, _flat(hps), scalars, 0, zero)[1] == 1
    hps.append(_torsion8())
    scalars = torch.cat([torch.from_numpy(np.frombuffer(z.to_bytes(32, "little"),
                                                        np.uint8).copy())[None], scalars])
    assert _host_msm(host, _flat([hps[2], *hps[:2]]), scalars, 1, zero)[1] == 0
