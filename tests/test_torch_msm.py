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
    """pk_msm of the host build -> its buffers (msm.msm_buffers' names)."""
    bufs = pm.msm_launch(host.pk_msm, None, points, scalars, n_small, base)
    assert bufs["rc"] == 0
    return bufs


def _pt(t: torch.Tensor) -> pc.Point:
    """[k, 40] int32 (or [40]) point rows -> Point [10, k]."""
    return pc.unstack(t.reshape(-1, 40).T.to(torch.int64))


def _flat(hps) -> torch.Tensor:
    return pc.stack(_points(hps)).T.contiguous().to(torch.int32)


def _scalars(ks) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.frombuffer(k.to_bytes(32, "little"), np.uint8)
                                      for k in ks])).contiguous()


@pytest.mark.parametrize("seed,n_small,n_wide", [(14, 6, 5), (17, 40, 30)])
def test_host_msm_phases_match_the_twin(host, seed, n_small, n_wide):
    """Every phase of the device body against the restructured twin, as
    points: the bucket sums (chunks, spans), the window sums (the tree),
    the B term and the total."""
    hps, ks = _two_groups(seed, n_small, n_wide)
    points = _flat(hps)
    scalars = _scalars(ks)
    base = torch.from_numpy(np.frombuffer((1234567).to_bytes(32, "little"), np.uint8).copy())
    got = _host_msm(host, points, scalars, n_small, base)
    want_total, want_ident = pm.msm_plain(points, scalars, n_small, base)
    assert int(got["ident"][0]) == int(want_ident[0]) == 0
    assert _enc(_pt(got["total"])) == _enc(_pt(want_total))
    # the bucket sums, bucket by bucket (as points; empty buckets are not
    # written: the range phase reads them as the identity)
    p = pc.unstack(points.T.to(torch.int64))
    digits = [pm.recode_signed(sc.bytes_to_limbs(scalars[:n_small].T), 128),
              pm.recode_signed(sc.bytes_to_limbs(scalars[n_small:].T), 253)]
    digits = [torch.cat([digits[0], torch.zeros(11, n_small, dtype=torch.int64)]), digits[1]]
    twin = pm.bucket_sums(p, digits, 22)
    used = torch.nonzero(~pm.is_identity(twin))[:, 0]
    assert used.numel() > 0
    assert _enc(_take(_pt(got["buckets"]), used)) == _enc(_take(twin, used))
    # the tree's top (each window's W: its sum), the B term
    assert _enc(_pt(got["wsum"])) == _enc(pm.weighted_sums(twin, 22))
    assert _enc(_pt(got["bterm"])) == _enc(pc.base_mul_w8(base.to(torch.int64).reshape(32, 1)))


def _take(p: pc.Point, idx) -> pc.Point:
    return pc.Point(*(c[:, idx] for c in p))


def test_tree_weighted_sums_match_big_ints():
    """The tree's window sums against Σ_d d·B_d with big ints, on random
    points in a few buckets of two windows."""
    rng = random.Random(18)
    nwin = 2
    vals = {(w, d): he.point_mul(rng.randrange(1, he.L), he.B)
            for w, d in ((0, 1), (0, 2), (0, 129), (0, 2048), (1, 7), (1, 1024))}
    hps = [he.IDENT] * (nwin * pm.HALF)
    for (w, d), p in vals.items():
        hps[w * pm.HALF + d - 1] = p
    got = pm.weighted_sums(_points(hps), nwin)
    want = []
    for w in range(nwin):
        acc = he.IDENT
        for (ww, d), p in vals.items():
            if ww == w:
                acc = he.point_add(acc, he.point_mul(d, p))
        want.append(he.point_compress(acc))
    assert _enc(got) == want


def test_host_msm_big_bucket_matches_big_ints(host):
    """Three hundred points with digit 1 in window 0 and nothing above:
    one bucket across more than SPAN chunks, summed by a block's tree."""
    rng = random.Random(16)
    hps = [he.point_mul(rng.randrange(1, he.L), he.B) for _ in range(300)]
    want = he.IDENT
    for p in hps:
        want = he.point_add(want, p)
    one = np.zeros((300, 32), np.uint8)
    one[:, 0] = 1
    base = torch.zeros(32, dtype=torch.uint8)
    got = _host_msm(host, _flat(hps), torch.from_numpy(one), 0, base)
    assert int(got["big"][0]) == 1  # 300 entries cross 19 chunks: a block's tree
    assert int(got["ident"][0]) == 0
    assert _enc(_pt(got["total"])) == [he.point_compress(want)]


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
    assert int(_host_msm(host, _flat(hps), scalars, 0, zero)["ident"][0]) == 1
    hps.append(_torsion8())
    scalars = torch.cat([torch.from_numpy(np.frombuffer(z.to_bytes(32, "little"),
                                                        np.uint8).copy())[None], scalars])
    assert int(_host_msm(host, _flat([hps[2], *hps[:2]]), scalars, 1, zero)["ident"][0]) == 0


@pytest.mark.parametrize("nw", [1, 2, 22])
def test_host_warp_horner_matches_one_thread(host, nw):
    """The Horner chain on one warp (a field element over ten lanes,
    three products a round) equals the one-thread chain of ge_dbl and
    ge_add limb for limb, and Σ_w 2^(12w)·S_w + B' with big ints as a
    point."""
    rng = random.Random(19 + nw)
    sums = [he.point_mul(rng.randrange(1, he.L), he.B) for _ in range(nw)]
    bterm = he.point_mul(rng.randrange(1, he.L), he.B)
    warp, thread = torch.empty(40, dtype=torch.int32), torch.empty(40, dtype=torch.int32)
    assert host.pk_msm_horner(nw, _flat(sums).data_ptr(), _flat([bterm]).data_ptr(),
                              warp.data_ptr(), thread.data_ptr()) == 0
    assert torch.equal(warp, thread)
    want = bterm
    for w, s in enumerate(sums):
        want = he.point_add(want, he.point_mul(1 << (12 * w), s))
    assert _enc(_pt(warp)) == [he.point_compress(want)]
