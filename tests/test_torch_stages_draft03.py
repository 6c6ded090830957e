"""The port's draft-03 VRF stages (ouroboros_consensus_tpu_torch
ops/pk/kernels.py vrf_prep / vrf_points, plain PyTorch on the CPU) lane
by lane against the JAX package's host references, on one fixture batch
of draft-03 (80-byte proof) lanes staged by the JAX package
(testing/fixtures + protocol/batch.stage/pk_arrays under OCT_VRF_BATCH=0)
with every draft-03 corrupt-lane kind. The CUDA kernel's lane body,
built as host C++, is held to the plain twin bit for bit."""

import dataclasses
import hashlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.ops.host import ecvrf as hvrf
from ouroboros_consensus_tpu.ops.host import ed25519 as hed
from ouroboros_consensus_tpu.ops.host import kes as hkes
from ouroboros_consensus_tpu.protocol import batch as pbatch
from ouroboros_consensus_tpu.protocol import nonces, praos
from ouroboros_consensus_tpu.protocol.views import hash_key
from ouroboros_consensus_tpu.testing import fixtures
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
from ouroboros_consensus_tpu_torch.ops.pk import field as fe
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from tests.test_torch_stages import GROUP_WIDTHS, _tile

torch.set_num_threads(1)

DEPTH = 3
PARAMS = praos.PraosParams(
    slots_per_kes_period=100, max_kes_evolutions=62, security_param=4,
    active_slot_coeff=Fraction(1, 2), epoch_length=100_000, kes_depth=DEPTH,
)
ETA0 = b"\x05" * 32
B = 12
# lane -> corruption (the proof is gamma ‖ c ‖ s: 32 ‖ 16 ‖ 32 bytes)
CHALLENGE, GAMMA_BYTE, NONCANON_S, OFFCURVE_VK, OFFCURVE_GAMMA, WRONG_ALPHA = 1, 3, 5, 7, 9, 10
CORRUPT = (CHALLENGE, GAMMA_BYTE, NONCANON_S, OFFCURVE_VK, OFFCURVE_GAMMA, WRONG_ALPHA)
VRF_PK, VRF_G, VRF_C, VRF_S, VRF_AL = 13, 14, 15, 16, 17


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def _off_curve():
    for y in range(2, 1000):
        x2 = (y * y - 1) * pow(fe.D * y * y + 1, fe.P - 2, fe.P) % fe.P
        if pow(x2, (fe.P - 1) // 2, fe.P) == fe.P - 1:
            return y.to_bytes(32, "little")


@pytest.fixture(scope="module")
def batch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OCT_VRF_BATCH", "0")
        pools = [fixtures.make_pool(i, kes_depth=DEPTH) for i in range(3)]
        lview = fixtures.make_ledger_view(pools)
        hvs, slot, prev = [], 1, None
        while len(hvs) < B:
            pool = fixtures.find_leader(PARAMS, pools, lview, slot, ETA0)
            if pool is not None:
                hvs.append(fixtures.forge_header_view(
                    PARAMS, pool, slot=slot, epoch_nonce=ETA0, prev_hash=prev,
                    body_bytes=b"d" * (41 * len(hvs))))
                prev = hashlib.blake2b(b"%d" % slot, digest_size=32).digest()
            slot += 1
    assert all(len(hv.vrf_proof) == 80 for hv in hvs)
    rep = dataclasses.replace
    h = hvs
    h[CHALLENGE] = rep(h[CHALLENGE], vrf_proof=_flip(h[CHALLENGE].vrf_proof, 40))
    h[GAMMA_BYTE] = rep(h[GAMMA_BYTE], vrf_proof=_flip(h[GAMMA_BYTE].vrf_proof, 5))
    pi = h[NONCANON_S].vrf_proof
    s_big = (int.from_bytes(pi[48:], "little") + fe.L).to_bytes(32, "little")
    h[NONCANON_S] = rep(h[NONCANON_S], vrf_proof=pi[:48] + s_big)
    h[OFFCURVE_VK] = rep(h[OFFCURVE_VK], vrf_vk=_off_curve())
    h[OFFCURVE_GAMMA] = rep(h[OFFCURVE_GAMMA],
                            vrf_proof=_off_curve() + h[OFFCURVE_GAMMA].vrf_proof[32:])
    pre = pbatch.host_prechecks(PARAMS, lview, hvs)
    staged = pbatch.stage(PARAMS, lview, ETA0, hvs, pre.kes_evolution)
    assert not pbatch.batch_is_bc(staged)
    cols = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32)
            for a in pbatch.pk_arrays(staged)]
    assert len(cols) == 21
    cols[VRF_AL][7, WRONG_ALPHA] ^= 0x40
    return hvs, lview, cols


@pytest.fixture(scope="module")
def outputs(batch):
    _, _, c = batch
    ed = K.ed_points(c[0], c[2], c[3], c[4])
    kes = K.kes_points(c[5], c[6], c[8], c[9], c[10], c[11], c[12], DEPTH)
    prep = K.vrf_prep(c[VRF_PK], c[VRF_G], c[VRF_S], c[VRF_AL])
    vrf_ok, pts = K.vrf_points(*c[VRF_PK:VRF_AL + 1])
    fin = K.finish(ed[0], ed[1], c[1], kes[0], kes[1], c[7], vrf_ok, pts,
                   c[VRF_C], c[18], c[19], c[20])
    return prep, (vrf_ok, pts), fin


def _alpha(c, i: int) -> bytes:
    return bytes(c[VRF_AL][:, i].tolist())


def test_verdicts_match_host_references(batch, outputs):
    hvs, lview, c = batch
    flags, eta, lv = outputs[2]
    for i, hv in enumerate(hvs):
        assert bool(flags[0, i]) == hed.verify(hv.vk_cold, hv.ocert.signable(), hv.ocert.sigma), i
        assert bool(flags[1, i]) == hkes.verify(hv.ocert.vk_hot, DEPTH, int(c[6][0, i]),
                                                hv.signed_bytes, hv.kes_sig), i
        beta = hvrf.verify(hv.vrf_vk, hv.vrf_proof, _alpha(c, i))
        assert bool(flags[2, i]) == (beta is not None and beta == hv.vrf_output), i
        lv_ref = nonces.vrf_leader_value(hv.vrf_output)
        assert int.from_bytes(bytes(lv[:, i].tolist()), "big") == lv_ref
        assert bytes(eta[:, i].tolist()) == nonces.vrf_nonce_value(hv.vrf_output)
        entry = lview.pool_distr.get(hash_key(hv.vk_cold))
        lo, hi = pbatch.leader_threshold_bracket(Fraction(entry.stake), PARAMS.active_slot_coeff)
        assert bool(flags[3, i]) == (lv_ref < lo)
        assert bool(flags[4, i]) == (lo <= lv_ref < hi)
    assert not bool(flags[2, list(CORRUPT)].any())
    clean = [i for i in range(B) if i not in CORRUPT]
    assert bool(flags[:3, clean].all())


def test_prep_points_match_host_references(batch, outputs):
    """ok_pre holds exactly where Y and Γ decode and s < L; H and 8Γ
    compress to the host ECVRF's."""
    hvs, _, c = batch
    (ok, prep), (vrf_ok, pts), _ = outputs
    assert torch.equal(ok, vrf_ok)
    for i, hv in enumerate(hvs):
        want = (hed.point_decompress(hv.vrf_vk) is not None
                and hed.point_decompress(hv.vrf_proof[:32]) is not None
                and int.from_bytes(hv.vrf_proof[48:], "little") < fe.L)
        assert bool(ok[0, i]) == want, i
    assert not bool(ok[0, [NONCANON_S, OFFCURVE_VK, OFFCURVE_GAMMA]].any())
    h_enc, g8_enc = pc.compress_many([pc.unstack(pts[0:40].to(torch.int64)),
                                      pc.unstack(pts[160:200].to(torch.int64))])
    assert torch.equal(pts[:40], prep[:40])
    for i, hv in enumerate(hvs):
        if i == OFFCURVE_VK:
            continue
        want = hed.point_compress(hvrf.hash_to_curve(hv.vrf_vk, _alpha(c, i)))
        assert bytes(h_enc[:, i].tolist()) == want, i
        gamma = hed.point_decompress(hv.vrf_proof[:32])
        if gamma is not None:
            assert bytes(g8_enc[:, i].tolist()) == hed.point_compress(hed.point_mul(8, gamma))


def test_device_lane_code_matches_plain_twin(batch, outputs):
    """The vrf_prep kernel's lane body (csrc/stages.cuh), compiled as host
    C++, produces the plain twin's outputs bit for bit."""
    _, _, c = batch
    emu = build.build_host_emu()
    got = K._vrf_prep_launch(emu.pk_vrf_prep, None, c[VRF_PK], c[VRF_G], c[VRF_S], c[VRF_AL])
    assert all(torch.equal(a, b) for a, b in zip(got, outputs[0]))


@pytest.mark.parametrize("lanes", GROUP_WIDTHS)
def test_vrf_prep_geometries_match_plain_twin(batch, outputs, lanes):
    """vrf_prep over `lanes` lanes of every draft-03 corrupt kind around
    its 32-lane block, compiled as host C++ (H, Y, then Γ and s, role after
    role over each group, then the flags), equals the twin; also with an
    off-curve Y, an off-curve Γ and a VRF s + L on lanes 2, 4 and 6 of
    every 7, so that each role's flag decides some lanes."""
    _, _, c = batch
    emu = build.build_host_emu()
    cols = [_tile(c[k], lanes) for k in (VRF_PK, VRF_G, VRF_S, VRF_AL)]
    got = K._vrf_prep_launch(emu.pk_vrf_prep, None, *cols)
    want = K.vrf_prep(*cols)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, _tile(b, lanes)) for a, b in zip(got, outputs[0]))
    pk, gamma, s = cols[0], cols[1], cols[2]
    off = torch.tensor(list(_off_curve()), dtype=torch.int32)
    bad = [j for j in range(lanes) if j % 7 in (2, 4, 6)]
    for j in bad:
        if j % 7 == 2:
            pk[:, j] = off
        elif j % 7 == 4:
            gamma[:, j] = off
        else:
            big = int.from_bytes(bytes(s[:, j].tolist()), "little") + fe.L
            s[:, j] = torch.tensor(list(big.to_bytes(32, "little")), dtype=torch.int32)
    got = K._vrf_prep_launch(emu.pk_vrf_prep, None, *cols)
    want = K.vrf_prep(*cols)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not bool(got[0][0, bad].any())


def test_ladder_lane_code_matches_plain_twin(batch, outputs):
    """vrf_ladders on the draft-03 window (the proof's own c), compiled as
    host C++ (role after role, the quads' products in order), equals the
    plain twin."""
    _, _, c = batch
    emu = build.build_host_emu()
    (_, prep), (_, pts), _ = outputs
    assert torch.equal(K._vrf_ladders_launch(emu.pk_vrf_ladders, None, c[VRF_C], c[VRF_S], prep), pts)


def test_limb_first_relayout_matches_reference_staging(batch):
    """staged_to_limb_first over the batch-first columns equals the JAX
    package's limb-first pk_arrays, column for column."""
    _, _, c = batch
    staged = (c[0].T, c[1].T, c[2].T, c[3].permute(2, 0, 1), c[4][0],
              c[5].T, c[6][0], c[7].T, c[8].T, c[9].T, c[10].permute(2, 0, 1),
              c[11].permute(2, 0, 1), c[12][0], *(x.T for x in c[13:]))
    got = K.staged_to_limb_first(*staged)
    assert all(torch.equal(a, b) for a, b in zip(got, c))
    with pytest.raises(ValueError):
        K.staged_to_limb_first_bc(*staged)


@pytest.mark.slow
def test_matches_jax_pallas_cores_draft03(batch, outputs):
    """The JAX package's composed draft-03 core (what its Pallas kernels
    run; a multi-minute XLA:CPU compile) gives the same verdicts, eta and
    leader values."""
    import jax
    from jax import numpy as jnp

    from ouroboros_consensus_tpu.ops.pk import verify as jpv

    _, _, c = batch
    a = [jnp.asarray(x.numpy()) for x in c]

    def f(*a):
        return jpv.verify_praos_core(
            a[0], a[1], a[2], a[3], a[4][0], a[5], a[6][0], a[7], a[8], a[9],
            a[10], a[11], a[12][0], a[13], a[14], a[15], a[16], a[17],
            a[18], a[19], a[20], kes_depth=DEPTH)

    v = jax.jit(f)(*a)
    flags, eta, lv = outputs[2]
    rows = [v.ok_ocert_sig, v.ok_kes_sig, v.ok_vrf, v.ok_leader, v.leader_ambiguous]
    for r, want in enumerate(rows):
        assert (flags[r].numpy().astype(bool) == np.asarray(want)).all()
    assert (eta.numpy() == np.asarray(v.eta)).all()
    assert (lv.numpy() == np.asarray(v.leader_value)).all()
