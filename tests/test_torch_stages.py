"""The port's five stage functions (ouroboros_consensus_tpu_torch
ops/pk/kernels.py, plain PyTorch on the CPU) lane by lane against the
JAX package's host references, on one fixture batch of bc lanes staged
by the JAX package (testing/fixtures + protocol/batch.stage/pk_arrays)
with every corrupt-lane kind. The CUDA kernels' lane bodies, built as
host C++, are held to the plain twins bit for bit on the same batch."""

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

torch.set_num_threads(1)

DEPTH = 3
PARAMS = praos.PraosParams(
    slots_per_kes_period=100, max_kes_evolutions=62, security_param=4,
    active_slot_coeff=Fraction(1, 2), epoch_length=100_000, kes_depth=DEPTH,
)
ETA0 = b"\x07" * 32
B = 12
# lane -> corruption
OCERT_SIG, KES_SIG, VRF_PROOF, VRF_OUT, NONCANON_S, OFFCURVE_VK, KES_PERIOD = 1, 3, 5, 7, 9, 10, 11


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def _off_curve():
    for y in range(2, 1000):
        x2 = (y * y - 1) * pow(fe.D * y * y + 1, fe.P - 2, fe.P) % fe.P
        if pow(x2, (fe.P - 1) // 2, fe.P) == fe.P - 1:
            return y.to_bytes(32, "little")


@pytest.fixture(scope="module")
def batch():
    pools = [fixtures.make_pool(i, kes_depth=DEPTH) for i in range(3)]
    lview = fixtures.make_ledger_view(pools)
    hvs, slot, prev = [], 1, None
    while len(hvs) < B:
        pool = fixtures.find_leader(PARAMS, pools, lview, slot, ETA0)
        if pool is not None:
            # body lengths straddle SHA-512 block edges: per-lane block counts differ
            hvs.append(fixtures.forge_header_view(
                PARAMS, pool, slot=slot, epoch_nonce=ETA0, prev_hash=prev,
                body_bytes=b"b" * (37 * len(hvs))))
            prev = hashlib.blake2b(b"%d" % slot, digest_size=32).digest()
        slot += 1
    rep = dataclasses.replace
    h = hvs
    h[OCERT_SIG] = rep(h[OCERT_SIG], ocert=rep(h[OCERT_SIG].ocert, sigma=_flip(h[OCERT_SIG].ocert.sigma, 63)))
    h[KES_SIG] = rep(h[KES_SIG], kes_sig=_flip(h[KES_SIG].kes_sig, len(h[KES_SIG].kes_sig) - 1))
    h[VRF_PROOF] = rep(h[VRF_PROOF], vrf_proof=_flip(h[VRF_PROOF].vrf_proof, 1))
    h[VRF_OUT] = rep(h[VRF_OUT], vrf_output=_flip(h[VRF_OUT].vrf_output, 1))
    sig = h[NONCANON_S].ocert.sigma
    s_big = (int.from_bytes(sig[32:], "little") + fe.L).to_bytes(32, "little")
    h[NONCANON_S] = rep(h[NONCANON_S], ocert=rep(h[NONCANON_S].ocert, sigma=sig[:32] + s_big))
    h[OFFCURVE_VK] = rep(h[OFFCURVE_VK], vk_cold=_off_curve())
    pre = pbatch.host_prechecks(PARAMS, lview, hvs)
    staged = pbatch.stage(PARAMS, lview, ETA0, hvs, pre.kes_evolution)
    assert pbatch.batch_is_bc(staged)
    cols = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32)
            for a in pbatch.pk_arrays(staged)]
    cols[6][0, KES_PERIOD] = (1 << DEPTH) + 2  # period out of range
    assert len(set(cols[12][0].tolist())) > 1  # KES block counts differ per lane
    return hvs, lview, cols


@pytest.fixture(scope="module")
def outputs(batch):
    _, _, c = batch
    ed = K.ed_points(c[0], c[2], c[3], c[4])
    kes = K.kes_points(c[5], c[6], c[8], c[9], c[10], c[11], c[12], DEPTH)
    prep = K.vrf_bc_prep(*c[13:19])
    pts = K.vrf_ladders(prep[1], c[17], prep[2])
    fin = K.finish(ed[0], ed[1], c[1], kes[0], kes[1], c[7], prep[0], pts,
                   prep[1], c[19], c[20], c[21])
    return ed, kes, prep, pts, fin


def test_verdicts_match_host_references(batch, outputs):
    hvs, lview, c = batch
    (flags, eta, lv) = outputs[4]
    for i, hv in enumerate(hvs):
        per = int(c[6][0, i])
        assert bool(flags[0, i]) == hed.verify(hv.vk_cold, hv.ocert.signable(), hv.ocert.sigma), i
        assert bool(flags[1, i]) == hkes.verify(hv.ocert.vk_hot, DEPTH, per, hv.signed_bytes, hv.kes_sig), i
        beta = hvrf.verify(hv.vrf_vk, hv.vrf_proof, nonces.mk_input_vrf(hv.slot, ETA0))
        assert bool(flags[2, i]) == (beta is not None and beta == hv.vrf_output), i
        lv_ref = nonces.vrf_leader_value(hv.vrf_output)
        assert int.from_bytes(bytes(lv[:, i].tolist()), "big") == lv_ref
        assert bytes(eta[:, i].tolist()) == nonces.vrf_nonce_value(hv.vrf_output)
        entry = lview.pool_distr.get(hash_key(hv.vk_cold))
        sigma = entry.stake if entry is not None else 0
        lo, hi = pbatch.leader_threshold_bracket(Fraction(sigma), PARAMS.active_slot_coeff)
        assert bool(flags[3, i]) == (lv_ref < lo)
        assert bool(flags[4, i]) == (lo <= lv_ref < hi)
    bad = {OCERT_SIG: 0, NONCANON_S: 0, OFFCURVE_VK: 0, KES_SIG: 1, KES_PERIOD: 1,
           VRF_PROOF: 2, VRF_OUT: 2}
    for lane, row in bad.items():
        assert not bool(flags[row, lane]), (lane, row)
    clean = [i for i in range(B) if i not in bad]
    assert bool(flags[:3, clean].all())


def test_stage_points_compress_to_reference(batch, outputs):
    """Compressed stage outputs: P = s·B − h·A equals R exactly on the
    valid lanes; H and 8Γ equal the host ECVRF's."""
    hvs, _, c = batch
    (ed_ok, ed_pt), (kes_ok, kes_pt), (vrf_ok, c16, prep), pts, _ = outputs
    enc = pc.compress_many([pc.unstack(ed_pt.to(torch.int64)),
                            pc.unstack(kes_pt.to(torch.int64))])
    for i, hv in enumerate(hvs):
        if i not in (OCERT_SIG, NONCANON_S, OFFCURVE_VK):
            assert bool(ed_ok[0, i])
            assert bytes(enc[0][:, i].tolist()) == hv.ocert.sigma[:32]
        if i not in (KES_SIG, KES_PERIOD):
            assert bytes(enc[1][:, i].tolist()) == hv.kes_sig[:32]
    h_enc, g8_enc = pc.compress_many([pc.unstack(pts[0:40].to(torch.int64)),
                                      pc.unstack(pts[160:200].to(torch.int64))])
    for i, hv in enumerate(hvs):
        alpha = nonces.mk_input_vrf(hv.slot, ETA0)
        assert bytes(h_enc[:, i].tolist()) == hed.point_compress(hvrf.hash_to_curve(hv.vrf_vk, alpha))
        gamma = hed.point_decompress(hv.vrf_proof[:32])
        if gamma is not None:
            assert bytes(g8_enc[:, i].tolist()) == hed.point_compress(hed.point_mul(8, gamma))
    assert not bool(vrf_ok[0, VRF_PROOF]) or not bool(outputs[4][0][2, VRF_PROOF])


def test_device_lane_code_matches_plain_twins(batch, outputs):
    """The CUDA kernels' per-lane bodies (csrc/stages.cuh), compiled as
    host C++, produce the plain twins' outputs bit for bit."""
    _, _, c = batch
    emu = build.build_host_emu()
    ed, kes, prep, pts, fin = outputs
    got = K._ed_launch(emu.pk_ed, None, c[0], c[2], c[3], c[4])
    assert all(torch.equal(a, b) for a, b in zip(got, ed))
    got = K._kes_launch(emu.pk_kes, None, c[5], c[6], c[8], c[9], c[10], c[11], c[12], DEPTH)
    assert all(torch.equal(a, b) for a, b in zip(got, kes))
    got = K._vrf_bc_prep_launch(emu.pk_vrf_bc_prep, None, *c[13:19])
    assert all(torch.equal(a, b) for a, b in zip(got, prep))
    assert torch.equal(K._vrf_ladders_launch(emu.pk_vrf_ladders, None, prep[1], c[17], prep[2]), pts)
    got = K._finish_launch(emu.pk_finish, None, ed[0], ed[1], c[1], kes[0], kes[1], c[7],
                           prep[0], pts, prep[1], c[19], c[20], c[21])
    assert all(torch.equal(a, b) for a, b in zip(got, fin))


def test_device_constants_match_rendering():
    with open(f"{build.CSRC}/consts.cuh") as f:
        assert f.read() == build.render_consts()


def test_wrappers_refuse_bad_inputs(batch):
    _, _, c = batch
    with pytest.raises(TypeError):
        K.ed_points(c[0].to(torch.int64), c[2], c[3], c[4])
    with pytest.raises(ValueError):
        K.ed_points(c[0][:, :4], c[2], c[3], c[4])
    with pytest.raises(ValueError):
        K.ed_points(c[0].T.contiguous().T, c[2], c[3], c[4])


@pytest.mark.slow
def test_matches_jax_pallas_cores(batch, outputs):
    """The JAX package's composed bc core (what its Pallas kernels run;
    a multi-minute XLA:CPU compile) gives the same verdicts, eta and
    leader values."""
    import jax
    from jax import numpy as jnp

    from ouroboros_consensus_tpu.ops.pk import verify as jpv

    _, _, c = batch
    a = [jnp.asarray(x.numpy()) for x in c]

    def f(*a):
        return jpv.verify_praos_core_bc(
            a[0], a[1], a[2], a[3], a[4][0], a[5], a[6][0], a[7], a[8], a[9],
            a[10], a[11], a[12][0], a[13], a[14], a[15], a[16], a[17], a[18],
            a[19], a[20], a[21], kes_depth=DEPTH)

    v = jax.jit(f)(*a)
    flags, eta, lv = outputs[4]
    rows = [v.ok_ocert_sig, v.ok_kes_sig, v.ok_vrf, v.ok_leader, v.leader_ambiguous]
    for r, want in enumerate(rows):
        assert (flags[r].numpy().astype(bool) == np.asarray(want)).all()
    assert (eta.numpy() == np.asarray(v.eta)).all()
    assert (lv.numpy() == np.asarray(v.leader_value)).all()
