"""The window aggregate (ouroboros_consensus_tpu_torch/ops/pk/
aggregate.py, plain PyTorch on the CPU): the Fiat–Shamir coefficients
and the key dedupe against the JAX package's (seeded numpy inputs into
both), `aggregate_window` on a clean batch-compatible window of
port-forged headers against the per-lane stage twins, every corrupted
field of the reference's matrix (and a torsion-offset R_e and R_k)
rejected, and the `agg_prep` and `msm` device bodies (csrc/agg.cuh,
built as host C++) held to the twins."""

import ctypes

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from ouroboros_consensus_tpu.ops.host import ed25519 as he
from ouroboros_consensus_tpu.ops.pk import aggregate as jagg
from ouroboros_consensus_tpu.ops.pk import curve as jpc
from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import field as fe
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.ops.pk import scalar as sc

torch.set_num_threads(1)
DEPTH = 3
LANES = 8


def _limbs13(vals) -> np.ndarray:
    return np.array([[(v >> (13 * i)) & 8191 for v in vals] for i in range(20)], np.int32)


def _int13(col) -> list[int]:
    a = np.asarray(col)
    return [sum(int(a[i, j]) << (13 * i) for i in range(a.shape[0])) for j in range(a.shape[1])]


def _fs_inputs(t: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n, t)).astype(np.int32)
            for n in (32, 32, 64, 32, 32, 64, 32, 32, 32, 32, 32, 32, 64)]


def test_fs_coefficients_match_jax():
    args = _fs_inputs(6, seed=21)
    want = jax.jit(jagg.fs_coefficients)(*(jnp.asarray(a) for a in args))
    got = pa.fs_coefficients(*(torch.from_numpy(a) for a in args))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
        assert (g[0] & 1 == 1).all()


@pytest.mark.parametrize("cap", [256, 2])
def test_dedupe_matches_jax(cap):
    rng = np.random.default_rng(22)
    t = 12
    base = rng.integers(0, 256, (32,))
    keys = np.stack([base] * t, 1)
    keys[31, [1, 4, 7]] ^= 1  # differs in the last byte only
    keys[0, [2, 5, 9, 11]] = 200  # in the first, above 127
    keys[16, [3, 10]] ^= 0x80
    coeff = [int(v) for v in rng.integers(0, 2**62, t)]
    coeff = [(c << 190) % sc.L for c in coeff]
    xs = [[int.from_bytes(rng.bytes(32), "little") % fe.P for _ in range(t)] for _ in range(4)]
    jt, jp, jok = jagg._dedupe_column(
        jnp.asarray(keys.astype(np.int32)), jnp.asarray(_limbs13(coeff)),
        jpc.Point(*(jnp.asarray(_limbs13(c)) for c in xs)), cap)
    pts = torch.tensor([[limb for c in xs for limb in fe.int_to_limbs(c[j])] for j in range(t)],
                       dtype=torch.int32)
    cbytes = torch.tensor([list(c.to_bytes(32, "little")) for c in coeff], dtype=torch.uint8)
    raw, tp, ok = pa.dedupe_column(torch.from_numpy(keys.astype(np.int32)), cbytes, pts, cap)
    assert bool(ok) == bool(jok) == (cap >= 7)
    assert sc.to_int(pa.agg_tables_plain(raw).T) == _int13(jt)
    got = tp.to(torch.int64)
    for k, c in enumerate(jp):
        want = _int13(c)
        have = [sum(int(got[j, 10 * k + i]) << fe.OFF[i] for i in range(10)) for j in range(cap)]
        assert have == want


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    """LANES port-forged batch-compatible headers of one body width as the
    22 limb-first arrays (unpack's order)."""
    from fractions import Fraction

    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.protocol.praos import PraosParams
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    params = PraosParams(slots_per_kes_period=20, max_kes_evolutions=62, security_param=2,
                         active_slot_coeff=Fraction(1, 2), epoch_length=1000,
                         kes_depth=DEPTH)
    pools = [synth.make_pool(0, kes_depth=DEPTH)]
    lview = synth.make_ledger_view(pools)
    db = str(tmp_path_factory.mktemp("agg") / "db")
    synth.synthesize(db, params, pools, lview, 16)
    hvs = db_analyser.read_header_views(db)
    width = max({len(h.signed_bytes) for h in hvs},
                key=lambda w: sum(len(h.signed_bytes) == w for h in hvs))
    hvs = [h for h in hvs if len(h.signed_bytes) == width][:LANES]
    assert len(hvs) == LANES
    layout, packed = pbatch.stage_packed(params, lview, None, hvs)
    return [c.contiguous() for c in
            K.staged_to_limb_first_bc(*pbatch.unpack_packed(layout, packed, "cpu"))]


def test_clean_window_aggregates_to_the_identity(window):
    av = pa.aggregate_window(*window, kes_depth=DEPTH)
    assert bool(av.agg_ok) and bool(av.pre_ok)
    flags, eta, lv = K.verify_praos_tiles_bc(*window, kes_depth=DEPTH)
    assert torch.equal(av.flags, flags)
    assert torch.equal(av.eta, eta) and torch.equal(av.leader_value, lv)


def _torsion8():
    for b0 in range(256):
        q = he.point_decompress(bytes([b0]) + bytes(31))
        if q is None:
            continue
        t = he.point_mul(he.L, q)
        if not he.point_equal(he.point_mul(4, t), he.IDENT):
            return t
    raise AssertionError("no order-8 point")


def _shift_point(col, lane, by):
    """Replace the encoding in column `col` at `lane` by that of P + by."""
    p = he.point_decompress(bytes(col[:, lane].tolist()))
    enc = he.point_compress(he.point_add(p, by))
    col[:, lane] = torch.tensor(list(enc), dtype=torch.int32)


def _corrupt(window, kind: str, lane: int):
    cols = [c.clone() for c in window]
    if kind == "ocert_sig":
        cols[2][0, lane] ^= 1  # s of the OCert signature, still canonical
    elif kind == "kes_sig":
        cols[8][0, lane] ^= 1  # s of the KES leaf signature
    elif kind == "vrf_proof":
        _shift_point(cols[15], lane, he.B)  # the announced U, still a point
    elif kind == "beta":
        cols[19][0, lane] ^= 1
    elif kind == "ed_torsion":
        _shift_point(cols[1], lane, _torsion8())  # R_e + T8
    elif kind == "kes_torsion":
        _shift_point(cols[7], lane, _torsion8())  # R_k + T8
    return cols


KINDS = ("ocert_sig", "kes_sig", "vrf_proof", "beta", "ed_torsion", "kes_torsion")
ROW = {"ocert_sig": 0, "ed_torsion": 0, "kes_sig": 1, "kes_torsion": 1,
       "vrf_proof": 2, "beta": 2}


@pytest.mark.parametrize("kind", KINDS)
def test_corrupted_lane_dirties_the_window(window, kind):
    """A corrupted group equation (a signature, the announced U, a
    torsion-offset R) makes the combination miss the identity: agg_ok is
    false and every lane's signature rows are voided, while the cheap
    checks still pass. A wrong declared β is no group equation (β enters
    only the transcript): it fails its lane's cheap β compare, as in the
    reference, and the combination stays the identity. Either way the
    window is not clean, and the per-lane twins flag exactly the lane."""
    cols = _corrupt(window, kind, 5)
    av = pa.aggregate_window(*cols, kes_depth=DEPTH)
    if kind == "beta":
        assert bool(av.agg_ok) and not bool(av.pre_ok)
        assert av.flags[2].tolist() == [1] * 5 + [0] + [1] * (LANES - 6)
    else:
        assert not bool(av.agg_ok) and bool(av.pre_ok)
        assert not bool(av.flags[:3].any())
    flags, _, _ = K.verify_praos_tiles_bc(*cols, kes_depth=DEPTH)
    assert flags[ROW[kind]].tolist() == [1] * 5 + [0] + [1] * (LANES - 6)


@pytest.fixture(scope="module")
def host():
    return build.build_host_emu()


def _host_prep(host, cols):
    b = cols[0].shape[-1]
    outs = [torch.empty((pa.N_PTS, b, 40), dtype=torch.int32),
            torch.empty((pa.N_SC, b, 32), dtype=torch.uint8),
            *(torch.empty((r, b), dtype=torch.int32) for r in (5, 32, 32))]
    ptrs = (ctypes.c_void_p * 22)(*(c.data_ptr() for c in cols))
    assert host.pk_agg_prep(b, DEPTH, cols[3].shape[0], cols[11].shape[0], ptrs,
                            *(o.data_ptr() for o in outs), None) == 0
    return outs


def test_host_agg_prep_matches_twin(window, host):
    cols = [c.clone() for c in window]
    for k, kind in enumerate(("ocert_sig", "beta", "ed_torsion", "vrf_proof")):
        cols = _corrupt(cols, kind, 2 * k)
    cols[13][:, 7] = torch.tensor([1] + [0] * 30 + [0x80], dtype=torch.int32)  # x = 0, sign 1
    got = _host_prep(host, cols)
    want = pa.agg_prep_plain(*cols, kes_depth=DEPTH)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["clean", "kes_torsion"])
def test_host_msm_decides_the_aggregate(window, host, kind):
    """The device body of the bucket machine on the aggregate's own MSM:
    the identity on the clean window, not with one torsion-offset R_k."""
    from tests.test_torch_msm import _host_msm

    cols = window if kind == "clean" else _corrupt(window, kind, 3)
    pts, scal, _, _, _ = pa.agg_prep_plain(*cols, kes_depth=DEPTH)
    raw, tpts, ok_cap = pa.window_tables(cols, pts, scal)
    assert bool(ok_cap.all())
    points, scalars, n_small, base = pa.msm_inputs(pts, scal, tpts, pa.agg_tables_plain(raw))
    _, ident, _, _ = _host_msm(host, points, scalars, n_small, base)
    assert ident == (1 if kind == "clean" else 0)
