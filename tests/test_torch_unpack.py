"""The port's packed staging and the `unpack` kernel's plain version
(ouroboros_consensus_tpu_torch protocol/batch.stage_packed and
unpack_packed) against the JAX package's stage_packed and unpack_packed
on the CPU, column by column at the byte level, for bc and draft-03
windows under the neutral and a set epoch nonce; and the kernel's tile
path (csrc/wire.cuh: the launch's geometry, each block's tile of lanes
staged and then its rows stored, compiled as host C++) against the plain version at 1, 31, 32,
40, 65 and 129 lanes, with every wire corruption of
testing/corrupt.corrupt_packed (as chip_smoke.py applies them on the
card), and on a window of bodies too long for a 32-lane tile."""

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.protocol import batch as rbatch
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.testing.corrupt import corrupt_packed, first_lanes
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda
from torch_port_chain import PARAMS, forge, ref_view

torch.set_num_threads(1)

NONCE = bytes(range(7, 39))
NONCES = {"neutral": None, "set": NONCE}


@pytest.fixture(scope="module", params=["bc", "draft03"])
def window(request, tmp_path_factory):
    """The largest run of one body width of a 48-block chain forged by the
    JAX package, as port views, with the JAX ledger view."""
    path = str(tmp_path_factory.mktemp(request.param) / "db")
    lview = forge(path, draft03=request.param == "draft03")
    hvs = pda.read_header_views(path)
    width = max({len(h.signed_bytes) for h in hvs},
                key=lambda w: sum(len(h.signed_bytes) == w for h in hvs))
    hvs = [h for h in hvs if len(h.signed_bytes) == width]
    assert len(hvs) >= 16
    return request.param, hvs, lview


def _port_stage(hvs, lview, nonce):
    return pbatch.stage_packed(carry.params_from_reference(PARAMS),
                               carry.lview_from_reference(lview), nonce, hvs)


@pytest.mark.parametrize("mode", list(NONCES))
def test_packed_columns_equal_reference(window, mode):
    """The port's packed window and the reference's hold the same lanes:
    the per-lane columns byte for byte, int32 integers and indices, and
    the same KES-tail and threshold rows after the gather (the tables'
    order may differ)."""
    fmt, hvs, lview = window
    layout, got = _port_stage(hvs, lview, NONCES[mode])
    rlayout, ref = rbatch.stage_packed(PARAMS, lview, NONCES[mode],
                                       [ref_view(h) for h in hvs])
    assert tuple(layout) == tuple(rlayout)
    assert layout.vrf_proof_len == (128 if fmt == "bc" else 80)
    for name in ("body", "kes_rs", "slot", "counter", "c0", "nonce", "within"):
        have, want = getattr(got, name), np.asarray(getattr(ref, name))
        assert have.dtype == want.dtype, name
        assert np.array_equal(have, want), name
    for name in ("kes_tail_idx", "thr_idx", "slot", "counter", "c0"):
        assert getattr(got, name).dtype == np.int32, name
    for idx, tab in (("kes_tail_idx", "kes_tail_tab"), ("thr_idx", "thr_tab")):
        have = getattr(got, tab)[getattr(got, idx)]
        want = np.asarray(getattr(ref, tab))[np.asarray(getattr(ref, idx))]
        assert np.array_equal(have, want), tab
    # the chain crosses epoch boundaries: both values of `within` occur
    assert set(got.within.tolist()) == {0, 1}


def _words_to_bytes(w) -> np.ndarray:
    """The reference's SHA-512 word blocks [B, NB, 16, 2] (hi, lo) ->
    [B, NB, 128] bytes."""
    w = np.asarray(w)
    b, nb = w.shape[:2]
    return w.astype(">u4").view(np.uint8).reshape(b, nb, 128)


@pytest.mark.parametrize("mode", list(NONCES))
def test_unpack_equals_reference(window, mode):
    """unpack_packed (the kernel's plain version) on the port's packed
    window equals the JAX package's unpack_packed on its own, column by
    column: slices, padded SHA-512 blocks and block counts, the KES
    period, siblings, the VRF alpha and the threshold rows."""
    fmt, hvs, lview = window
    layout, packed = _port_stage(hvs, lview, NONCES[mode])
    rlayout, rpacked = rbatch.stage_packed(PARAMS, lview, NONCES[mode],
                                           [ref_view(h) for h in hvs])
    got = pbatch.unpack_packed(layout, packed, "cpu")
    want = rbatch.unpack_packed(rlayout, *rpacked[:10])
    assert len(got) == len(want) == (22 if fmt == "bc" else 21)
    hb = {3, 11}  # ed_hb, kes_hb
    for k, (g, w) in enumerate(zip(got, want)):
        w = _words_to_bytes(w) if k in hb else np.asarray(w)
        assert tuple(g.shape) == w.shape, k
        assert np.array_equal(g.numpy(), w.astype(np.int64)), k


WIDTHS = [1, 31, 32, 40, 65, 129]


@pytest.fixture(scope="module")
def corrupted(window):
    """Per nonce mode: a 129-lane packed window (124 tiled views, five
    bucket-padding lanes) with every wire corruption (corrupt_packed)."""
    fmt, hvs, lview = window
    rng = np.random.default_rng(5)
    out = {}
    for mode, nonce in NONCES.items():
        tiled = [hvs[i] for i in rng.integers(len(hvs), size=WIDTHS[-1] - 5).tolist()]
        layout, packed = _port_stage(tiled, lview, nonce)
        packed = corrupt_packed(layout, pbatch.pad_packed_to(packed, WIDTHS[-1]), rng)
        out[mode] = (layout, packed)
    return out


@pytest.mark.parametrize("mode", list(NONCES))
@pytest.mark.parametrize("lanes", WIDTHS)
def test_unpack_lane_code_matches_plain_twin(corrupted, mode, lanes):
    """pk_unpack (csrc/wire.cuh, block by block as host C++) writes exactly
    the plain version's limb-first arrays, as views of one [R, B] buffer
    of the shapes the stage kernels check."""
    layout, packed = corrupted[mode]
    cols = pbatch.upload_packed(first_lanes(packed, lanes), torch.device("cpu"))
    want = K.unpack_limb_first(layout, cols, "cpu")
    got = K._unpack_launch(build.build_host_emu().pk_unpack, None, layout, cols)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == torch.int32 and g.is_contiguous(), k
        assert torch.equal(g, w), k
    if lanes == WIDTHS[-1]:
        assert int(got[6].min()) < 0  # a c0 past its slot's KES period


def test_unpack_refuses_wrong_dtypes(window):
    """The wrapper checks the packed columns: numpy columns (not uploaded)
    and an int64 slot column are refused."""
    _, hvs, lview = window
    layout, packed = _port_stage(hvs[:4], lview, None)
    with pytest.raises(TypeError, match="upload_packed"):
        K.unpack_limb_first(layout, packed, "cpu")
    cols = pbatch.upload_packed(packed._replace(slot=packed.slot.astype(np.int64)),
                                torch.device("cpu"))
    with pytest.raises(TypeError, match="slot"):
        K.unpack_limb_first(layout, cols, "cpu")


def test_unpack_long_bodies_take_smaller_tiles():
    """A window of 7,000-byte bodies does not fit a 32-lane tile in
    shared memory: its tiles take 16 lanes, and the output is still the
    twin's (seeded columns, 33 lanes: two full tiles and one of a lane)."""
    rng = np.random.default_rng(17)
    b, lb, depth = 33, 7000, 7
    layout = pbatch.PackedLayout(lb, 0, 32, 64, 128, 256, 288, depth, 3600, True, 128)

    def u8(*shape):
        return rng.integers(0, 256, shape).astype(np.uint8)

    def i32(hi, n=b):
        return rng.integers(0, hi, n).astype(np.int32)

    packed = pbatch.Packed(u8(b, lb), u8(b, 64), i32(3), u8(3, 32 + 32 * depth),
                           i32(2**31), i32(2**31), i32(2**20), i32(2), u8(2, 64),
                           u8(32), u8(b))
    cols = pbatch.upload_packed(packed, torch.device("cpu"))
    # a lane's staged bytes: 3 integers, body, KES R ‖ s, tail row, threshold row, alpha
    assert 32 * (12 + lb + 64 + 32 + 32 * depth + 64 + 32) > 200 * 1024
    want = K.unpack_limb_first(layout, cols, "cpu")
    got = K._unpack_launch(build.build_host_emu().pk_unpack, None, layout, cols)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
