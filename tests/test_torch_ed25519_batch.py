"""The port's batched Ed25519 verify (ouroboros_consensus_tpu_torch
ops/ed25519_batch.py: the plain twin of the `ed_verify` kernel on the
CPU) lane by lane against the JAX package's host verifier
(ops/host/ed25519.verify) and its batched verify (ops/ed25519_batch
.verify_batch), on 64 seeded lanes of messages of 0 to 300 bytes (one,
two and three SHA-512 blocks side by side) with one lane of each
corruption kind. The kernel's CUDA body, built as host C++, is held to
the twin bit for bit around its 32-lane block."""

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.ops import ed25519_batch as jeb
from ouroboros_consensus_tpu.ops import sha512 as jsha
from ouroboros_consensus_tpu.ops.host import ed25519 as he
from ouroboros_consensus_tpu_torch import native
from ouroboros_consensus_tpu_torch.ops import ed25519_batch as eb
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import field as fe
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

torch.set_num_threads(1)

B = 64
# lane -> corruption kind
KINDS = {1: "r_byte", 2: "s_plus_l", 3: "msg_byte", 4: "offcurve_a", 5: "noncanon_a",
         6: "x0_sign"}


def _off_curve() -> bytes:
    for y in range(2, 1000):
        x2 = (y * y - 1) * pow(fe.D * y * y + 1, fe.P - 2, fe.P) % fe.P
        if pow(x2, (fe.P - 1) // 2, fe.P) == fe.P - 1:
            return y.to_bytes(32, "little")
    raise AssertionError


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(2024)
    seeds = [rng.bytes(32) for _ in range(B)]
    lens = [0, 150, 300] + rng.integers(0, 301, B - 3).tolist()
    msgs = [rng.bytes(n) for n in lens]
    pks = [native.ed25519_public(s) for s in seeds]
    sigs = [native.ed25519_sign(s, m) for s, m in zip(seeds, msgs)]
    for i, kind in KINDS.items():
        if kind == "r_byte":
            sigs[i] = bytes([sigs[i][0] ^ 0x04]) + sigs[i][1:]
        elif kind == "s_plus_l":
            s = int.from_bytes(sigs[i][32:], "little") + fe.L
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        elif kind == "msg_byte":
            msgs[i] = bytes([msgs[i][0] ^ 1]) + msgs[i][1:]
        elif kind == "offcurve_a":
            pks[i] = _off_curve()
        elif kind == "noncanon_a":
            pks[i] = fe.P.to_bytes(32, "little")  # y = p
        else:
            pks[i] = bytes([1]) + bytes(30) + bytes([0x80])  # y = 1, x = 0, sign 1
    return pks, sigs, msgs


@pytest.fixture(scope="module")
def port_ok(lanes):
    return eb.verify_batch(*lanes, device="cpu")


def test_block_counts_differ_within_the_batch(lanes):
    st = eb.stage_np(*lanes)
    assert set(st.hnblocks.tolist()) == {1, 2, 3}


def test_staging_matches_reference(lanes):
    ours = eb.stage_np(*lanes)
    ref = jeb.stage_np(*lanes)
    for name in ("pk", "r", "s", "hnblocks"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name)), name
    assert np.array_equal(jsha.bytes_to_blocks_np(ours.hblocks), ref.hblocks)


def test_verify_batch_matches_host_reference(lanes, port_ok):
    pks, sigs, msgs = lanes
    want = [he.verify(pk, m, s) for pk, s, m in zip(pks, sigs, msgs)]
    assert port_ok.dtype == np.bool_
    assert port_ok.tolist() == want
    assert sorted(np.flatnonzero(~port_ok).tolist()) == sorted(KINDS)


def test_verify_batch_matches_jax_batch(lanes, port_ok):
    assert port_ok.tolist() == np.asarray(jeb.verify_batch(*lanes)).tolist()


def test_native_verifier_matches_host_reference(lanes):
    pks, sigs, msgs = lanes
    got = [native.ed25519_verify(pk, s, m) for pk, s, m in zip(pks, sigs, msgs)]
    assert got == [he.verify(pk, m, s) for pk, s, m in zip(pks, sigs, msgs)]
    assert native.ed25519_verify(pks[0], sigs[0][:63], msgs[0]) is False


def test_empty_batch():
    assert eb.verify_batch([], [], [], device="cpu").shape == (0,)


def test_block_count_outside_the_blocks_raises(lanes):
    """The host columns' counts are checked before they cross to the
    device (the wrapper does not wait for the card to check them)."""
    batch = eb.stage_np(*lanes)
    for bad in (0, batch.hblocks.shape[1] + 1):
        counts = batch.hnblocks.copy()
        counts[0] = bad
        with pytest.raises(ValueError, match="block count"):
            eb.limb_columns(batch._replace(hnblocks=counts), "cpu")


def _tile(t: torch.Tensor, n: int) -> torch.Tensor:
    reps = -(-n // t.shape[-1])
    return torch.cat([t] * reps, dim=-1)[..., :n].contiguous()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 40, 65, 70])
def test_device_lane_code_matches_plain_twin(lanes, port_ok, n):
    """ed_verify over `n` lanes around its 32-lane block, compiled as host
    C++ (the four phase-1 roles one after another over each group's
    scratch, then the chain, the two additions and the projective compare
    on a quad), equals the twin, and the twin equals the batch's own
    verdicts tiled."""
    emu = build.build_host_emu()
    cols = [_tile(c, n) for c in eb.limb_columns(eb.stage_np(*lanes), "cpu")]
    got = K._ed_verify_launch(emu.pk_ed_verify, None, *cols)
    want = K.ed_verify(*cols)
    assert torch.equal(got, want)
    tiled = _tile(torch.from_numpy(port_ok.astype(np.int32))[None], n)
    assert torch.equal(want, tiled)
