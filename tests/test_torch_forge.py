"""The port's forge (protocol/forge.py, tools/db_synthesizer.py) and its
two kernels (csrc/forge.cu: forge_sweep, ed_sign) against the JAX
package: the sweep's and the signer's plain twins against its host
prover and signer byte for byte, the kernels' lane bodies (compiled as
host C++) against the twins, and the three engines ("device" on the CPU
through the twins, "host", "loop") against its `synthesize(...,
vrf_backend="host")`: the same chunk, index and sidecar bytes, slots,
blocks and final state."""

import filecmp
import hashlib
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu.ops import ecvrf_batch, ed25519_batch
from ouroboros_consensus_tpu.ops.host import ecvrf as recvrf
from ouroboros_consensus_tpu.ops.host import ed25519 as red
from ouroboros_consensus_tpu.ops.host import kes as rkes
from ouroboros_consensus_tpu.protocol import nonces as rnonces
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu.testing import fixtures
from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.ops import host_kes
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
from ouroboros_consensus_tpu_torch.ops.pk import field as fe_mod
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.ops.pk import prove as pp
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol import forge as pforge
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_synthesizer as pds

# two epoch boundaries in 150 slots (epoch 0 under the neutral nonce), a
# KES period of 100 slots, 60-slot chunks
RPARAMS = rpraos.PraosParams(slots_per_kes_period=100, max_kes_evolutions=62, security_param=4,
                             active_slot_coeff=Fraction(1, 2), epoch_length=60, kes_depth=3)
PARAMS = carry.params_from_reference(RPARAMS)
SEEDS = (7, 8)
ETA = hashlib.blake2b(b"forge-test-eta0", digest_size=32).digest()


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _emu():
    return build.build_host_emu()


# ---------------------------------------------------------------------------
# the kernels' twins and lane bodies
# ---------------------------------------------------------------------------


def _table(seeds, stakes):
    x, prefix, pk = pp.stage_prove_np(seeds)
    f = Fraction(1, 2)
    rows = [pbatch.threshold_rows(Fraction(st), f) for st in stakes]
    lo = np.frombuffer(b"".join(r[0] for r in rows), np.uint8).reshape(-1, 32)
    hi = np.frombuffer(b"".join(r[1] for r in rows), np.uint8).reshape(-1, 32)
    return torch.from_numpy(pp.pool_table(x, prefix, pk, lo, hi))


def _nonce(eta):
    return None if eta is None else torch.frombuffer(bytearray(eta), dtype=torch.uint8)


@pytest.mark.parametrize("eta", [None, ETA], ids=["neutral", "eta0"])
def test_sweep_twin_matches_jax_host_prover(eta):
    """3 pools x 3 slots (the last slot partial): Γ, c16, U, V, s, β, win
    and amb against the JAX package's host prover and leader check."""
    pools = [fixtures.make_pool(n, kes_depth=3) for n in (3, 4, 5)]
    stakes = [Fraction(1, 2), Fraction(1, 3), Fraction(0)]
    slot0, b = 11, 8
    out = K.forge_sweep(_table([p.vrf_seed for p in pools], stakes), slot0, b, _nonce(eta))
    assert out.shape == (b, pp.OUT_BYTES) and out.dtype == torch.uint8
    col = {k: out[:, lo:hi].numpy() for k, (lo, hi) in pp.COLUMNS.items()}
    for i in range(b):
        pool, slot = pools[i % 3], slot0 + i // 3
        alpha = rnonces.mk_input_vrf(slot, eta)
        d3 = recvrf.prove(pool.vrf_seed, alpha)
        bc = recvrf.prove_batch_compat(pool.vrf_seed, alpha)
        assert col["gamma"][i].tobytes() == d3[:32] == bc[:32]
        assert col["c16"][i].tobytes() == d3[32:48]
        assert col["u"][i].tobytes() == bc[32:64]
        assert col["v"][i].tobytes() == bc[64:96]
        assert col["s"][i].tobytes() == d3[48:] == bc[96:]
        beta = recvrf.proof_to_hash(d3)
        assert col["beta"][i].tobytes() == beta
        lo, hi = pbatch.threshold_rows(stakes[i % 3], Fraction(1, 2))
        lv = rnonces.vrf_leader_value(beta).to_bytes(32, "big")
        assert bool(col["win"][i, 0]) == (lv < lo)
        assert bool(col["amb"][i, 0]) == (lv >= lo and lv < hi)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 37, 70])
def test_sweep_host_build_matches_twin(n):
    """The lane bodies as host C++ against the twin around the sweep's
    32-lane block (1 lane, one short of a block, a block, a block and one,
    a second group, two blocks and a ragged tail), 3 pools, a slot past
    2^32, both nonces."""
    pools = [synth.make_pool(n, kes_depth=3) for n in range(3)]
    tab = _table([p.vrf_seed for p in pools], [Fraction(1, 2)] * 3)
    for slot0, eta in ((5, None), ((1 << 33) + 7, ETA)):
        twin = K.forge_sweep(tab, slot0, n, _nonce(eta))
        emu = K._forge_sweep_launch(_emu().pk_forge_sweep, None, tab, slot0, n, _nonce(eta))
        assert torch.equal(twin, emu)


def test_sweep_scalar_top_digit():
    """x is the clamped seed, 256 bits and not reduced mod L: the largest
    clamped x (top nibble 7, every nibble below it 15 but the lowest)
    carries through the whole signed recoding."""
    pool = synth.make_pool(1, kes_depth=3)
    x, prefix, pk = pp.stage_prove_np([pool.vrf_seed])
    x[0] = np.frombuffer(bytes([0xF8]) + bytes([0xFF] * 30) + bytes([0x7F]), np.uint8)
    thr = np.zeros((1, 32), np.uint8)
    tab = torch.from_numpy(pp.pool_table(x, prefix, pk, thr, thr))
    xi = int.from_bytes(x[0].tobytes(), "little")
    twin = K.forge_sweep(tab, 9, 1, _nonce(ETA))
    emu = K._forge_sweep_launch(_emu().pk_forge_sweep, None, tab, 9, 1, _nonce(ETA))
    assert torch.equal(twin, emu)
    h = recvrf.hash_to_curve(pk[0].tobytes(), rnonces.mk_input_vrf(9, ETA))
    g = twin[0, 0:32].numpy().tobytes()
    assert g == red.point_compress(red.point_mul(xi, h))
    k = int.from_bytes(hashlib.sha512(prefix[0].tobytes() + red.point_compress(h)).digest(),
                       "little") % red.L
    c = int.from_bytes(twin[0, 32:48].numpy().tobytes(), "little")
    assert int.from_bytes(twin[0, 112:144].numpy().tobytes(), "little") == (k + c * xi) % red.L
    assert not twin[0, 208] and not twin[0, 209]  # lv < 0 never holds


def _sign_inputs(msgs):
    seeds = [hashlib.sha256(b"sign%d" % i).digest() for i in range(len(msgs))]
    return seeds, [torch.from_numpy(np.ascontiguousarray(a)) for a in pp.stage_sign_np(seeds, msgs)]


# messages of 0 to 200 bytes: one to three SHA-512 blocks on either side
# (an OCert signable is 48)
SIGN_LENGTHS = (0, 48, 63, 64, 111, 200)
SIGN_MSGS = {"six-lengths": [b"", b"o" * 48, b"m" * 63, b"n" * 64, b"q" * 111, b"r" * 200]}
SIGN_MSGS.update({str(n): [bytes([k % 251]) * SIGN_LENGTHS[k % 6] for k in range(n)]
                  for n in (1, 2, 31, 32, 33, 70)})
# and 400 bytes: four blocks a side, h's fourth read past the three staged
SIGN_MSGS["33-with-400"] = [bytes([k % 251]) * (SIGN_LENGTHS + (400,))[k % 7] for k in range(33)]


@pytest.mark.parametrize("case", list(SIGN_MSGS))
def test_ed_sign_twin_and_host_build_match_jax_signer(case):
    """The twin and the kernel's body (the host build: warp 0's hashes, the
    teams' walks and sums, the block's tree) against the JAX package's
    host signer and the port's C++ signer, around the 32-signable block
    (1, 2, one short of a block, a block, a block and one, three blocks),
    messages of 0 to 200 bytes, and 400 (NB = 4) at 33 signables."""
    from ouroboros_consensus_tpu_torch import native

    msgs = SIGN_MSGS[case]
    seeds, staged = _sign_inputs(msgs)
    twin = K.ed_sign(*staged)
    emu, bad = K._ed_sign_launch(_emu().pk_ed_sign, None, *staged)
    assert torch.equal(twin, emu)
    assert bad.tolist() == [0] * (-(-len(msgs) // 32))
    for i, (seed, m) in enumerate(zip(seeds, msgs)):
        assert twin[i].numpy().tobytes() == red.sign(seed, m) == native.ed25519_sign(seed, m)


def _scalar(x: int) -> bytes:
    return x.to_bytes(32, "little")


# 0, 1, L - 1, middle windows 0 (identity entries inside the teams' sums:
# windows 8-23 span parts 2 to 5 whole), every window 255
WALK_SCALARS = (0, 1, red.L - 1,
                int.from_bytes(bytes([0x5A] * 8) + bytes(16) + bytes([0xC3] * 8), "little"),
                (1 << 256) - 1)


def test_ed_sign_tree_walk_matches_twin_base_mul():
    """R = r·B alone (the host build's teams: each part's four windows,
    then the pairwise sums) against the twin's `base_mul_w8` on crafted
    scalars, as points (the same compression; the sums' order differs, so
    the limbs do), against the JAX package's host `base_point_mul`, and
    X·Y = Z·T."""
    rows = [_scalar(x) for x in WALK_SCALARS]
    r = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, 32).copy()
    b = r.shape[0]
    base8 = K._base8(torch.device("cpu"))
    pts = np.zeros((b, 40), np.uint32)
    assert _emu().pk_ed_sign_walk(b, base8.data_ptr(), r.ctypes.data, pts.ctypes.data) == 0
    got = pc.unstack(torch.from_numpy(pts.T.astype(np.int64)))
    want = pc.base_mul_w8(torch.from_numpy(r.T.astype(np.int64)))
    assert torch.equal(pc.compress_many([got])[0], pc.compress_many([want])[0])
    for i, sc in enumerate(WALK_SCALARS):
        x, y, z, t = (sum(int(v) << fe_mod.OFF[k] for k, v in enumerate(pts[i, 10 * c:10 * c + 10]))
                      for c in range(4))
        assert (x * y - z * t) % fe_mod.P == 0
        assert red.point_equal((x, y, z, t), red.base_point_mul(sc))


def test_staging_matches_jax_staging():
    seeds = [fixtures.make_pool(n).vrf_seed for n in range(4)]
    for mine, ref in zip(pp.stage_prove_np(seeds), ecvrf_batch.stage_prove_np(seeds)):
        assert np.array_equal(mine, ref)
    msgs = [b"a" * 48, b"b" * 150]
    mine = pp.stage_sign_np(seeds[:2], msgs)
    ref = ed25519_batch.stage_sign_np(seeds[:2], msgs)
    assert np.array_equal(mine[0], ref.a) and np.array_equal(mine[1], ref.a_enc)
    assert np.array_equal(mine[3], ref.rnblocks) and np.array_equal(mine[5], ref.hnblocks)
    cols = [np.arange(k * 4, dtype=np.uint8).reshape(4, k) for k in (32, 16, 32, 32, 32)]
    for compat in (True, False):
        assert np.array_equal(pp.encode_proofs_np(*cols, compat),
                              ecvrf_batch.encode_proofs_np(*cols, compat))


def test_kes_leaf_path_and_sign_match_jax():
    seed = hashlib.sha256(b"kes").digest()
    for t in range(1 << 3):
        leaf, tail = host_kes.leaf_path(seed, 3, t)
        rleaf, rsibs = rkes.leaf_path(seed, 3, t)
        assert leaf == rleaf and tail[32:] == b"".join(rsibs)
        assert host_kes.sign(seed, 3, t, b"msg") == rkes.sign(seed, 3, t, b"msg")
    assert host_kes.derive_vk(seed, 3) == rkes.derive_vk(seed, 3)
    with pytest.raises(ValueError):
        host_kes.leaf_path(seed, 3, 8)


def test_wrappers_check_their_inputs():
    tab = _table([synth.make_pool(0).vrf_seed], [Fraction(1)])
    with pytest.raises(TypeError):
        K.forge_sweep(tab.to(torch.int32), 0, 1, None)
    with pytest.raises(ValueError):
        K.forge_sweep(tab, 0, 1, torch.zeros(31, dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.forge_sweep(tab.to("meta"), 0, 1, None)
    _seeds, staged = _sign_inputs([b"x"])
    with pytest.raises(ValueError):
        K.ed_sign(staged[0][:, :31].contiguous(), *staged[1:])
    a, a_enc, rb, rn, hb, hn = staged
    nb = rb.shape[1]
    for bad_rn, bad_hn in ((rn * 0, hn), (rn, hn * 0 + nb + 1), (rn * 0 - 1, hn)):
        with pytest.raises(ValueError, match="block count"):
            K.ed_sign(a, a_enc, rb, bad_rn, hb, bad_hn)


def test_ed_sign_card_route_reads_nothing_back_before_the_launch(monkeypatch):
    """The card route of `kernels.ed_sign`, run here on the host build: no
    torch call before the launch reads a tensor back to the host (the
    kernel checks the block counts and flags its block; the wrapper reads
    the flags after the launch, once), and an out-of-range count still
    raises ValueError there."""
    from torch.overrides import TorchFunctionMode

    seen = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            seen.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    emu = _emu().pk_ed_sign

    def launch(*args):
        seen.append("<launch>")
        return emu(*args)

    _seeds, staged = _sign_inputs([b"x" * 48, b"y" * 150, b""])
    want = K.ed_sign(*staged)  # the plain route
    K._base8(staged[0].device)  # the table, once
    monkeypatch.setattr(K, "_route", lambda dev: "cuda")
    monkeypatch.setattr(K, "_stream", lambda dev: None)
    monkeypatch.setattr(build, "kernel_lib", lambda name, entry=None: launch)
    reads = {"item", "cpu", "tolist", "numpy", "__int__", "__bool__", "__float__", "__index__",
             "aminmax", "to", "copy_"}
    with Spy():
        got = K.ed_sign(*staged)
    at = seen.index("<launch>")
    assert not reads & set(seen[:at]), seen[:at]
    assert seen[at + 1:].count("cpu") == 1
    assert torch.equal(got, want)
    a, a_enc, rb, rn, hb, hn = staged
    nb = rb.shape[1]
    for bad_rn, bad_hn in ((rn * 0, hn), (rn, hn * 0 + nb + 1), (rn * 0 - 1, hn)):
        seen.clear()
        with pytest.raises(ValueError, match="block count"), Spy():
            K.ed_sign(a, a_enc, rb, bad_rn, hb, bad_hn)
        assert "<launch>" in seen and not reads & set(seen[:seen.index("<launch>")])
    # the kernel reads 16 bytes at a time: data off a 16-byte boundary is refused
    shifted = torch.empty(a.numel() + 1, dtype=torch.uint8)[1:].view(a.shape)
    shifted.copy_(a)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.ed_sign(shifted, a_enc, rb, rn, hb, hn)


# ---------------------------------------------------------------------------
# the engines against the JAX package's synthesizer
# ---------------------------------------------------------------------------


def _jax(path, limit, fmt="bc", pools=SEEDS, stakes=None, view=None):
    rpools = [fixtures.make_pool(n, kes_depth=3) for n in pools]
    lview = fixtures.make_ledger_view([fixtures.make_pool(n, kes_depth=3)
                                       for n in (view or pools)], stakes=stakes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OCT_VRF_BATCH", "0" if fmt == "draft03" else "1")
        mp.delenv("OCT_FORGE_DEVICE", raising=False)
        return jds.synthesize(str(path), RPARAMS, rpools, lview, jds.ForgeLimit(**limit),
                              txs_per_block=2, chunk_size=60, vrf_backend="host")


def _port(path, limit, engine, fmt="bc", pools=SEEDS, stakes=None, view=None):
    ppools = [synth.make_pool(n, kes_depth=3) for n in pools]
    lview = synth.make_ledger_view([synth.make_pool(n, kes_depth=3) for n in (view or pools)],
                                   stakes=stakes)
    return pds.synthesize(str(path), PARAMS, ppools, lview, pds.ForgeLimit(**limit),
                          txs_per_block=2, chunk_size=60, engine=engine,
                          device="cpu" if engine == "device" else None, proof_format=fmt)


def _files(path):
    d = os.path.join(str(path), "immutable")
    return sorted(f for f in os.listdir(d) if f.endswith((".chunk", ".index", ".cols"))) \
        if os.path.isdir(d) else []


def _same_files(a, b) -> None:
    fa = _files(a)
    assert fa == _files(b)
    for f in fa:
        assert filecmp.cmp(os.path.join(str(a), "immutable", f),
                           os.path.join(str(b), "immutable", f), shallow=False), f


def _same_as_jax(ref, ref_path, got, got_path) -> None:
    _same_files(ref_path, got_path)
    assert (got.n_slots, got.n_blocks) == (ref.n_slots, ref.n_blocks)
    assert carry.state_to_plain(got.final_state) == carry.state_to_plain(ref.final_state)


def _all_engines(tmp_path, limit, **kw):
    ref = _jax(tmp_path / "jax", limit, **kw)
    out = {}
    for engine in pds.ENGINES:
        got = _port(tmp_path / engine, limit, engine, **kw)
        _same_as_jax(ref, tmp_path / "jax", got, tmp_path / engine)
        out[engine] = got
    return ref, out


@pytest.mark.parametrize("fmt", ["bc", "draft03"])
def test_engines_match_jax_across_epochs(tmp_path, fmt):
    ref, _ = _all_engines(tmp_path, {"slots": 150}, fmt=fmt)
    assert ref.n_blocks > 0 and len(_files(tmp_path / "jax")) == 9  # 3 chunks and their seals


@pytest.mark.parametrize("limit", [{"slots": 60}, {"blocks": 23}, {"epochs": 2}],
                         ids=["epoch0-alone", "blocks", "epochs"])
def test_engines_match_jax_each_limit(tmp_path, limit):
    """Epoch 0 alone (the neutral nonce's windows only); a blocks limit
    that trips mid-window (the slots counted end at its block); an
    epochs limit."""
    ref, _ = _all_engines(tmp_path, limit)
    if "blocks" in limit:
        assert ref.n_blocks == 23 and ref.n_slots < 150


def test_engines_mixed_format(tmp_path):
    """Draft-03 proofs below block 20, batch-compatible from there: the
    three engines agree, and the chain below the switch is the JAX
    package's draft-03 chain."""
    fmt = lambda n: 80 if n < 20 else 128  # noqa: E731
    got = {e: _port(tmp_path / e, {"slots": 150}, e, fmt=fmt) for e in pds.ENGINES}
    for e in ("host", "device"):
        _same_files(tmp_path / "loop", tmp_path / e)
        assert got[e].final_state == got["loop"].final_state
        assert got[e].n_slots == got["loop"].n_slots == 150
    _jax(tmp_path / "jax", {"slots": 150}, fmt="draft03")

    def blocks(p):
        from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB

        imm = ImmutableDB(os.path.join(str(p), "immutable"))
        return [imm.read_chunk(n)[e.offset: e.offset + e.size]
                for n, es in imm.chunk_entries() for e in es]

    mine, ref = blocks(tmp_path / "loop"), blocks(tmp_path / "jax")
    assert mine[:20] == ref[:20] and mine[20] != ref[20]
    assert len(mine) > 40


def test_engines_match_jax_empty_windows(tmp_path):
    """Stake 0 everywhere: no pool ever leads; the whole slot budget is
    spent and nothing is written."""
    ref, out = _all_engines(tmp_path, {"slots": 80}, stakes=[Fraction(0)] * 2)
    assert ref.n_blocks == 0 and ref.n_slots == 80 and _files(tmp_path / "device") == []


def test_engines_match_jax_pool_missing_from_view(tmp_path):
    """A credential the view does not know has stake 0 (the loop skips
    it): the same chain, and the stranger forges nothing."""
    ref, _ = _all_engines(tmp_path, {"slots": 100}, pools=SEEDS + (99,), view=SEEDS)
    stranger = synth.make_pool(99, kes_depth=3).vk_cold
    for f in _files(tmp_path / "device"):
        if f.endswith(".chunk"):
            assert stranger not in open(os.path.join(tmp_path / "device", "immutable", f),
                                        "rb").read()
    assert ref.n_blocks > 0


def test_small_windows_take_many_launches(tmp_path, monkeypatch):
    """Seven-slot election windows: the device engine sweeps 12 windows
    over 75 slots (one launch each; they end every 7 slots and at the
    epoch's end, slot 60), the host engine as many, both the loop's
    bytes."""
    calls = []
    real = K.forge_sweep

    def counted(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(pforge, "window_slots", lambda n: 7)
    monkeypatch.setattr(pforge.pk_kernels, "forge_sweep", counted)
    loop = _port(tmp_path / "loop", {"slots": 75}, "loop")
    for e in ("device", "host"):
        got = _port(tmp_path / e, {"slots": 75}, e)
        _same_files(tmp_path / "loop", tmp_path / e)
        assert (got.n_slots, got.n_blocks, got.final_state) == (
            loop.n_slots, loop.n_blocks, loop.final_state)
    assert len(calls) == 9 + 3 and sum(calls) == 75 * len(SEEDS)
    assert loop.n_blocks > 20


def test_ocert_batch_signs_as_the_host(tmp_path):
    pools = [synth.make_pool(n, kes_depth=3) for n in SEEDS]
    triples = {(0, 0, 0), (1, 0, 62), (0, 2, 124)}
    got = pforge.sign_ocerts_batch(pools, triples, torch.device("cpu"))
    assert set(got) == triples
    for (i, n, kp0), oc in got.items():
        assert oc == pools[i].make_ocert(n, kp0)
    assert pforge.sign_ocerts_batch(pools, set(), torch.device("cpu")) == {}


def test_synthesize_refuses(tmp_path):
    pools = [synth.make_pool(0, kes_depth=3)]
    lview = synth.make_ledger_view(pools)
    for kw, exc in (({"engine": "gpu"}, ValueError), ({"proof_format": "x"}, ValueError)):
        with pytest.raises(exc):
            pds.synthesize(str(tmp_path / "a"), PARAMS, pools, lview, pds.ForgeLimit(slots=4),
                           **kw)
    with pytest.raises(ValueError, match="limit"):
        pds.synthesize(str(tmp_path / "a"), PARAMS, pools, lview, pds.ForgeLimit(),
                       engine="host")
    assert not os.path.exists(tmp_path / "a")
    pds.synthesize(str(tmp_path / "b"), PARAMS, pools, lview, pds.ForgeLimit(blocks=3),
                   engine="host")
    with pytest.raises(RuntimeError, match="non-empty"):
        pds.synthesize(str(tmp_path / "b"), PARAMS, pools, lview, pds.ForgeLimit(blocks=3),
                       engine="host")


def test_cli_forges_with_the_reference_params(tmp_path, capsys):
    """The CLI on the host engine: the reference CLI's parameters and
    credentials, the loop's bytes."""
    out = tmp_path / "cli"
    assert pds.main(["--out", str(out), "--blocks", "6", "--pools", "2", "--kes-depth", "2",
                     "--engine", "host", "--txs-per-block", "1"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("forged 6 blocks over ") and "engine host" in line
    params = pds.default_params(kes_depth=2)
    pools, lview = pds.make_credentials(2, kes_depth=2)
    ref = pds.synthesize(str(tmp_path / "loop"), params, pools, lview,
                         pds.ForgeLimit(blocks=6), txs_per_block=1, engine="loop")
    assert ref.n_blocks == 6
    _same_files(tmp_path / "loop", out)
