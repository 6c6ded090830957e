"""The six Praos stage kernels: wrappers, launch counts, plain twins.

Each stage of ops/pk/verify.py is one hand-written CUDA kernel
(csrc/<name>.cu, one lane per thread, 128 threads per block, grid sized
to the lanes), bound with ctypes (build.py). A wrapper checks device,
dtype, shape and contiguity, allocates its outputs with torch.empty,
launches on the current stream without synchronising, raises when the
launcher's cudaGetLastError() is not 0, and adds one to LAUNCHES[name].
For CPU tensors it runs the plain PyTorch twin instead (verify.py — the
same integer operations in the same order); any other device raises.
There is no fallback between the two.

Layout is the JAX package's: limb-first int32 [rows, B] with lanes last;
byte rows hold 0..255; ok rows are [1, B]. Inputs and the final outputs
(ok rows, c16, verdicts, eta, lv) have exactly the JAX layout and dtype.
The inter-stage point columns are the port's radix: a point is [40, B]
(X ‖ Y ‖ Z ‖ T, 10 limbs of 2^25.5 each), the VRF prep output is
H ‖ Y ‖ Γ [120, B] and the ladder output H ‖ Γ ‖ U' ‖ V' ‖ 8Γ [200, B]
(the TPU stages used 20 x 13-bit limbs: [80, B] per point).

Bound on the card: every stage is bound by operations — 32x32->64
integer products in the field work (100 per multiply; 55 per squaring
is the least a squaring needs, though fe_sqr is still fe_mul(a, a)) —
not by bytes (a lane moves under 2.5 KB through device memory). The
design answer is the radix: 10 limbs of 25.5 bits turn the TPU's 400
13-bit products per multiply into 100 native IMAD.WIDE products, and the loose
limb form keeps carries to two parallel passes. Per-lane window tables
(16 points) live in local memory. A bound below is the wide products
over 132 SMs x 32 per clock (64 32-bit IMADs, two per 64-bit product)
at 1,980 MHz. PERF.md keeps each kernel's measured time beside its
bound (scripts of record: chip_smoke.py).
"""

from __future__ import annotations

import torch

from . import curve as pc
from . import verify as pv

# kernel source -> launches on the card (the plain twins do not count);
# the two tool kernels (tools/debug_pk.py, tools/fe_bench.py) count here too
LAUNCHES = {"ed": 0, "kes": 0, "vrf_prep": 0, "vrf_bc_prep": 0,
            "vrf_ladders": 0, "finish": 0, "primitives": 0, "fe_bench": 0}

_BASE8: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _base8(device: torch.device) -> torch.Tensor:
    """The fixed-base table on `device`: [32 * 256 * 40] int32 limbs."""
    key = str(device)
    if key not in _BASE8:
        _BASE8[key] = pc.base8().to(torch.int32).reshape(-1).contiguous().to(device)
    return _BASE8[key]


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _route(device: torch.device) -> str:
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {device}")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


# ---------------------------------------------------------------------------
# ed
# ---------------------------------------------------------------------------


def _ed_launch(fn, stream, pk, s, hblocks, hnblocks):
    b, nb = pk.shape[-1], hblocks.shape[0]
    ok = torch.empty((1, b), dtype=torch.int32, device=pk.device)
    pt = torch.empty((40, b), dtype=torch.int32, device=pk.device)
    rc = fn(b, _p(_base8(pk.device)), _p(pk), _p(s), _p(hblocks), nb,
            _p(hnblocks), _p(ok), _p(pt), stream)
    _raise_on(rc, "ed")
    return ok, pt


def ed_points(pk, s, hblocks, hnblocks):
    """OCert Ed25519 verify-point. pk, s [32, B]; hblocks [NB, 128, B];
    hnblocks [1, B] -> (ok [1, B], P [40, B]).

    Replaces ouroboros_consensus_tpu/ops/pk/kernels.py:_ed_kernel
    (csrc/ed.cu). Operations-bound: decompress (one 254-squaring chain),
    SHA-512 over the message blocks, mod-L reduce, a 32-add fixed-base
    walk (table in global memory read through __ldg, resident in L2) and
    a 64-window variable-base ladder (table in local memory).
    On an H100 80GB HBM3 at 700 W: 2,044 multiplies and 1,279 squarings a
    lane (274,745 wide products) bound it at 0.27 ms per 8192 lanes;
    chip_smoke.py measured 2.11 ms."""
    dev = pk.device
    b, nb = pk.shape[-1], hblocks.shape[0]
    for n, t, sh in (("pk", pk, (32, b)), ("s", s, (32, b)),
                     ("hblocks", hblocks, (nb, 128, b)),
                     ("hnblocks", hnblocks, (1, b))):
        _check(f"ed_points.{n}", t, sh, dev)
    if _route(dev) == "plain":
        ok, p = pv.ed_core(pk, s, hblocks, hnblocks[0])
        return ok.to(torch.int32)[None], pc.stack(p).to(torch.int32)
    from . import build

    out = _ed_launch(build.kernel_lib("ed"), _stream(dev), pk, s, hblocks, hnblocks)
    LAUNCHES["ed"] += 1
    return out


# ---------------------------------------------------------------------------
# kes
# ---------------------------------------------------------------------------


def _kes_launch(fn, stream, vk, period, s, vk_leaf, siblings, hblocks,
                hnblocks, depth):
    b, nb = vk.shape[-1], hblocks.shape[0]
    ok = torch.empty((1, b), dtype=torch.int32, device=vk.device)
    pt = torch.empty((40, b), dtype=torch.int32, device=vk.device)
    rc = fn(b, depth, _p(_base8(vk.device)), _p(vk), _p(period), _p(s),
            _p(vk_leaf), _p(siblings), _p(hblocks), nb, _p(hnblocks),
            _p(ok), _p(pt), stream)
    _raise_on(rc, "kes")
    return ok, pt


def kes_points(vk, period, s, vk_leaf, siblings, hblocks, hnblocks, depth):
    """CompactSum KES verify-point. vk, s, vk_leaf [32, B]; period [1, B];
    siblings [depth, 32, B]; hblocks [NB, 128, B]; hnblocks [1, B] ->
    (ok [1, B], P [40, B]).

    Replaces ouroboros_consensus_tpu/ops/pk/kernels.py:_kes_kernel
    (csrc/kes.cu). Operations-bound: the ed stage's work on the leaf
    signature plus `depth` single-block Blake2b compressions; siblings
    are indexed by level, so an out-of-range period never reads out of
    bounds (its lane fails the period check).
    On an H100 80GB HBM3 at 700 W: the ed stage's 274,745 wide products a
    lane bound it at 0.27 ms per 8192 lanes; chip_smoke.py measured 2.32 ms."""
    dev = vk.device
    b, nb = vk.shape[-1], hblocks.shape[0]
    for n, t, sh in (("vk", vk, (32, b)), ("period", period, (1, b)),
                     ("s", s, (32, b)), ("vk_leaf", vk_leaf, (32, b)),
                     ("siblings", siblings, (depth, 32, b)),
                     ("hblocks", hblocks, (nb, 128, b)),
                     ("hnblocks", hnblocks, (1, b))):
        _check(f"kes_points.{n}", t, sh, dev)
    if _route(dev) == "plain":
        ok, p = pv.kes_core(vk, period[0], s, vk_leaf, siblings, hblocks,
                            hnblocks[0], depth)
        return ok.to(torch.int32)[None], pc.stack(p).to(torch.int32)
    from . import build

    out = _kes_launch(build.kernel_lib("kes"), _stream(dev), vk, period, s,
                      vk_leaf, siblings, hblocks, hnblocks, depth)
    LAUNCHES["kes"] += 1
    return out


# ---------------------------------------------------------------------------
# vrf: prep (draft-03 or batch-compatible), then the shared ladders
# ---------------------------------------------------------------------------


def _vrf_prep_launch(fn, stream, pk, gamma, s, alpha):
    b = pk.shape[-1]
    dev = pk.device
    ok = torch.empty((1, b), dtype=torch.int32, device=dev)
    prep = torch.empty((120, b), dtype=torch.int32, device=dev)
    rc = fn(b, _p(pk), _p(gamma), _p(s), _p(alpha), _p(ok), _p(prep), stream)
    _raise_on(rc, "vrf_prep")
    return ok, prep


def vrf_prep(pk, gamma, s, alpha):
    """Draft-03 ECVRF stage A. All inputs [32, B] ->
    (ok [1, B], H ‖ Y ‖ Γ [120, B]); the challenge is the proof's own c.

    Replaces ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_prep_kernel
    (csrc/vrf_prep.cu). Operations-bound: two decompressions and the
    single-chain Elligator2 (three exponentiation chains) and one SHA-512
    compression — vrf_bc_prep without the inversion that compresses H and
    the challenge's SHA-512.
    On an H100 80GB HBM3 at 700 W: 81 multiplies and 778 squarings a lane
    (50,890 wide products) bound it at 0.050 ms per 8192 lanes;
    chip_smoke.py measured 0.44 ms."""
    dev = pk.device
    b = pk.shape[-1]
    for n, t in (("pk", pk), ("gamma", gamma), ("s", s), ("alpha", alpha)):
        _check(f"vrf_prep.{n}", t, (32, b), dev)
    if _route(dev) == "plain":
        ok, h, y, g = pv.vrf_core_prep(pk, gamma, s, alpha)
        prep = torch.cat([pc.stack(h), pc.stack(y), pc.stack(g)])
        return ok.to(torch.int32)[None], prep.to(torch.int32)
    from . import build

    out = _vrf_prep_launch(build.kernel_lib("vrf_prep"), _stream(dev), pk,
                           gamma, s, alpha)
    LAUNCHES["vrf_prep"] += 1
    return out


def _vrf_bc_prep_launch(fn, stream, pk, gamma, u, v, s, alpha):
    b = pk.shape[-1]
    dev = pk.device
    ok = torch.empty((1, b), dtype=torch.int32, device=dev)
    c16 = torch.empty((16, b), dtype=torch.int32, device=dev)
    prep = torch.empty((120, b), dtype=torch.int32, device=dev)
    rc = fn(b, _p(pk), _p(gamma), _p(u), _p(v), _p(s), _p(alpha), _p(ok),
            _p(c16), _p(prep), stream)
    _raise_on(rc, "vrf_bc_prep")
    return ok, c16, prep


def vrf_bc_prep(pk, gamma, u, v, s, alpha):
    """Batch-compatible ECVRF stage A. All inputs [32, B] ->
    (ok [1, B], c16 [16, B], H ‖ Y ‖ Γ [120, B]).

    Replaces ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_bc_prep_kernel
    (csrc/vrf_bc_prep.cu). Operations-bound: three exponentiation chains
    (two decompressions, the single-chain Elligator2), one inversion to
    compress H, and three SHA-512 compressions; no ladders.
    On an H100 80GB HBM3 at 700 W: 94 multiplies and 1,032 squarings a lane
    (66,160 wide products) bound it at 0.065 ms per 8192 lanes;
    chip_smoke.py measured 0.64 ms."""
    dev = pk.device
    b = pk.shape[-1]
    for n, t in (("pk", pk), ("gamma", gamma), ("u", u), ("v", v),
                 ("s", s), ("alpha", alpha)):
        _check(f"vrf_bc_prep.{n}", t, (32, b), dev)
    if _route(dev) == "plain":
        ok, c16, h, y, g = pv.vrf_core_bc_prep(pk, gamma, u, v, s, alpha)
        prep = torch.cat([pc.stack(h), pc.stack(y), pc.stack(g)])
        return ok.to(torch.int32)[None], c16.to(torch.int32), prep.to(torch.int32)
    from . import build

    out = _vrf_bc_prep_launch(build.kernel_lib("vrf_bc_prep"), _stream(dev),
                              pk, gamma, u, v, s, alpha)
    LAUNCHES["vrf_bc_prep"] += 1
    return out


def _vrf_ladders_launch(fn, stream, c16, s, prep):
    b = c16.shape[-1]
    pts = torch.empty((200, b), dtype=torch.int32, device=c16.device)
    rc = fn(b, _p(_base8(c16.device)), _p(c16), _p(s), _p(prep), _p(pts), stream)
    _raise_on(rc, "vrf_ladders")
    return pts


def vrf_ladders(c16, s, prep):
    """ECVRF stage B, shared by both proof formats: c16 [16, B], s [32, B],
    prep [120, B] -> H ‖ Γ ‖ U' ‖ V' ‖ 8Γ [200, B].

    Replaces ouroboros_consensus_tpu/ops/pk/kernels.py:_vrf_ladder_kernel
    (csrc/vrf_ladders.cu). Operations-bound: a fixed-base walk, a
    32-window ladder and a 64-window double ladder (two local tables).
    On an H100 80GB HBM3 at 700 W: 3,375 multiplies and 1,548 squarings a
    lane (422,640 wide products) bound it at 0.41 ms per 8192 lanes;
    chip_smoke.py measured 3.38 ms."""
    dev = c16.device
    b = c16.shape[-1]
    _check("vrf_ladders.c16", c16, (16, b), dev)
    _check("vrf_ladders.s", s, (32, b), dev)
    _check("vrf_ladders.prep", prep, (120, b), dev)
    if _route(dev) == "plain":
        h, y, g = (pc.unstack(prep[40 * i: 40 * (i + 1)].to(torch.int64))
                   for i in range(3))
        pts = pv.vrf_core_ladders(c16, s, h, y, g)
        return torch.cat([pc.stack(p) for p in pts]).to(torch.int32)
    from . import build

    out = _vrf_ladders_launch(build.kernel_lib("vrf_ladders"), _stream(dev),
                              c16, s, prep)
    LAUNCHES["vrf_ladders"] += 1
    return out


def vrf_points(pk, gamma, c, s, alpha):
    """Draft-03 prep chained into the ladders on the proof's challenge c
    [16, B] -> (ok [1, B], points [200, B])."""
    ok, prep = vrf_prep(pk, gamma, s, alpha)
    return ok, vrf_ladders(c, s, prep)


def vrf_points_bc(pk, gamma, u, v, s, alpha):
    """Prep (derived challenge) chained into the ladders ->
    (ok [1, B], c16 [16, B], points [200, B])."""
    ok, c16, prep = vrf_bc_prep(pk, gamma, u, v, s, alpha)
    return ok, c16, vrf_ladders(c16, s, prep)


# ---------------------------------------------------------------------------
# finish
# ---------------------------------------------------------------------------


def _finish_launch(fn, stream, *args):
    b = args[8].shape[-1]
    dev = args[8].device
    out = torch.empty((5, b), dtype=torch.int32, device=dev)
    eta = torch.empty((32, b), dtype=torch.int32, device=dev)
    lv = torch.empty((32, b), dtype=torch.int32, device=dev)
    rc = fn(b, *(_p(a) for a in args), _p(out), _p(eta), _p(lv), stream)
    _raise_on(rc, "finish")
    return out, eta, lv


def finish(ed_ok, ed_pt, ed_r, kes_ok, kes_pt, kes_r, vrf_ok, vrf_pts,
           c, beta_decl, thr_lo, thr_hi):
    """-> (verdicts [5, B]: ok_ocert_sig, ok_kes_sig, ok_vrf, ok_leader,
    leader_ambiguous; eta [32, B]; leader value [32, B]).

    Replaces ouroboros_consensus_tpu/ops/pk/kernels.py:_finish_kernel
    (csrc/finish.cu). Operations-bound: one inversion shared by the seven
    compressions (Montgomery's trick), three SHA-512 and three Blake2b
    compressions.
    On an H100 80GB HBM3 at 700 W: 43 multiplies and 254 squarings a lane
    (18,270 wide products) bound it at 0.018 ms per 8192 lanes;
    chip_smoke.py measured 0.25 ms."""
    dev = c.device
    b = c.shape[-1]
    args = (ed_ok, ed_pt, ed_r, kes_ok, kes_pt, kes_r, vrf_ok, vrf_pts, c,
            beta_decl, thr_lo, thr_hi)
    rows = (1, 40, 32, 1, 40, 32, 1, 200, 16, 64, 32, 32)
    names = ("ed_ok", "ed_pt", "ed_r", "kes_ok", "kes_pt", "kes_r",
             "vrf_ok", "vrf_pts", "c", "beta_decl", "thr_lo", "thr_hi")
    for n, t, r in zip(names, args, rows):
        _check(f"finish.{n}", t, (r, b), dev)
    if _route(dev) == "plain":
        pts = [pc.unstack(vrf_pts[40 * i: 40 * (i + 1)].to(torch.int64))
               for i in range(5)]
        flags, eta, lv = pv.finish_core(
            ed_ok[0] != 0, pc.unstack(ed_pt.to(torch.int64)), ed_r,
            kes_ok[0] != 0, pc.unstack(kes_pt.to(torch.int64)), kes_r,
            vrf_ok[0] != 0, pts, c, beta_decl, thr_lo, thr_hi,
        )
        return flags.to(torch.int32), eta.to(torch.int32), lv.to(torch.int32)
    from . import build

    out = _finish_launch(build.kernel_lib("finish"), _stream(dev), *args)
    LAUNCHES["finish"] += 1
    return out


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def _limb_first(cols):
    """Batch-first staged columns ([B, n] bytes, [B, NB, 128] blocks,
    [B] ints, [B, depth, 32] siblings) -> limb-first int32 arrays, in
    the same order: the 13 ed / kes columns, then the VRF, beta and
    threshold byte columns."""

    def t(a):
        return a.to(torch.int32).T.contiguous()

    def row(a):
        return a.to(torch.int32).reshape(1, -1).contiguous()

    def blocks(a):
        return a.to(torch.int32).permute(1, 2, 0).contiguous()

    (ed_pk, ed_r, ed_s, ed_hblocks, ed_hnblocks, kes_vk, kes_period, kes_r,
     kes_s, kes_vk_leaf, kes_siblings, kes_hblocks, kes_hnblocks) = cols[:13]
    return (
        t(ed_pk), t(ed_r), t(ed_s), blocks(ed_hblocks), row(ed_hnblocks),
        t(kes_vk), row(kes_period), t(kes_r), t(kes_s), t(kes_vk_leaf),
        blocks(kes_siblings), blocks(kes_hblocks), row(kes_hnblocks),
        *(t(a) for a in cols[13:]),
    )


def staged_to_limb_first(*cols):
    """The 21 draft-03 staged columns (ed, kes, then vrf_pk, gamma, c,
    s, alpha, beta, thr_lo, thr_hi) -> the 21 limb-first arrays
    verify_praos_tiles takes."""
    if len(cols) != 21:
        raise ValueError(f"expected 21 draft-03 columns, got {len(cols)}")
    return _limb_first(cols)


def staged_to_limb_first_bc(*cols):
    """The 22 batch-compatible staged columns (the announced U, V in
    place of the challenge c) -> the 22 limb-first arrays
    verify_praos_tiles_bc takes."""
    if len(cols) != 22:
        raise ValueError(f"expected 22 batch-compatible columns, got {len(cols)}")
    return _limb_first(cols)


def verify_praos_tiles(
    ed_pk, ed_r, ed_s, ed_hb, ed_hnb,
    kes_vk, kes_per, kes_r, kes_s, kes_leaf, kes_sib, kes_hb, kes_hnb,
    vrf_pk, vrf_g, vrf_c, vrf_s, vrf_al,
    beta, tlo, thi, *, kes_depth: int,
):
    """The five draft-03 stages (ed, kes, vrf_prep, vrf_ladders, finish)
    over limb-first columns -> (verdicts [5, B], eta [32, B], leader
    value [32, B])."""
    ed_ok, ed_pt = ed_points(ed_pk, ed_s, ed_hb, ed_hnb)
    kes_ok, kes_pt = kes_points(kes_vk, kes_per, kes_s, kes_leaf, kes_sib,
                                kes_hb, kes_hnb, kes_depth)
    vrf_ok, vrf_pts = vrf_points(vrf_pk, vrf_g, vrf_c, vrf_s, vrf_al)
    return finish(ed_ok, ed_pt, ed_r, kes_ok, kes_pt, kes_r, vrf_ok, vrf_pts,
                  vrf_c, beta, tlo, thi)


def verify_praos_tiles_bc(
    ed_pk, ed_r, ed_s, ed_hb, ed_hnb,
    kes_vk, kes_per, kes_r, kes_s, kes_leaf, kes_sib, kes_hb, kes_hnb,
    vrf_pk, vrf_g, vrf_u, vrf_v, vrf_s, vrf_al,
    beta, tlo, thi, *, kes_depth: int,
):
    """The five batch-compatible stages (ed, kes, vrf_bc_prep,
    vrf_ladders, finish) over limb-first columns -> (verdicts [5, B],
    eta [32, B], leader value [32, B])."""
    ed_ok, ed_pt = ed_points(ed_pk, ed_s, ed_hb, ed_hnb)
    kes_ok, kes_pt = kes_points(kes_vk, kes_per, kes_s, kes_leaf, kes_sib,
                                kes_hb, kes_hnb, kes_depth)
    vrf_ok, c16, vrf_pts = vrf_points_bc(vrf_pk, vrf_g, vrf_u, vrf_v, vrf_s,
                                         vrf_al)
    return finish(ed_ok, ed_pt, ed_r, kes_ok, kes_pt, kes_r, vrf_ok, vrf_pts,
                  c16, beta, tlo, thi)


def verify_praos_packed_split(layout, packed, n_real: int, device):
    """The packed per-lane dispatch: unpack the packed wire columns on
    `device`, relayout, run the five stage kernels of the layout's proof
    format (vrf_prep for 80-byte draft-03 proofs, vrf_bc_prep for 128-byte
    batch-compatible ones), then the verdict reduction with the nonce fold
    left to the host (scan off).
    -> ((masks [5, W] uint32, eta_u8 [B, 32] uint8), flags, eta, lv),
    the per-lane arrays left on `device`."""
    from ...protocol import batch as pbatch

    staged = pbatch.unpack_packed(layout, packed, device)
    if layout.vrf_proof_len == 128:
        limb = staged_to_limb_first_bc(*staged)
        flags, eta, lv = verify_praos_tiles_bc(*limb, kes_depth=layout.kes_depth)
    else:
        limb = staged_to_limb_first(*staged)
        flags, eta, lv = verify_praos_tiles(*limb, kes_depth=layout.kes_depth)
    red = pbatch.verdict_reduce(flags, eta.T, n_real)
    return red, flags, eta, lv
