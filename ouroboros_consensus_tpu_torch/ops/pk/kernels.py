"""The Praos kernels of a packed window: wrappers, launch counts, plain
twins. `unpack` writes the stage kernels' limb-first columns from the
packed wire, the six stage kernels verify, `nonce_fold` folds the
window's nonces from the VRF outputs on a side stream beside them (at the
end of this module).

Each stage of ops/pk/verify.py is one hand-written CUDA kernel
(csrc/<name>.cu, grid sized to the lanes), bound with ctypes (build.py).
Each runs 32 lanes a block, ed and kes over four warps, vrf_prep,
vrf_bc_prep and finish three, vrf_ladders eight: first each warp one
independent part of the lanes' work (hashes, tables, s·B,
decompressions, compressions), meeting in shared memory,
then in ed, kes and vrf_ladders each long ladder on a quad of four warps,
one product of every point operation a warp (csrc/stages.cuh,
csrc/pk.cuh). A wrapper checks device,
dtype, shape and contiguity, allocates its outputs with torch.empty,
launches on the current stream without synchronising, raises when the
launcher's cudaGetLastError() is not 0, and adds one to LAUNCHES[name].
For CPU tensors it runs the plain PyTorch twin instead (verify.py — the
same integer operations in the same order); any other device raises.
There is no fallback between the two. Each stage wrapper is a chaos
seam (``stage-call``, testing/chaos.py: device-error@stage:<name>).

Layout is the JAX package's: limb-first int32 [rows, B] with lanes last;
byte rows hold 0..255; ok rows are [1, B]. Inputs and the final outputs
(ok rows, c16, verdicts, eta, lv) have exactly the JAX layout and dtype.
The inter-stage point columns are the port's radix: a point is [40, B]
(X ‖ Y ‖ Z ‖ T, 10 limbs of 2^25.5 each), the VRF prep output is
H ‖ Y ‖ Γ [120, B] and the ladder output H ‖ Γ ‖ U' ‖ V' ‖ 8Γ [200, B]
(the TPU stages used 20 x 13-bit limbs: [80, B] per point).

Bound on the card: every stage is bound by operations — 32x32->64
integer products in the field work (100 per multiply, 55 per squaring:
the kernels square with ref10's fe_sq) — not by bytes (a lane moves
under 2.5 KB through device memory); on the main path, where half the
launches are one block, by the dependent chain of one lane. The design
answers: the radix (10 limbs of 25.5 bits turn the TPU's 400 13-bit
products per multiply into 100 native IMAD.WIDE products, and the loose
limb form keeps carries to two parallel passes); signed-digit w4
ladders over 8-entry cached tables, doublings that skip T; and for ed,
kes and vrf_ladders the lane split over warps, which takes everything
but the one 256-doubling chain off that chain's path and spreads each
of its point operations over four warps; for the two preps the split
that leaves one warp's exponentiations on the path (vrf_bc_prep two of
four, vrf_prep one of three), and for finish the one that compresses
four of its seven points on the path's warp and the other three, with
the Blake2b work and β's SHA-512, on two more. A bound below is the
wide products over 132 SMs x 32 per clock (64 32-bit IMADs, two per
64-bit product) at 1,980 MHz. PERF.md keeps each kernel's measured time
beside its bound (scripts of record: chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import math
import time

import torch

from ...obs import resources
from ...obs.warmup import WARMUP
from ...protocol import nonces as pn
from ...testing import chaos
from . import curve as pc
from . import prove as pp
from . import verify as pv

# kernel -> launches on the card (the plain twins do not count): a kernel
# source's, or for csrc/forge.cu each of its two kernels'; the two tool
# kernels (tools/debug_pk.py, tools/fe_bench.py), the window aggregate's
# three (ops/pk/aggregate.py, msm.py) and the batched Ed25519 verify
# (ops/ed25519_batch.py) count here too
LAUNCHES = {"ed": 0, "kes": 0, "vrf_prep": 0, "vrf_bc_prep": 0,
            "vrf_ladders": 0, "finish": 0, "unpack": 0, "nonce_fold": 0,
            "primitives": 0, "fe_bench": 0, "agg_prep": 0, "dedupe": 0, "msm": 0,
            "forge_sweep": 0, "ed_sign": 0, "ed_verify": 0}

_BASE8: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(name: str, t0: float, args, outs, capture: bool = True) -> None:
    """Each wrapper calls it right after its kernel's launch (`t0`:
    monotonic before the launch call, `args` / `outs` the launch's
    tensors): one more in LAUNCHES[name]; a kernel's first launch in the
    process goes into the warmup report (the host wall of the call, the
    module's load on the card included), and its figures into the
    resources report once (obs/resources.py; `capture` False leaves that
    to a later launch of the name). Two lookups a launch after that;
    never a synchronisation."""
    LAUNCHES[name] += 1
    if name not in WARMUP.stages:
        WARMUP.note_stage(name, time.monotonic() - t0)
    if capture and not resources.RESOURCES.tried(name):
        resources.capture_kernel(name, args, outs)


def _base8(device: torch.device) -> torch.Tensor:
    """The fixed-base table on `device`: [32 * 256 * 40] int32 limbs."""
    key = str(device)
    if key not in _BASE8:
        _BASE8[key] = pc.base8().to(torch.int32).reshape(-1).contiguous().to(device)
    return _BASE8[key]


def _check(name: str, t: torch.Tensor, shape: tuple, device,
           dtype=torch.int32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
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
    # the current stream's handle, as current_stream(device).cuda_stream
    # gives it, without building a Stream object (≈ 10 µs a call)
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if device.index is None else device.index)


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
    a 65-digit signed variable-base ladder.
    One lane runs over four warps, kes's design without the Merkle walk
    (csrc/ed.cu): the hash, the key's decompression and table, and s·B
    beside each other, then the h·(−A) ladder on all four, one product of
    each point operation a warp.
    On an H100 80GB HBM3 at 700 W: 1,670 multiplies and 1,279 squarings a
    lane (237,345 wide products) bound it at 0.23 ms per 8192 lanes
    (PERF.md has chip_smoke.py's times)."""
    chaos.fire("stage-call", stage="ed")  # device-error@stage:ed
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

    fn = build.kernel_lib("ed")
    t0 = time.monotonic()
    out = _ed_launch(fn, _stream(dev), pk, s, hblocks, hnblocks)
    _launched("ed", t0, (pk, s, hblocks, hnblocks), out)
    return out


def _ed_verify_launch(fn, stream, pk, r, s, hblocks, hnblocks):
    b, nb = pk.shape[-1], hblocks.shape[0]
    ok = torch.empty((1, b), dtype=torch.int32, device=pk.device)
    rc = fn(b, _p(_base8(pk.device)), _p(pk), _p(r), _p(s), _p(hblocks), nb,
            _p(hnblocks), _p(ok), stream)
    _raise_on(rc, "ed_verify")
    return ok


def ed_verify_plain(pk, r, s, hblocks, hnblocks):
    """ed_verify's plain twin: verify.ed_core, P's compression
    (curve.compress_many) and the byte compare with R."""
    ok_pre, p = pv.ed_core(pk, s, hblocks, hnblocks[0])
    (enc,) = pc.compress_many([p])
    eq = (enc.to(torch.int64) == r.to(torch.int64)).all(dim=0)
    return (ok_pre & eq).to(torch.int32)[None]


def ed_verify(pk, r, s, hblocks, hnblocks):
    """Standalone RFC 8032 cofactorless Ed25519 verify, one verdict a lane.
    pk, r, s [32, B]; hblocks [NB, 128, B] (the padded R ‖ A ‖ M);
    hnblocks [1, B], each lane's own block count -> ok [1, B] int32.

    Replaces the plain-XLA verify of ouroboros_consensus_tpu/ops/
    ed25519_batch.py:71-103 (csrc/ed_verify.cu): 32 lanes a block on four
    warps; the hash, A's and R's decompressions and a part of s·B beside
    each other, then on a quad the table of −A, the h·(−A) chain, the rest
    of s·B and a projective compare of P with the decompressed R (no
    inversion after the chain; the twin compresses P and compares bytes,
    which gives the same verdicts). Operations-bound: ed's field work and
    R's decompression a lane. A lane hashes block 0 and each later block
    below its count, in the kernel and the twin alike, so no count reads
    past the NB blocks; ed25519_batch.limb_columns checks the counts on the
    host, where no wait for the card is needed."""
    dev = pk.device
    b, nb = pk.shape[-1], hblocks.shape[0]
    for n, t, sh in (("pk", pk, (32, b)), ("r", r, (32, b)), ("s", s, (32, b)),
                     ("hblocks", hblocks, (nb, 128, b)),
                     ("hnblocks", hnblocks, (1, b))):
        _check(f"ed_verify.{n}", t, sh, dev)
    if b == 0:
        _route(dev)
        return torch.empty((1, 0), dtype=torch.int32, device=dev)
    if _route(dev) == "plain":
        return ed_verify_plain(pk, r, s, hblocks, hnblocks)
    from . import build

    fn = build.kernel_lib("ed_verify")
    t0 = time.monotonic()
    out = _ed_verify_launch(fn, _stream(dev), pk, r, s, hblocks, hnblocks)
    _launched("ed_verify", t0, (pk, r, s, hblocks, hnblocks), out)
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
    One lane runs over four warps (csrc/kes.cu): the hashes, the leaf key's
    decompression and table, s·B and the Merkle walk beside each other,
    then the h·(−A) ladder on all four, one product of each point
    operation a warp.
    On an H100 80GB HBM3 at 700 W: the ed stage's 237,345 wide products a
    lane bound it at 0.23 ms per 8192 lanes; chip_smoke.py measured 1.03 ms."""
    chaos.fire("stage-call", stage="kes")  # device-error@stage:kes
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

    fn = build.kernel_lib("kes")
    t0 = time.monotonic()
    out = _kes_launch(fn, _stream(dev), vk, period, s, vk_leaf, siblings, hblocks, hnblocks,
                      depth)
    _launched("kes", t0, (vk, period, s, vk_leaf, siblings, hblocks, hnblocks), out)
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
    One lane runs over three warps (csrc/vrf_prep.cu, vrf_bc_prep's Y and
    Γ roles): the hash and H's exponentiation on one, the decompressions
    of Y and Γ on the others, so one of the three exponentiations lies on
    the path.
    On an H100 80GB HBM3 at 700 W: 79 multiplies and 778 squarings a lane
    (50,690 wide products) bound it at 0.050 ms per 8192 lanes;
    chip_smoke.py measured 0.14 ms at 8 lanes and 0.18 ms at 8192."""
    chaos.fire("stage-call", stage="vrf_prep")  # device-error@stage:vrf_prep
    dev = pk.device
    b = pk.shape[-1]
    for n, t in (("pk", pk), ("gamma", gamma), ("s", s), ("alpha", alpha)):
        _check(f"vrf_prep.{n}", t, (32, b), dev)
    if _route(dev) == "plain":
        ok, h, y, g = pv.vrf_core_prep(pk, gamma, s, alpha)
        prep = torch.cat([pc.stack(h), pc.stack(y), pc.stack(g)])
        return ok.to(torch.int32)[None], prep.to(torch.int32)
    from . import build

    fn = build.kernel_lib("vrf_prep")
    t0 = time.monotonic()
    out = _vrf_prep_launch(fn, _stream(dev), pk, gamma, s, alpha)
    _launched("vrf_prep", t0, (pk, gamma, s, alpha), out)
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
    One lane runs over three warps (csrc/vrf_bc_prep.cu): H, its
    compression and the challenge on one, the decompressions of Y and Γ
    on the others, so two of the four exponentiations lie on the path.
    On an H100 80GB HBM3 at 700 W: 92 multiplies and 1,032 squarings a lane
    (65,960 wide products) bound it at 0.065 ms per 8192 lanes
    (PERF.md has chip_smoke.py's times)."""
    chaos.fire("stage-call", stage="vrf_bc_prep")  # device-error@stage:vrf_bc_prep
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

    fn = build.kernel_lib("vrf_bc_prep")
    t0 = time.monotonic()
    out = _vrf_bc_prep_launch(fn, _stream(dev), pk, gamma, u, v, s, alpha)
    _launched("vrf_bc_prep", t0, (pk, gamma, u, v, s, alpha), out)
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
    33-digit signed ladder and a 65-digit double ladder (three tables in
    shared memory).
    One lane runs over eight warps (csrc/vrf_ladders.cu): the tables, 8Γ
    and s·B beside each other, then V' and U' each on a quad of four
    warps, one product of each point operation a warp.
    On an H100 80GB HBM3 at 700 W: 2,699 multiplies and 1,548 squarings a
    lane (355,040 wide products) bound it at 0.35 ms per 8192 lanes;
    chip_smoke.py measured 1.59 ms."""
    chaos.fire("stage-call", stage="vrf_ladders")  # device-error@stage:vrf_ladders
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

    fn = build.kernel_lib("vrf_ladders")
    t0 = time.monotonic()
    out = _vrf_ladders_launch(fn, _stream(dev), c16, s, prep)
    _launched("vrf_ladders", t0, (c16, s, prep), out)
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
    One lane runs over three warps (csrc/finish.cu), each compressing its
    own points on an inversion of its own: H, Γ, U', V' and the challenge
    hash on one, 8Γ and β's hash on another, the ed and KES points and
    the Blake2b work on the third.
    On an H100 80GB HBM3 at 700 W: the twin's 43 multiplies and 254
    squarings a lane (18,270 wide products, one inversion) bound it at
    0.018 ms per 8192 lanes; chip_smoke.py measured 0.12 ms at 8 lanes
    and 0.17 ms at 8192."""
    chaos.fire("stage-call", stage="finish")  # device-error@stage:finish
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

    fn = build.kernel_lib("finish")
    t0 = time.monotonic()
    out = _finish_launch(fn, _stream(dev), *args)
    _launched("finish", t0, args, out)
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


def _tiles(limb, bc: bool, kes_depth: int):
    tiles = verify_praos_tiles_bc if bc else verify_praos_tiles
    return tiles(*limb, kes_depth=kes_depth)


def verify_staged(cols, bc: bool, kes_depth: int, n_real: int):
    """The five stage kernels of one proof format over batch-first staged
    columns on the card (22 batch-compatible columns with `bc`, else 21
    draft-03 ones), then the verdict reduction with the nonce fold left to
    the host (no fold).
    -> ((masks [5, W] int64, eta_u8 [n_real, 32] uint8), flags, eta, lv),
    the per-lane arrays left on the columns' device."""
    from ...protocol import batch as pbatch

    limb = (staged_to_limb_first_bc if bc else staged_to_limb_first)(*cols)
    flags, eta, lv = _tiles(limb, bc, kes_depth)
    return pbatch.verdict_reduce(flags, eta, n_real), flags, eta, lv


def verify_praos_packed_split(layout, packed, n_real: int, device, carry):
    """The packed per-lane dispatch on `device`: the packed columns up
    (`upload_packed`), the `unpack` kernel, then the `nonce_fold` kernel
    from `carry` ([66] uint8 on `device`) over unpack's beta rows on a
    side stream (nonce_fold_beside), beside the five stage kernels of the
    layout's proof format (vrf_prep for 80-byte draft-03 proofs,
    vrf_bc_prep for 128-byte batch-compatible ones) and the verdict words
    on the current stream, which then waits for the fold.
    -> ((masks [5, W] int64, carry-out [66] uint8), flags, eta, lv), all on
    `device`."""
    from ...protocol import batch as pbatch

    limb, fold = _unpack_and_fold(layout, packed, n_real, device, carry)
    flags, eta, lv = _tiles(limb, layout.vrf_proof_len == 128, layout.kes_depth)
    return pbatch.verdict_reduce(flags, eta, n_real, fold), flags, eta, lv


def _unpack_and_fold(layout, packed, n_real: int, device, carry):
    """The packed columns up, `unpack`, and the fold launched beside what
    comes next -> (the limb-first columns, the fold's (carry-out, done))."""
    from ...protocol import batch as pbatch

    cols = pbatch.upload_packed(packed, device)
    limb = unpack_limb_first(layout, cols, device)
    return limb, nonce_fold_beside(limb[UNPACK_BETA], cols.within, n_real, carry)


def verify_praos_packed_agg(layout, packed, n_real: int, device, carry):
    """The aggregated dispatch of a batch-compatible packed window on
    `device`: as verify_praos_packed_split up to the fold, then the window
    aggregate (aggregate.aggregate_window: agg_prep, the dedupe with its
    mod-L reductions, msm) in place of the five stage kernels, and the verdict
    words over its flags. -> ((masks, carry-out), AggregateVerdicts, the
    limb-first columns, which a dirty window's per-lane re-dispatch
    reads)."""
    from ...protocol import batch as pbatch
    from . import aggregate as pa

    limb, fold = _unpack_and_fold(layout, packed, n_real, device, carry)
    av = pa.aggregate_window(*limb, kes_depth=layout.kes_depth)
    return pbatch.verdict_reduce(av.flags, av.eta, n_real, fold), av, limb


# ---------------------------------------------------------------------------
# unpack: the packed wire -> the stage kernels' limb-first columns
# ---------------------------------------------------------------------------

ED_MSG_BYTES = 112  # R ‖ issuer ‖ vk_hot ‖ counter_be8 ‖ c0_be8
UNPACK_BETA = -3  # the beta rows' place among unpack's arrays


def sha512_blocks_of(n: int) -> int:
    """SHA-512 blocks of an n-byte message (0x80 and the 16-byte length)."""
    return (n + 17 + 127) // 128


def unpack_segments(layout) -> tuple:
    """The rows of the `unpack` kernel's one int32 output [R, B], segment
    by segment (as csrc/wire.cuh's wire_rows orders them) -> ((name,
    shape without B), ...); the limb-first arrays are views of
    consecutive rows."""
    return (
        ("issuer", (32,)), ("sigma", (64,)),
        ("ed_hb", (sha512_blocks_of(ED_MSG_BYTES), 128)), ("ed_hnb", (1,)),
        ("vk_hot", (32,)), ("period", (1,)), ("kes_rs", (64,)),
        ("tail", (32 + 32 * layout.kes_depth,)),
        ("kes_hb", (sha512_blocks_of(64 + layout.body_len), 128)), ("kes_hnb", (1,)),
        ("vrf_vk", (32,)), ("proof", (layout.vrf_proof_len,)), ("alpha", (32,)),
        ("beta", (64,)), ("thr", (64,)),
    )


def _unpack_views(layout, out: torch.Tensor) -> tuple:
    """The [R, B] buffer -> the 22 (bc) or 21 (draft-03) limb-first
    arrays of staged_to_limb_first(_bc), as views."""
    b = out.shape[-1]
    seg, r = {}, 0
    for name, shape in unpack_segments(layout):
        n = math.prod(shape)
        seg[name] = out[r: r + n].view(*shape, b)
        r += n
    d = layout.kes_depth

    def rows(name, lo, hi):
        return seg[name][lo:hi]

    splits = (0, 32, 64, 96, 128) if layout.vrf_proof_len == 128 else (0, 32, 48, 80)
    proof = [rows("proof", lo, hi) for lo, hi in zip(splits, splits[1:])]
    return (
        seg["issuer"], rows("sigma", 0, 32), rows("sigma", 32, 64), seg["ed_hb"],
        seg["ed_hnb"], seg["vk_hot"], seg["period"], rows("kes_rs", 0, 32),
        rows("kes_rs", 32, 64), rows("tail", 0, 32),
        rows("tail", 32, 32 + 32 * d).view(d, 32, b), seg["kes_hb"], seg["kes_hnb"],
        seg["vrf_vk"], *proof, seg["alpha"], seg["beta"], rows("thr", 0, 32),
        rows("thr", 32, 64),
    )


def _layout_ints(layout):
    """PackedLayout as csrc/wire.cuh's WireLayout (11 ints)."""
    vals = (layout.body_len, layout.o_issuer, layout.o_vrf_vk, layout.o_vrf_out,
            layout.o_vrf_proof, layout.o_vk_hot, layout.o_sigma, layout.kes_depth,
            layout.slots_per_kes, int(layout.has_nonce), layout.vrf_proof_len)
    return (ctypes.c_int * len(vals))(*vals)


def _unpack_launch(fn, stream, layout, cols):
    b = cols.body.shape[0]
    rows = sum(math.prod(shape) for _n, shape in unpack_segments(layout))
    out = torch.empty((rows, b), dtype=torch.int32, device=cols.body.device)
    rc = fn(b, _layout_ints(layout), *(_p(c) for c in cols[:10]), _p(out), stream)
    _raise_on(rc, "unpack")
    return _unpack_views(layout, out)


def unpack_limb_first(layout, cols, device):
    """The packed window's columns as tensors on `device` (a batch.Packed
    from batch.upload_packed) -> the limb-first int32 arrays the five
    stage kernels read: the 22 of staged_to_limb_first_bc for a 128-byte
    proof, the 21 of staged_to_limb_first for an 80-byte one, in their
    order.

    Replaces the plain-XLA `unpack_packed` + `staged_to_limb_first(_bc)`
    of ouroboros_consensus_tpu/protocol/batch.py:1221 and
    ops/pk/kernels.py:344, :371 (the unpack stage `_mk_packed_unpack`,
    kernels.py:578), in one launch (csrc/unpack.cu): field slices of the
    body, the KES tail and threshold gathers, the OCert and KES SHA-512
    messages padded into blocks, the VRF alpha (one Blake2b a lane) and
    the KES evolution. Plain version: batch.unpack_packed, then
    _limb_first.
    Bound: bytes (a lane reads its body and table rows and writes R int32
    rows). A block stages a tile of 32 lanes' sources in shared memory
    (bodies, KES signatures, table rows, transposed; the alphas hashed on
    a warp of its own), then writes a group of the rows, 4 lanes a
    16-byte store, so reads and writes both coalesce; a small window's
    rows are cut into groups so that it still spreads over the SMs."""
    from ...protocol import batch as pbatch

    if not all(isinstance(c, torch.Tensor) for c in cols):
        raise TypeError("unpack_limb_first: the packed columns must be tensors "
                        "(batch.upload_packed)")
    if cols.body.device.type != torch.device(device).type:
        raise ValueError(f"unpack_limb_first: columns on {cols.body.device}, "
                         f"expected {device}")
    device = cols.body.device  # the index too: cuda -> cuda:0
    b = cols.body.shape[0]
    for n, t, sh, dt in (
            ("body", cols.body, (b, layout.body_len), torch.uint8),
            ("kes_rs", cols.kes_rs, (b, 64), torch.uint8),
            ("kes_tail_idx", cols.kes_tail_idx, (b,), torch.int32),
            ("kes_tail_tab", cols.kes_tail_tab,
             (cols.kes_tail_tab.shape[0], 32 + 32 * layout.kes_depth), torch.uint8),
            ("slot", cols.slot, (b,), torch.int32),
            ("counter", cols.counter, (b,), torch.int32),
            ("c0", cols.c0, (b,), torch.int32),
            ("thr_idx", cols.thr_idx, (b,), torch.int32),
            ("thr_tab", cols.thr_tab, (cols.thr_tab.shape[0], 64), torch.uint8),
            ("nonce", cols.nonce, (32,), torch.uint8)):
        _check(f"unpack_limb_first.{n}", t, sh, device, dt)
    if _route(device) == "plain":
        return _limb_first(pbatch.unpack_packed(layout, cols, device))
    from . import build

    fn = build.kernel_lib("unpack")
    t0 = time.monotonic()
    out = _unpack_launch(fn, _stream(device), layout, cols)
    _launched("unpack", t0, cols, out)
    return out


# ---------------------------------------------------------------------------
# nonce_fold: the window's sequential nonce fold
# ---------------------------------------------------------------------------

# The instructions on a Blake2b-256 compression's critical path. A G is
# four 64-bit three- or two-operand additions (two 32-bit instructions
# each), four 64-bit xors (two each) and three 64-bit rotations by 24, 16
# and 63 (two funnel shifts each; by 32 is a swap of halves): 22. A
# round's eight G are four independent columns, then four independent
# diagonals, so its chain is two G deep whatever the design: twelve
# rounds, then the output word (two 64-bit xors). The function's cost,
# not a kernel's: csrc/nonce_fold.cu's four-lane chain issues 753 SASS
# instructions a compression, its shuffles included (chip_smoke.b2b_bench).
B2B_CHAIN_INSTRUCTIONS = 12 * 2 * 22 + 2 * 2


def nonce_fold_bound_ms(n_real: int) -> float:
    """The least time of one fold: n_real dependent compressions (each
    hashes the nonce the one before produced), each a chain of
    B2B_CHAIN_INSTRUCTIONS issued at one a cycle at the card's maximum SM
    clock. The etas' own two compressions a lane are independent across
    lanes and are not counted."""
    from ...device import max_sm_clock_hz

    return n_real * B2B_CHAIN_INSTRUCTIONS / max_sm_clock_hz() * 1e3


def nonce_fold_plain(beta, within, n_real: int, carry):
    """The fold with the host's hashes over the real lanes, in order:
    eta_i = nonces.vrf_nonce_value(beta_i), evolving <- evolving ⭒ eta_i,
    then candidate <- evolving where within_i. Tensors of any device;
    -> the carry-out [66] uint8 on carry's device."""
    betas = beta[:, :n_real].T.to(torch.uint8).cpu().numpy()
    win = within[:n_real].cpu().numpy()
    evolving, candidate = pn.unpack_carry(carry.cpu().numpy())
    for i in range(n_real):
        evolving = pn.combine(evolving, pn.vrf_nonce_value(betas[i].tobytes()))
        if win[i]:
            candidate = evolving
    return torch.from_numpy(pn.pack_carry(evolving, candidate)).to(carry.device)


def _nonce_fold_launch(fn, stream, beta, within, n_real, carry):
    out = torch.empty((pn.CARRY_BYTES,), dtype=torch.uint8, device=carry.device)
    rc = fn(beta.shape[-1], n_real, _p(beta), _p(within), _p(carry), _p(out), stream)
    _raise_on(rc, "nonce_fold")
    return out


def nonce_fold(beta, within, n_real: int, carry):
    """The window's nonce fold: beta [64, B] int32 (the declared VRF
    outputs' bytes, unpack's `beta` rows), within [B] uint8, the carry-in
    [66] uint8 (protocol/nonces.pack_carry) -> the carry-out after the
    real lanes 0 .. n_real - 1 (bucket padding does not fold): per lane
    eta_i = Blake2b-256(Blake2b-256("N" ‖ beta_i)), evolving <-
    Blake2b-256(evolving ‖ eta_i), or eta_i while it is neutral, and
    candidate <- evolving where within_i. Launches on the current stream
    (nonce_fold_beside puts it on a side stream).

    Replaces the plain-XLA `nonce_fold_scan` in `verdict_reduce` of
    ouroboros_consensus_tpu/ops/blake2b.py:271 and protocol/batch.py:1326
    (the reduce stage `_mk_reduce`, ops/pk/kernels.py:602), which folds
    finish's eta; finish derives that eta from the same beta rows, so the
    carry is the same byte for byte and the fold need not wait for the
    stages. One launch (csrc/nonce_fold.cu). Plain version:
    nonce_fold_plain.
    Bound: operations, and the chain of them: each compression needs the
    one before (B2B_CHAIN_INSTRUCTIONS a compression, nonce_fold_bound_ms).
    One block: warp 0 runs the chain, a compression's four G columns on
    four lanes with shuffles between; three warps on the SM's other
    schedulers derive the etas, a thread a lane, into a ring of
    shared-memory slots guarded by mbarriers."""
    dev = carry.device
    b = beta.shape[-1]
    _check("nonce_fold.beta", beta, (64, b), dev)
    _check("nonce_fold.within", within, (b,), dev, torch.uint8)
    _check("nonce_fold.carry", carry, (pn.CARRY_BYTES,), dev, torch.uint8)
    if not 0 <= n_real <= b:
        raise ValueError(f"nonce_fold: n_real {n_real} outside [0, {b}]")
    if _route(dev) == "plain":
        return nonce_fold_plain(beta, within, n_real, carry)
    from . import build

    fn = build.kernel_lib("nonce_fold")
    t0 = time.monotonic()
    out = _nonce_fold_launch(fn, _stream(dev), beta, within, n_real, carry)
    _launched("nonce_fold", t0, (beta, within, carry), out)
    return out


_SIDE: dict = {}


def _side_stream(device: torch.device):
    """The fold's stream on `device`: one per device, of high priority so
    that its one block is placed before a stage kernel's waiting blocks."""
    key = str(device)
    if key not in _SIDE:
        _SIDE[key] = torch.cuda.Stream(device, priority=-1)
    return _SIDE[key]


def nonce_fold_beside(beta, within, n_real: int, carry):
    """nonce_fold on a side stream, after the work enqueued so far on the
    current stream (an event the side stream waits on), so that what the
    current stream enqueues next (the stage kernels) runs beside it.
    -> (carry-out, done): `done` is the event recorded after the fold on
    the side stream (join_fold), or None on the CPU, where the fold ran at
    once. The inputs are marked as used by the side stream, so the
    caching allocator keeps their memory until the fold is done."""
    if carry.device.type != "cuda":
        return nonce_fold(beta, within, n_real, carry), None
    main = torch.cuda.current_stream(carry.device)
    side = _side_stream(carry.device)
    ready = torch.cuda.Event()
    ready.record(main)
    side.wait_event(ready)
    with torch.cuda.stream(side):
        out = nonce_fold(beta, within, n_real, carry)
        done = torch.cuda.Event()
        done.record(side)
    for t in (beta, within, carry):
        t.record_stream(side)
    return out, done


def join_fold(fold):
    """(carry-out, done) from nonce_fold_beside -> the carry-out, the
    current stream ordered after the fold (it waits on `done`), so that
    what reads the carry next on this stream sees it."""
    out, done = fold
    if done is not None:
        main = torch.cuda.current_stream(out.device)
        main.wait_event(done)
        out.record_stream(main)
    return out


# ---------------------------------------------------------------------------
# the forge: the leader-election sweep and the OCert signer (csrc/forge.cu)
# ---------------------------------------------------------------------------


def _forge_sweep_launch(fn, stream, pools, slot0: int, b: int, nonce):
    out = torch.empty((b, pp.OUT_BYTES), dtype=torch.uint8, device=pools.device)
    rc = fn(b, pools.shape[0], slot0, _p(_base8(pools.device)), _p(pools),
            None if nonce is None else _p(nonce), _p(out), stream)
    _raise_on(rc, "forge_sweep")
    return out


def forge_sweep(pools, slot0: int, b: int, nonce):
    """The leader-election sweep of one election window: pools [P, 160]
    uint8 (prove.pool_table: x ‖ prefix ‖ pk ‖ lo ‖ hi), lanes 0 .. b - 1
    (lane i is pool i % P at slot slot0 + i / P, the pairs slot-major),
    nonce [32] uint8 or None (the neutral nonce) -> [b, 210] uint8 rows
    Γ ‖ c16 ‖ U ‖ V ‖ s ‖ β ‖ win ‖ amb (prove.COLUMNS).

    Replaces the plain-XLA `forge_sweep` of
    ouroboros_consensus_tpu/protocol/forge.py:91 (ops/ecvrf_batch.py:83
    alpha_from_slots, :130 hash_to_curve, :265 prove, and the leader
    bracket), in one launch (csrc/forge.cu); the per-pool columns are
    read by lane % P, not tiled. Plain version: prove.forge_sweep_plain.
    Bound: operations. A lane's field work is two 65-digit ladders, a
    32-add fixed-base walk, one hash to the curve and H's and the finish's
    inversions; 32 lanes a block over four warps as two pairs (one table
    of H in shared memory; x·H and 8Γ on one pair, k·B and k·H on the
    other, two of each point operation's four products a warp), the
    finish's compressions on one inversion a block."""
    dev = pools.device
    _check("forge_sweep.pools", pools, (pools.shape[0], pp.POOL_BYTES), dev, torch.uint8)
    if nonce is not None:
        _check("forge_sweep.nonce", nonce, (32,), dev, torch.uint8)
    if pools.shape[0] < 1 or b < 0:
        raise ValueError(f"forge_sweep: {pools.shape[0]} pools, {b} lanes")
    if not 0 <= slot0 < 1 << 62:
        raise ValueError(f"forge_sweep: slot0 {slot0} out of range")
    if _route(dev) == "plain":
        return pp.forge_sweep_plain(pools, slot0, b, nonce)
    if b == 0:
        return torch.empty((0, pp.OUT_BYTES), dtype=torch.uint8, device=dev)
    from . import build

    fn = build.kernel_lib("forge", "pk_forge_sweep")
    t0 = time.monotonic()
    out = _forge_sweep_launch(fn, _stream(dev), pools, slot0, b, nonce)
    _launched("forge_sweep", t0, (pools, nonce), out)
    return out


def _ed_sign_launch(fn, stream, a, a_enc, rblocks, rnblocks, hblocks, hnblocks):
    """One launch of `fn` (pk_ed_sign of either build) -> (signatures [B,
    64] uint8, bad [ceil(B / 32)] int32: 1 for a block with a block count
    outside 1..NB), both still on the device."""
    b, nb = rblocks.shape[0], rblocks.shape[1]
    out = torch.empty((b, 64), dtype=torch.uint8, device=a.device)
    bad = torch.empty((-(-b // 32),), dtype=torch.int32, device=a.device)
    rc = fn(b, nb, _p(_base8(a.device)), _p(a), _p(a_enc), _p(rblocks), _p(rnblocks),
            _p(hblocks), _p(hnblocks), _p(out), _p(bad), stream)
    _raise_on(rc, "ed_sign")
    return out, bad


def _bad_counts(nb: int, got: str = "") -> ValueError:
    return ValueError(f"ed_sign: a message's SHA-512 block count lies outside 1..{nb}{got}")


def ed_sign(a, a_enc, rblocks, rnblocks, hblocks, hnblocks):
    """Ed25519 signatures of the OCert signables: a, a_enc [B, 32] uint8
    (the clamped secret scalar, the public key); rblocks, hblocks [B, NB,
    128] uint8 and rnblocks, hnblocks [B] int32 (prove.stage_sign_np) ->
    [B, 64] uint8 R ‖ s. A block count outside 1..NB raises ValueError: on
    the card the kernel flags it and this reads the flags after the
    launch (the one wait for the card, which a caller reading the
    signatures pays anyway), so nothing is read back before the launch.

    Replaces the plain-XLA `forge_sign` of
    ouroboros_consensus_tpu/protocol/forge.py:125 (ops/ed25519_batch.py:140
    sign), in one launch (csrc/forge.cu). Plain version: prove.ed_sign_plain.
    Bound: the dependent path (a 32-add fixed-base walk, one inversion,
    two SHA-512 and the mod-L products a signable); 32 signables a block
    on eight warps, R = r·B on eight threads a signable, R's inversion one
    a block."""
    dev = a.device
    b = a.shape[0]
    nb = rblocks.shape[1] if rblocks.dim() == 3 else 0
    for n, t, sh, dt in (("a", a, (b, 32), torch.uint8), ("a_enc", a_enc, (b, 32), torch.uint8),
                         ("rblocks", rblocks, (b, nb, 128), torch.uint8),
                         ("rnblocks", rnblocks, (b,), torch.int32),
                         ("hblocks", hblocks, (b, nb, 128), torch.uint8),
                         ("hnblocks", hnblocks, (b,), torch.int32)):
        _check(f"ed_sign.{n}", t, sh, dev, dt)
    if b and nb < 1:
        raise _bad_counts(nb)
    if _route(dev) == "plain":
        if b:  # the tensors are on the host: no copy from the card
            lo, hi = torch.aminmax(torch.cat((rnblocks, hnblocks)))
            if int(lo) < 1 or int(hi) > nb:
                raise _bad_counts(nb, f" (got {int(lo)}..{int(hi)})")
        return pp.ed_sign_plain(a, a_enc, rblocks, rnblocks, hblocks, hnblocks)
    if b == 0:
        return torch.empty((0, 64), dtype=torch.uint8, device=dev)
    for n, t in (("a", a), ("a_enc", a_enc), ("rblocks", rblocks), ("hblocks", hblocks)):
        if t.data_ptr() % 16:
            raise ValueError(f"ed_sign.{n}: expected 16-byte aligned data")
    from . import build

    fn = build.kernel_lib("forge", "pk_ed_sign")
    t0 = time.monotonic()
    out, bad = _ed_sign_launch(fn, _stream(dev), a, a_enc, rblocks, rnblocks, hblocks, hnblocks)
    _launched("ed_sign", t0, (a, a_enc, rblocks, rnblocks, hblocks, hnblocks), (out, bad))
    if bad.cpu().any():
        raise _bad_counts(nb)
    return out
