#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Praos replay on one NVIDIA card.

    python3 chip_smoke.py                 # the full run (needs one CUDA card)
    python3 chip_smoke.py --headers 4096  # a shorter chain, same phases

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (nvidia-smi), torch / CUDA versions, and
   the build of the five stage kernels (one nvcc per source, in
   parallel) and of the C++ host crypto, with ptxas's registers and
   local memory per thread.
2. Kernels against their plain versions: 256 port-forged headers tiled
   to the main path's 8192 lanes, with corrupted lanes of every kind
   (OCert signature, KES signature, VRF proof, VRF output, non-canonical
   s, off-curve and non-canonical keys, x = 0 with the sign bit, a KES
   period out of range, a short SHA-512 block count). Each kernel and
   its plain PyTorch version (run on the card, same inputs) must agree
   byte for byte; both are timed with CUDA events.
3. The main path: forge a chain (bench.py's parameters: 1 pool, KES
   depth 7, f = 1/2, 3600 slots per KES period, 43200-slot epochs),
   replay it through `tools.db_analyser.revalidate(backend="device")`
   with the launch counts zeroed just before and read just after, replay
   it through the C++ verifier, and require equal n_valid, error and
   final state; then again on a copy with one KES-signature byte flipped
   two thirds of the way in.
4. A `kernels` JSON line, the card line, and the final status line.

It needs no network and no JAX; it imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from fractions import Fraction

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_ROWS = (
    # (LAUNCHES key, build name, source, TPU kernel it replaces)
    ("ed", "ed", "ouroboros_consensus_tpu_torch/ops/pk/csrc/ed.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:100"),
    ("kes", "kes", "ouroboros_consensus_tpu_torch/ops/pk/csrc/kes.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:122"),
    ("vrf_bc_prep", "vrf_prep", "ouroboros_consensus_tpu_torch/ops/pk/csrc/vrf_prep.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:204"),
    ("vrf_ladders", "vrf_ladders", "ouroboros_consensus_tpu_torch/ops/pk/csrc/vrf_ladders.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:163"),
    ("finish", "finish", "ouroboros_consensus_tpu_torch/ops/pk/csrc/finish.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:245"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def bench_params():
    from ouroboros_consensus_tpu_torch.protocol.praos import PraosParams

    return PraosParams(
        slots_per_kes_period=3600, max_kes_evolutions=62,
        security_param=2160, active_slot_coeff=Fraction(1, 2),
        epoch_length=43200, kes_depth=7,
    )


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    import torch

    from ouroboros_consensus_tpu_torch import native
    from ouroboros_consensus_tpu_torch.ops.pk import build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    native.build()
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    build.build_cuda()
    cuda_s = time.monotonic() - t0
    log(f"build: cuda kernels {cuda_s:.1f} s (parallel nvcc), native {native_s:.1f} s")
    ptxas = {}
    for _key, name, _src, _rep in KERNEL_ROWS:
        with open(build.ptxas_report(name)) as f:
            text = f.read()
        regs = re.search(r"Used (\d+) registers", text)
        stack = re.search(r"(\d+) bytes cumulative stack size", text)
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
        ptxas[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "stack_bytes": int(stack.group(1)) if stack else None,
            "spill_store_bytes": sum(spills),
            "blocks_per_sm": build.blocks_per_sm(name),
        }
        log(f"ptxas {name}: {json.dumps(ptxas[name])}")
    return ptxas


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def forge_views(n: int, depth: int, workdir: str):
    """n port-forged header views (one pool, bench-shaped params)."""
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=depth)]
    lview = synth.make_ledger_view(pools)
    db = os.path.join(workdir, "views")
    synth.synthesize(db, params, pools, lview, n)
    return params, lview, db_analyser.read_header_views(db)


def offcurve_y() -> int:
    """The smallest y > 1 with no x on the curve ((y²-1)/(dy²+1) is not
    a square mod p)."""
    from ouroboros_consensus_tpu_torch.ops.pk import field as fe

    for y in range(2, 1000):
        x2 = (y * y - 1) * pow(fe.D * y * y + 1, fe.P - 2, fe.P) % fe.P
        if pow(x2, (fe.P - 1) // 2, fe.P) == fe.P - 1:
            return y
    raise AssertionError("no off-curve y found")


def corrupt_columns(cols: list, rng: np.random.Generator, depth: int) -> dict:
    """Apply every corrupt-lane kind to seeded lanes of the limb-first
    columns (in place); -> {kind: lanes}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import field as fe

    (ed_pk, ed_r, ed_s, ed_hb, ed_hnb, kes_vk, kes_per, kes_r, kes_s,
     kes_leaf, kes_sib, kes_hb, kes_hnb, vrf_pk, vrf_g, vrf_u, vrf_v,
     vrf_s, vrf_al, beta, tlo, thi) = cols
    b = ed_pk.shape[-1]
    lanes = rng.choice(b, size=13 * 4, replace=False).reshape(13, 4)
    kinds = {}

    def put(t, lane, vals):
        t[:, lane] = torch.tensor(vals, dtype=torch.int32)

    def flip(t, lane):
        r = int(rng.integers(t.shape[0]))
        t[r, lane] ^= 1 << int(rng.integers(8))

    p_bytes = list((fe.P).to_bytes(32, "little"))
    off = list(offcurve_y().to_bytes(32, "little"))
    for k, kind in enumerate([
        "ocert_sig", "kes_sig", "vrf_proof", "vrf_output", "noncanon_s",
        "offcurve_vk", "noncanon_y", "x0_sign", "kes_period_range",
        "short_blocks", "kes_sibling", "vrf_s", "gamma_offcurve",
    ]):
        for lane in lanes[k].tolist():
            if kind == "ocert_sig":
                flip(ed_r, lane)
            elif kind == "kes_sig":
                flip(kes_s, lane)
            elif kind == "vrf_proof":
                flip(vrf_u, lane)
            elif kind == "vrf_output":
                flip(beta, lane)
            elif kind == "noncanon_s":
                s = int.from_bytes(bytes(ed_s[:, lane].tolist()), "little") + fe.L
                put(ed_s, lane, list(s.to_bytes(32, "little")))
            elif kind == "offcurve_vk":
                put(ed_pk, lane, off)
            elif kind == "noncanon_y":
                put(kes_leaf, lane, p_bytes)  # y = p: not canonical
            elif kind == "x0_sign":
                put(vrf_pk, lane, [1] + [0] * 30 + [0x80])  # y = 1, x = 0, sign 1
            elif kind == "kes_period_range":
                kes_per[0, lane] = (1 << depth) + 3
            elif kind == "short_blocks":
                ed_hnb[0, lane] = 1
            elif kind == "kes_sibling":
                flip(kes_sib[int(rng.integers(depth))], lane)
            elif kind == "vrf_s":
                flip(vrf_s, lane)
            elif kind == "gamma_offcurve":
                put(vrf_g, lane, off)
        kinds[kind] = lanes[k].tolist()
    return kinds


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_field_ops(fn) -> dict:
    """Field multiplies and squarings one lane of `fn` performs (the plain
    twin's count; every stage's count is independent of the data)."""
    from ouroboros_consensus_tpu_torch.ops.pk import field as fe

    mul, sqr = fe.mul, fe.sqr
    n = {"mul": 0, "sqr": 0}

    def counting_mul(a, b):
        n["mul"] += 1
        return mul(a, b)

    def counting_sqr(a):
        n["sqr"] += 1
        return mul(a, a)

    fe.mul, fe.sqr = counting_mul, counting_sqr
    try:
        fn()
    finally:
        fe.mul, fe.sqr = mul, sqr
    return n


def wide_products(ops: dict) -> int:
    """32x32->64 products the counted field work needs in 10-limb radix
    2^25.5: 100 for a multiply (10 x 10), 55 for a squaring (10 squares
    and 45 distinct cross terms, ref10's fe_sq)."""
    return 100 * ops["mul"] + 55 * ops["sqr"]


def phase_kernels(dev, lanes: int = 8192, distinct: int = 256, seed: int = 7,
                  reps: int = 5, workdir: str | None = None):
    """Kernel vs plain version, byte for byte, at the main path's shapes.
    -> {key: dict(ms, plain_ms, max_abs_err, field_ops, lanes, bytes)}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.ops.pk import verify as pv
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.protocol import praos

    depth = 7
    params, lview, hvs = forge_views(distinct, depth, workdir)
    # one packed window per body width: take the widest run of views
    key = max({len(h.signed_bytes) for h in hvs},
              key=lambda w: sum(len(h.signed_bytes) == w for h in hvs))
    hvs = [h for h in hvs if len(h.signed_bytes) == key]
    rng = np.random.default_rng(seed)
    pick = rng.integers(len(hvs), size=lanes)
    window = [hvs[i] for i in pick.tolist()]
    eta0 = praos.tick(params, lview, window[0].slot, praos.PraosState()).state.epoch_nonce
    layout, packed = pbatch.stage_packed(params, lview, eta0, window)
    staged = pbatch.unpack_packed(layout, packed, "cpu")
    cols = list(K.staged_to_limb_first_bc(*staged))
    kinds = corrupt_columns(cols, rng, depth)
    log("corrupt lanes: " + json.dumps({k: len(v) for k, v in kinds.items()}))
    cols = [c.to(dev).contiguous() for c in cols]
    (ed_pk, ed_r, ed_s, ed_hb, ed_hnb, kes_vk, kes_per, kes_r, kes_s,
     kes_leaf, kes_sib, kes_hb, kes_hnb, vrf_pk, vrf_g, vrf_u, vrf_v,
     vrf_s, vrf_al, beta, tlo, thi) = cols

    def i64(t):
        return t.to(torch.int64)

    def plain_ed():
        ok, p = pv.ed_core(ed_pk, ed_s, ed_hb, ed_hnb[0])
        return ok.to(torch.int32)[None], pc.stack(p).to(torch.int32)

    def plain_kes():
        ok, p = pv.kes_core(kes_vk, kes_per[0], kes_s, kes_leaf, kes_sib,
                            kes_hb, kes_hnb[0], depth)
        return ok.to(torch.int32)[None], pc.stack(p).to(torch.int32)

    def plain_prep():
        ok, c16, h, y, g = pv.vrf_core_bc_prep(vrf_pk, vrf_g, vrf_u, vrf_v, vrf_s, vrf_al)
        return (ok.to(torch.int32)[None], c16.to(torch.int32),
                torch.cat([pc.stack(h), pc.stack(y), pc.stack(g)]).to(torch.int32))

    stages = {}
    ed_ok, ed_pt = plain_ed()
    kes_ok, kes_pt = plain_kes()
    vrf_ok, c16, prep = plain_prep()

    def plain_ladders():
        h, y, g = (pc.unstack(i64(prep[40 * k: 40 * (k + 1)])) for k in range(3))
        return torch.cat([pc.stack(p) for p in pv.vrf_core_ladders(c16, vrf_s, h, y, g)]).to(torch.int32)

    pts = plain_ladders()

    def plain_finish():
        vp = [pc.unstack(i64(pts[40 * k: 40 * (k + 1)])) for k in range(5)]
        f, e, lv = pv.finish_core(
            ed_ok[0] != 0, pc.unstack(i64(ed_pt)), ed_r, kes_ok[0] != 0,
            pc.unstack(i64(kes_pt)), kes_r, vrf_ok[0] != 0, vp, c16, beta, tlo, thi)
        return f.to(torch.int32), e.to(torch.int32), lv.to(torch.int32)

    flags_plain = plain_finish()
    runs = {
        "ed": (lambda: K.ed_points(ed_pk, ed_s, ed_hb, ed_hnb), plain_ed),
        "kes": (lambda: K.kes_points(kes_vk, kes_per, kes_s, kes_leaf, kes_sib,
                                     kes_hb, kes_hnb, depth), plain_kes),
        "vrf_bc_prep": (lambda: K.vrf_bc_prep(vrf_pk, vrf_g, vrf_u, vrf_v, vrf_s, vrf_al),
                        plain_prep),
        "vrf_ladders": (lambda: K.vrf_ladders(c16, vrf_s, prep), plain_ladders),
        "finish": (lambda: K.finish(ed_ok, ed_pt, ed_r, kes_ok, kes_pt, kes_r,
                                    vrf_ok, pts, c16, beta, tlo, thi), plain_finish),
    }
    table = K._base8(dev)
    inputs = {
        "ed": (table, ed_pk, ed_s, ed_hb, ed_hnb),
        "kes": (table, kes_vk, kes_per, kes_s, kes_leaf, kes_sib, kes_hb, kes_hnb),
        "vrf_bc_prep": (vrf_pk, vrf_g, vrf_u, vrf_v, vrf_s, vrf_al),
        "vrf_ladders": (table, c16, vrf_s, prep),
        "finish": (ed_ok, ed_pt, ed_r, kes_ok, kes_pt, kes_r, vrf_ok, pts, c16,
                   beta, tlo, thi),
    }
    for key, (kern, plain) in runs.items():
        got = kern()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"kernel {key} disagrees with its plain version "
                                 f"(max abs err {err})")
        # each input read once, each output written once
        moved = sum(t.numel() * t.element_size() for t in (*inputs[key], *got))
        rec = {"max_abs_err": float(err), "lanes": lanes, "bytes": moved}
        if dev.type == "cuda":
            rec["ms"] = _time_ms(kern, reps)
            rec["plain_ms"] = _time_ms(plain, 1)
        stages[key] = rec
        log(f"kernel {key}: equal to plain on {lanes} lanes"
            + (f"; {rec['ms']:.3f} ms/launch, plain {rec['plain_ms']:.1f} ms"
               if "ms" in rec else ""))
    # the verdicts must flag the corrupted lanes as the kinds dictate
    f = flags_plain[0].cpu()
    for kind, ls in kinds.items():
        row = {"ocert_sig": 0, "noncanon_s": 0, "offcurve_vk": 0, "short_blocks": 0,
               "kes_sig": 1, "noncanon_y": 1, "kes_period_range": 1,
               "kes_sibling": 1}.get(kind, 2)
        if f[row, ls].any():
            raise AssertionError(f"corrupt lanes of kind {kind} passed check row {row}")
    clean = np.setdiff1d(np.arange(lanes), np.concatenate(list(kinds.values())))
    if not bool(f[:4, clean].all()):
        raise AssertionError("an uncorrupted lane failed a check")
    # multiply counts per lane (data-independent) for the operation bound
    one = [c[..., :1].clone() for c in cols]
    for key, fn in (("ed", lambda: pv.ed_core(one[0], one[2], one[3], one[4][0])),
                    ("kes", lambda: pv.kes_core(one[5], one[6][0], one[8], one[9],
                                                one[10], one[11], one[12][0], depth)),
                    ("vrf_bc_prep", lambda: pv.vrf_core_bc_prep(*one[13:19])),
                    ("vrf_ladders", lambda: pv.vrf_core_ladders(
                        c16[:, :1], one[17], *(pc.unstack(i64(prep[40 * k: 40 * (k + 1), :1]))
                                               for k in range(3)))),
                    ("finish", lambda: pv.finish_core(
                        ed_ok[0, :1] != 0, pc.unstack(i64(ed_pt[:, :1])), one[1],
                        kes_ok[0, :1] != 0, pc.unstack(i64(kes_pt[:, :1])), one[7],
                        vrf_ok[0, :1] != 0,
                        [pc.unstack(i64(pts[40 * k: 40 * (k + 1), :1])) for k in range(5)],
                        c16[:, :1], one[19], one[20], one[21]))):
        stages[key]["field_ops"] = count_field_ops(fn)
    return stages


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def flip_kes_byte(db: str, frac: float) -> int:
    """Flip one KES-signature byte of the header `frac` of the way into
    the chain and re-seal its index CRC (so storage validation passes and
    only the protocol check can catch it); -> the header's index."""
    from ouroboros_consensus_tpu_torch.block.praos_block import Block
    from ouroboros_consensus_tpu_torch.storage.immutable import (
        ImmutableDB, chunk_name, index_name,
    )
    from ouroboros_consensus_tpu_torch.utils import cbor

    imm = ImmutableDB(os.path.join(db, "immutable"))
    entries = [(n, k, e) for n in imm._chunks for k, e in enumerate(imm._entries[n])]
    target = int(len(entries) * frac)
    n, k, e = entries[target]
    cpath = os.path.join(imm.path, chunk_name(n))
    data = bytearray(open(cpath, "rb").read())
    blob = bytes(data[e.offset: e.offset + e.size])
    sig = Block.from_bytes(blob).header.kes_sig
    at = e.offset + blob.index(sig) + 40  # inside the leaf signature's s
    data[at] ^= 0x01
    open(cpath, "wb").write(bytes(data))
    ipath = os.path.join(imm.path, index_name(n))
    rows = [list(x.to_cbor_obj()) for x in imm._entries[n]]
    rows[k][5] = zlib.crc32(bytes(data[e.offset: e.offset + e.size]))
    open(ipath, "wb").write(b"".join(cbor.encode(r) for r in rows))
    return target


def layer_breakdown(db: str, params, lview, max_batch: int, dev) -> dict:
    """Host wall per layer of one more device replay: the packed device
    step (unpack, five kernels, reduce) is synchronised so that its wall
    is its own, which is why this is not the timed replay."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    spent: dict = {}
    saved = []
    for mod, name in ((pbatch, "host_prechecks"), (pbatch, "stage_packed"),
                      (pbatch, "pad_packed_to"), (K, "verify_praos_packed_split"),
                      (pbatch, "epilogue")):
        fn = getattr(mod, name)

        def wrapper(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            res = _fn(*args, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t0
            return res

        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)
    try:
        res = db_analyser.revalidate(db, params, lview, backend="device",
                                     max_batch=max_batch, device=dev)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    spent["other"] = res.validate_s - sum(spent.values())
    spent["validate_s"] = res.validate_s
    return spent


def phase_main(dev, headers: int, max_batch: int, workdir: str) -> dict:
    import torch

    from ouroboros_consensus_tpu_torch import carry
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    db = os.path.join(workdir, "chain")
    t0 = time.monotonic()
    synth.synthesize(db, params, pools, lview, headers)
    log(f"forged {headers} headers in {time.monotonic() - t0:.1f} s")

    def compare(tag, dres, nres):
        same = (dres.n_valid == nres.n_valid
                and carry.error_to_plain(dres.error) == carry.error_to_plain(nres.error)
                and carry.state_to_plain(dres.final_state) == carry.state_to_plain(nres.final_state))
        if not same:
            raise AssertionError(
                f"{tag}: device ({dres.n_valid}, {dres.error!r}) != native "
                f"({nres.n_valid}, {nres.error!r}) or final states differ")
        log(f"{tag}: device == native: n_valid {dres.n_valid}, "
            f"error {carry.error_to_plain(dres.error)}")

    # warm the kernels' first use (library load, table upload) outside
    # the timed replay; the launch counts are zeroed just before it
    out = {}
    events: dict = {}
    lanes: dict = {}
    wrapped = {}
    for name in ("ed_points", "kes_points", "vrf_bc_prep", "vrf_ladders", "finish"):
        wrapped[name] = getattr(K, name)

        def timed(*args, _fn=wrapped[name], _name=name, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res = _fn(*args, **kw)
            b.record()
            events.setdefault(_name, []).append((a, b))
            lanes.setdefault(_name, []).append(
                (res[0] if isinstance(res, tuple) else res).shape[-1])
            return res

        if dev.type == "cuda":
            setattr(K, name, timed)
    try:
        K.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dres = db_analyser.revalidate(db, params, lview, backend="device",
                                      max_batch=max_batch, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        for name, fn in wrapped.items():
            setattr(K, name, fn)
    log(f"launches on the main path: {json.dumps(launches)}")
    stage_ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    out["stage_device_ms"] = stage_ms
    out["lanes_per_launch"] = lanes.get("ed_points", [])
    log(f"device time per stage on the main path (ms): {json.dumps(stage_ms)}")
    log(f"lanes per launch on the main path: {out['lanes_per_launch']}")
    nres = db_analyser.revalidate(db, params, lview, backend="native", max_batch=max_batch)
    compare("clean chain", dres, nres)
    if dres.error is not None or dres.n_valid != headers:
        raise AssertionError(f"clean chain did not validate: {dres.n_valid}/{headers}")
    out["launches"] = launches
    out["device_hps"] = headers / dres.validate_s
    out["native_hps"] = headers / nres.validate_s
    out["device_validate_s"] = dres.validate_s
    out["native_validate_s"] = nres.validate_s
    log(f"headers/s: device {out['device_hps']:.1f} (validate {dres.validate_s:.2f} s), "
        f"native {out['native_hps']:.1f} (validate {nres.validate_s:.2f} s)")

    out["layers_s"] = layer_breakdown(db, params, lview, max_batch, dev)
    log(f"host wall per layer, one more device replay (s): {json.dumps(out['layers_s'])}")

    bad = os.path.join(workdir, "chain_bad")
    shutil.copytree(db, bad)
    target = flip_kes_byte(bad, 2 / 3)
    dres = db_analyser.revalidate(bad, params, lview, backend="device",
                                  max_batch=max_batch, device=dev)
    nres = db_analyser.revalidate(bad, params, lview, backend="native", max_batch=max_batch)
    compare("corrupted chain", dres, nres)
    if dres.n_valid != target or type(dres.error).__name__ != "InvalidKesSignatureOCERT":
        raise AssertionError(f"corrupted chain: expected InvalidKesSignatureOCERT at "
                             f"{target}, got {dres.n_valid} {dres.error!r}")
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headers", type=int, default=32768)
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ouroboros_consensus_tpu_torch.device import resolve

    dev = resolve(None)
    card = card_line()
    log(f"card: {card}")
    t_all = time.monotonic()
    ptxas = phase_build()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        stages = phase_kernels(dev, workdir=work)
        main_out = phase_main(dev, a.headers, 8192, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    # operation bound: the field work's 32x32->64 products (wide_products).
    # The CUDA C++ Programming Guide's throughput table gives 64 results per
    # SM per clock for 32-bit integer multiply-add on compute capability
    # 9.0; a 64-bit product is two of them (its low and high halves). Hashes,
    # carries and adds are left out, so this is a lower bound. Byte bound:
    # the bytes moved over the card's 3.35 TB/s.
    wide_rate = sms * 64 / 2 * clock
    kernels = []
    for key, name, src, rep in KERNEL_ROWS:
        st = stages[key]
        products = wide_products(st["field_ops"]) * st["lanes"]
        ops_ms = products / wide_rate * 1e3
        bytes_ms = st["bytes"] / 3.35e12 * 1e3
        kernels.append({
            "name": key, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_out["launches"][key],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "field_ops_per_lane": st["field_ops"],
            "lanes": st["lanes"], "bytes": st["bytes"], "ptxas": ptxas.get(name),
        })
    fill = [{"lanes": n, "blocks": -(-n // 128), "sms_busy_at_most": min(-(-n // 128), sms)}
            for n in main_out["lanes_per_launch"]]
    log(f"grid fill per window (128 threads per block, {sms} SMs): {json.dumps(fill)}")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was not launched on the main path")
    log(f"main path: {json.dumps({k: v for k, v in main_out.items() if k != 'launches'})}")
    log(f"total {time.monotonic() - t_all:.1f} s; sms {sms}, max sm clock {clock / 1e6:.0f} MHz")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
