#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Praos replay on one NVIDIA card.

    python3 chip_smoke.py                 # the full run (needs one CUDA card)
    python3 chip_smoke.py --headers 4096  # shorter chains, same phases

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (nvidia-smi), torch / CUDA versions, and
   the build of the eight kernel sources (one nvcc per source, in
   parallel) and of the C++ host crypto, with ptxas's registers and
   local memory per thread.
2. Kernels against their plain versions: 256 port-forged headers tiled
   to the main path's 8192 lanes, with corrupted lanes of every kind.
   Batch-compatible (128-byte proof) lanes for ed, kes, vrf_bc_prep,
   vrf_ladders and finish (OCert signature, KES signature, VRF proof, VRF
   output, non-canonical s, off-curve and non-canonical keys, x = 0 with
   the sign bit, a KES period out of range, a short SHA-512 block count);
   draft-03 (80-byte proof) lanes for vrf_prep (a flipped challenge byte,
   a flipped Γ byte, s + L, an off-curve VRF key, an off-curve Γ, a wrong
   alpha). Each kernel and its plain PyTorch version (run on the card,
   same inputs) must agree byte for byte; both are timed with CUDA
   events; the verdict rows must flag exactly the corrupted lanes.
3. The main paths, each with the launch counts zeroed just before its
   device replay and read just after. Chains are forged with bench.py's
   parameters (1 pool, KES depth 7, f = 1/2, 3600 slots per KES period,
   43200-slot epochs), replayed through
   `tools.db_analyser.revalidate(backend="device")` and through the C++
   verifier, which must agree on n_valid, error and final state:
   a. a batch-compatible chain, and a copy with one KES-signature byte
      flipped two thirds of the way in;
   b. a draft-03 chain, and a copy with one VRF-proof byte flipped two
      thirds of the way in and the header KES-signed again (both
      backends stop there with VRFKeyBadProof);
   c. a mixed chain of an eighth as many headers (draft-03 proofs in
      its first half, batch-compatible in its second: 4,096 headers and
      the switch at block 2,048 by default), whose windows must be cut
      at the switch.
4. The tools: the primitive harness (tools/debug_pk.py, all seven
   bodies OK on the card) and the field-op microbenchmark
   (tools/fe_bench.py: fe_mul against fe_sq, ns per op beside the bound).
5. A `kernels` JSON line, the card line, and the final status line.

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
from fractions import Fraction

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_ROWS = (
    # (LAUNCHES key = build name, source, TPU kernel it replaces)
    ("ed", "ouroboros_consensus_tpu_torch/ops/pk/csrc/ed.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:100"),
    ("kes", "ouroboros_consensus_tpu_torch/ops/pk/csrc/kes.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:122"),
    ("vrf_prep", "ouroboros_consensus_tpu_torch/ops/pk/csrc/vrf_prep.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:146"),
    ("vrf_bc_prep", "ouroboros_consensus_tpu_torch/ops/pk/csrc/vrf_bc_prep.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:204"),
    ("vrf_ladders", "ouroboros_consensus_tpu_torch/ops/pk/csrc/vrf_ladders.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:163"),
    ("finish", "ouroboros_consensus_tpu_torch/ops/pk/csrc/finish.cu",
     "ouroboros_consensus_tpu/ops/pk/kernels.py:245"),
    ("primitives", "ouroboros_consensus_tpu_torch/ops/pk/csrc/primitives.cu",
     "scripts/debug_pk_tpu.py:27"),
    ("fe_bench", "ouroboros_consensus_tpu_torch/ops/pk/csrc/fe_bench.cu",
     "scripts/exp_sqr.py:116"),
)
# the kernels each path must launch (and the replay kernels it must not)
PATH_KERNELS = {
    "bc": {"ed", "kes", "vrf_bc_prep", "vrf_ladders", "finish"},
    "draft03": {"ed", "kes", "vrf_prep", "vrf_ladders", "finish"},
    "mixed": {"ed", "kes", "vrf_prep", "vrf_bc_prep", "vrf_ladders", "finish"},
    "tools": {"primitives", "fe_bench"},
}
REPLAY_KERNELS = PATH_KERNELS["mixed"]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


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
    log(f"build: {len(build.KERNELS)} cuda sources {cuda_s:.1f} s (parallel nvcc), "
        f"native {native_s:.1f} s")
    ptxas = {}
    for name, _src, _rep in KERNEL_ROWS:
        with open(build.ptxas_report(name)) as f:
            text = f.read()
        # a source with several kernels reports its largest
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        stack = [int(x) for x in re.findall(r"(\d+) bytes cumulative stack size", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
        ptxas[name] = {
            "registers": max(regs, default=None),
            "stack_bytes": max(stack, default=None),
            "spill_store_bytes": sum(spills),
            "blocks_per_sm": build.blocks_per_sm(name),
        }
        log(f"ptxas {name}: {json.dumps(ptxas[name])}")
    return ptxas


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def tiled_window(lanes: int, distinct: int, seed: int, workdir: str,
                 proof_format: str):
    """`distinct` port-forged headers (one pool, bench-shaped params, KES
    depth 7) of one body width, tiled to `lanes` lanes, packed, unpacked
    and relaid as the stage kernels' limb-first columns (on the CPU).
    -> (limb-first columns, the seeded generator)."""
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.protocol import praos
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    db = os.path.join(workdir, f"views_{proof_format}")
    synth.synthesize(db, params, pools, lview, distinct, proof_format=proof_format)
    hvs = db_analyser.read_header_views(db)
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
    relayout = K.staged_to_limb_first_bc if proof_format == "bc" else K.staged_to_limb_first
    return list(relayout(*staged)), rng


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


def hold(key: str, kern, plain, inputs, lanes: int, dev, reps: int) -> dict:
    """One kernel against its plain version on the same inputs: byte-equal
    outputs or AssertionError; on the card both are timed with CUDA events.
    -> dict(max_abs_err, lanes, bytes[, ms, plain_ms])."""
    import torch

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
    moved = sum(t.numel() * t.element_size() for t in (*inputs, *got))
    rec = {"max_abs_err": float(err), "lanes": lanes, "bytes": moved}
    if dev.type == "cuda":
        from ouroboros_consensus_tpu_torch.device import time_ms

        rec["ms"] = time_ms(kern, reps)
        rec["plain_ms"] = time_ms(plain, 1)
    log(f"kernel {key}: equal to plain on {lanes} lanes"
        + (f"; {rec['ms']:.3f} ms/launch, plain {rec['plain_ms']:.1f} ms"
           if "ms" in rec else ""))
    return rec


def phase_kernels(dev, lanes: int = 8192, distinct: int = 256, seed: int = 7,
                  reps: int = 5, workdir: str | None = None):
    """Kernel vs plain version, byte for byte, at the main path's shapes.
    -> {key: dict(ms, plain_ms, max_abs_err, field_ops, lanes, bytes)}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.ops.pk import verify as pv

    depth = 7
    cols, rng = tiled_window(lanes, distinct, seed, workdir, "bc")
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
        stages[key] = hold(key, kern, plain, inputs[key], lanes, dev, reps)
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


DRAFT03_KINDS = ("challenge", "gamma_byte", "noncanon_s", "offcurve_vk",
                 "offcurve_gamma", "wrong_alpha")


def phase_vrf_prep(dev, lanes: int = 8192, distinct: int = 256, seed: int = 11,
                   reps: int = 5, workdir: str | None = None) -> dict:
    """The draft-03 prep kernel against its plain version on `lanes`
    draft-03 lanes with the draft-03 corrupt kinds (4 lanes each); the
    five draft-03 stages' verdict rows must fail exactly the corrupted
    lanes' VRF check and pass everything else. -> the vrf_prep record."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
    from ouroboros_consensus_tpu_torch.ops.pk import field as fe
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.ops.pk import verify as pv

    cols, rng = tiled_window(lanes, distinct, seed, workdir, "draft03")
    vrf_pk, vrf_g, vrf_c, vrf_s, vrf_al = cols[13:18]
    lanes_of = rng.choice(lanes, size=len(DRAFT03_KINDS) * 4, replace=False).reshape(-1, 4)
    off = torch.tensor(list(offcurve_y().to_bytes(32, "little")), dtype=torch.int32)
    for kind, ls in zip(DRAFT03_KINDS, lanes_of.tolist()):
        for lane in ls:
            if kind == "challenge":
                vrf_c[int(rng.integers(16)), lane] ^= 1 << int(rng.integers(8))
            elif kind == "gamma_byte":
                vrf_g[int(rng.integers(32)), lane] ^= 1 << int(rng.integers(8))
            elif kind == "noncanon_s":
                v = int.from_bytes(bytes(vrf_s[:, lane].tolist()), "little") + fe.L
                vrf_s[:, lane] = torch.tensor(list(v.to_bytes(32, "little")), dtype=torch.int32)
            elif kind == "offcurve_vk":
                vrf_pk[:, lane] = off
            elif kind == "offcurve_gamma":
                vrf_g[:, lane] = off
            elif kind == "wrong_alpha":
                vrf_al[int(rng.integers(32)), lane] ^= 1 << int(rng.integers(8))
    log("draft-03 corrupt lanes: " + json.dumps({k: 4 for k in DRAFT03_KINDS}))
    cols = [c.to(dev).contiguous() for c in cols]
    vrf_pk, vrf_g, vrf_c, vrf_s, vrf_al = cols[13:18]

    def plain():
        ok, h, y, g = pv.vrf_core_prep(vrf_pk, vrf_g, vrf_s, vrf_al)
        return (ok.to(torch.int32)[None],
                torch.cat([pc.stack(h), pc.stack(y), pc.stack(g)]).to(torch.int32))

    rec = hold("vrf_prep", lambda: K.vrf_prep(vrf_pk, vrf_g, vrf_s, vrf_al), plain,
               (vrf_pk, vrf_g, vrf_s, vrf_al), lanes, dev, reps)
    flags = K.verify_praos_tiles(*cols, kes_depth=7)[0].cpu()
    bad = np.zeros(lanes, bool)
    bad[lanes_of.reshape(-1)] = True
    if bool(flags[2][torch.from_numpy(bad)].any()) or not bool(flags[2][torch.from_numpy(~bad)].all()):
        raise AssertionError("the draft-03 VRF verdicts do not flag exactly the corrupted lanes")
    if not bool(flags[[0, 1, 3]].all()):
        raise AssertionError("a draft-03 lane failed a check its corruption does not touch")
    one = [c[..., :1].clone() for c in cols[13:18]]
    rec["field_ops"] = count_field_ops(lambda: pv.vrf_core_prep(one[0], one[1], one[3], one[4]))
    return rec


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def compare(tag: str, dres, nres) -> None:
    """Device and native replays agree on n_valid, error and final state."""
    from ouroboros_consensus_tpu_torch import carry

    same = (dres.n_valid == nres.n_valid
            and carry.error_to_plain(dres.error) == carry.error_to_plain(nres.error)
            and carry.state_to_plain(dres.final_state) == carry.state_to_plain(nres.final_state))
    if not same:
        raise AssertionError(
            f"{tag}: device ({dres.n_valid}, {dres.error!r}) != native "
            f"({nres.n_valid}, {nres.error!r}) or final states differ")
    log(f"{tag}: device == native: n_valid {dres.n_valid}, "
        f"error {carry.error_to_plain(dres.error)}")


STAGE_WRAPPERS = ("ed_points", "kes_points", "vrf_prep", "vrf_bc_prep", "vrf_ladders", "finish")


def replay_path(tag: str, db: str, params, lview, max_batch: int, dev) -> dict:
    """One main path: the device replay with the launch counts zeroed just
    before it and read just after (CUDA events around each stage wrapper,
    and the windows it cut), then the native replay, which must agree."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    events: dict = {}
    lanes: list = []
    windows: list = []
    saved = [(K, name, getattr(K, name)) for name in STAGE_WRAPPERS]
    saved.append((pbatch, "validate_batch", pbatch.validate_batch))

    def timed(*args, _fn, _name, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = _fn(*args, **kw)
        b.record()
        events.setdefault(_name, []).append((a, b))
        if _name == "ed_points":
            lanes.append(res[0].shape[-1])
        return res

    def window(params_, ticked, hvs, *args, _fn=pbatch.validate_batch, **kw):
        windows.append((len(hvs), len(hvs[0].vrf_proof)))
        return _fn(params_, ticked, hvs, *args, **kw)

    if dev.type == "cuda":
        for mod, name, fn in saved[:-1]:
            setattr(mod, name, lambda *a, _fn=fn, _name=name, **kw: timed(
                *a, _fn=_fn, _name=_name, **kw))
    pbatch.validate_batch = window
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
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    out = {
        "launches": launches,
        "stage_device_ms": {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()},
        "lanes_per_launch": lanes,
        "windows": windows,
    }
    log(f"{tag}: launches {json.dumps(launches)}")
    log(f"{tag}: device time per stage (ms): {json.dumps(out['stage_device_ms'])}")
    log(f"{tag}: windows (headers, proof bytes): {windows}")
    nres = db_analyser.revalidate(db, params, lview, backend="native", max_batch=max_batch)
    compare(f"{tag} chain", dres, nres)
    n = dres.n_valid
    out.update(n_valid=n, error=type(dres.error).__name__ if dres.error else None,
               device_hps=n / dres.validate_s, native_hps=n / nres.validate_s,
               device_validate_s=dres.validate_s, native_validate_s=nres.validate_s)
    log(f"{tag}: headers/s device {out['device_hps']:.1f} (validate {dres.validate_s:.2f} s), "
        f"native {out['native_hps']:.1f} (validate {nres.validate_s:.2f} s)")
    return out


def corrupted_replay(tag: str, db: str, headers: int, field: str, expect: str,
                     params, lview, max_batch: int, dev, pool=None) -> None:
    """Copy the chain, flip one byte of `field` in the header two thirds
    of the way in (KES-signing the header again when `pool` is given),
    and require both backends to stop there with `expect`."""
    from ouroboros_consensus_tpu_torch.testing import corrupt
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    bad = db + "_bad"
    shutil.copytree(db, bad)
    target = int(headers * 2 / 3)
    corrupt.flip_header_byte(bad, target, field, params=params if pool else None, pool=pool)
    dres = db_analyser.revalidate(bad, params, lview, backend="device",
                                  max_batch=max_batch, device=dev)
    nres = db_analyser.revalidate(bad, params, lview, backend="native", max_batch=max_batch)
    compare(f"{tag} chain, {field} byte flipped", dres, nres)
    if dres.n_valid != target or type(dres.error).__name__ != expect:
        raise AssertionError(f"{tag} corrupted chain: expected {expect} at {target}, "
                             f"got {dres.n_valid} {dres.error!r}")


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


def phase_main(dev, headers: int, mixed_headers: int, max_batch: int,
               workdir: str) -> dict:
    """The three main paths (bc, draft03, mixed); -> {path: replay_path's
    dict, with the layer split for the two single-format chains}."""
    from ouroboros_consensus_tpu_torch.testing import synth

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    switch = mixed_headers // 2
    chains = (
        ("bc", headers, "bc"),
        ("draft03", headers, "draft03"),
        ("mixed", mixed_headers, lambda n: 80 if n < switch else 128),
    )
    paths = {}
    for tag, n, fmt in chains:
        db = os.path.join(workdir, f"chain_{tag}")
        t0 = time.monotonic()
        synth.synthesize(db, params, pools, lview, n, proof_format=fmt)
        log(f"{tag}: forged {n} headers in {time.monotonic() - t0:.1f} s")
        out = replay_path(tag, db, params, lview, max_batch, dev)
        if out["error"] is not None or out["n_valid"] != n:
            raise AssertionError(f"{tag} chain did not validate: {out['n_valid']}/{n}")
        if tag == "mixed":
            starts = np.cumsum([0] + [w for w, _ in out["windows"]])
            cut = int(np.searchsorted(starts, switch))
            if starts[cut] != switch or out["windows"][cut][1] != 128 \
                    or out["windows"][cut - 1][1] != 80:
                raise AssertionError(f"mixed chain: no window cut at block {switch}")
            log(f"mixed: windows cut at the format switch (block {switch}): "
                f"{out['windows'][cut - 1]} | {out['windows'][cut]}")
        else:
            out["layers_s"] = layer_breakdown(db, params, lview, max_batch, dev)
            log(f"{tag}: host wall per layer, one more device replay (s): "
                f"{json.dumps(out['layers_s'])}")
        if tag == "bc":
            corrupted_replay(tag, db, n, "kes_sig", "InvalidKesSignatureOCERT",
                             params, lview, max_batch, dev)
        elif tag == "draft03":
            corrupted_replay(tag, db, n, "vrf_proof", "VRFKeyBadProof",
                             params, lview, max_batch, dev, pool=pools[0])
        paths[tag] = out
    return paths


# ---------------------------------------------------------------------------
# Phase 4: the tools
# ---------------------------------------------------------------------------


def phase_tools(dev, reps: int = 5) -> dict:
    """The primitive harness (all seven bodies OK on the card) and the
    field-op microbenchmark, with the launch counts zeroed just before and
    read just after; then each tool kernel against its plain version.
    -> dict(launches, fe_rows, records {primitives, fe_bench})."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.tools import debug_pk, fe_bench

    K.reset_launches()
    res = debug_pk.run(device=dev)
    for name, ok in res.items():
        log(f"debug_pk {name}: {'OK' if ok else 'MISMATCH'}")
    if not all(res.values()):
        raise AssertionError(f"primitive harness: {res}")
    fe_bench.check(dev)
    rows = fe_bench.bench(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: K.LAUNCHES[k] for k in PATH_KERNELS["tools"]}
    log(f"tools: launches {json.dumps(launches)}")
    for r in rows:
        log(f"fe_bench {r['op']:5s} at {r['lanes']} lanes: {r['ms']:.4f} ms, "
            f"{r['ns_per_op']:.6f} ns/op, bound {r['bound_ns_per_op']:.6f} ns/op "
            f"({r['ns_per_op'] / r['bound_ns_per_op']:.2f}x)")
    rec = {}
    # the harness: one pass of the seven bodies, kernels against twins
    bodies = debug_pk.bodies()
    args = [debug_pk._on(b.args, dev) for b in bodies]
    inputs = [a for bargs in args for a in bargs if isinstance(a, torch.Tensor)]
    rec["primitives"] = hold(
        "primitives", lambda: tuple(o for b in bodies for o in debug_pk.launch(b, dev)),
        lambda: tuple(o for b, a in zip(bodies, args) for o in b.twin(*a)),
        inputs, debug_pk.LANES, dev, reps)
    one = [debug_pk._on(tuple(a[..., :1] if isinstance(a, torch.Tensor) else a
                              for a in b.args), dev) for b in bodies]
    rec["primitives"]["products_per_lane"] = wide_products(count_field_ops(
        lambda: [b.twin(*a) for b, a in zip(bodies, one)]))
    # the microbenchmark: fe_sq at a full window's lanes, against its twin
    lanes = fe_bench.LANES[0]
    x = fe_bench.inputs(lanes).to(dev)
    rec["fe_bench"] = hold(
        "fe_bench", lambda: fe_bench.run("sq", x, fe_bench.STEPS),
        lambda: fe_bench.twin("sq", x, fe_bench.STEPS), (x,), lanes, dev, reps)
    rec["fe_bench"]["products_per_lane"] = (
        fe_bench.PRODUCTS["sq"] * fe_bench.STEPS * fe_bench.CHAINS)
    return {"launches": launches, "fe_rows": rows, "records": rec}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headers", type=int, default=32768,
                    help="headers of the bc and of the draft-03 chain; the "
                         "mixed chain has an eighth as many")
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ouroboros_consensus_tpu_torch.device import max_sm_clock_hz, resolve, wide_product_rate

    dev = resolve(None)
    card = card_line()
    log(f"card: {card}")
    t_all = time.monotonic()
    ptxas = phase_build()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        stages = phase_kernels(dev, workdir=work)
        stages["vrf_prep"] = phase_vrf_prep(dev, workdir=work)
        paths = phase_main(dev, a.headers, a.headers // 8, 8192, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tools = phase_tools(dev)
    stages.update(tools["records"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    # operation bound: the field work's 32x32->64 products (wide_products)
    # over device.wide_product_rate(); hashes, carries and adds are left
    # out, so this is a lower bound. Byte bound: the bytes moved over the
    # card's 3.35 TB/s.
    wide_rate = wide_product_rate()
    by_path = {p: out["launches"] for p, out in paths.items()}
    by_path["tools"] = tools["launches"]
    for path, ks in PATH_KERNELS.items():
        missing = sorted(k for k in ks if by_path[path][k] <= 0)
        stray = sorted(k for k in REPLAY_KERNELS - ks if by_path[path].get(k, 0))
        if missing or stray:
            raise AssertionError(f"{path} path: not launched {missing}, launched {stray}")
    kernels = []
    for name, src, rep in KERNEL_ROWS:
        st = stages[name]
        per_lane = st.get("products_per_lane") or wide_products(st["field_ops"])
        ops_ms = per_lane * st["lanes"] / wide_rate * 1e3
        bytes_ms = st["bytes"] / 3.35e12 * 1e3
        used = [p for p, ks in PATH_KERNELS.items() if name in ks]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path[p][name] for p in used),
            "launches_by_path": {p: by_path[p][name] for p in used},
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "field_ops_per_lane": st.get("field_ops"),
            "wide_products_per_lane": per_lane,
            "lanes": st["lanes"], "bytes": st["bytes"], "ptxas": ptxas.get(name),
        })
    for p, out in paths.items():
        fill = [{"lanes": n, "blocks": -(-n // 128), "sms_busy_at_most": min(-(-n // 128), sms)}
                for n in out["lanes_per_launch"]]
        log(f"{p}: grid fill per window (128 threads per block, {sms} SMs): {json.dumps(fill)}")
        log(f"{p}: {json.dumps({k: v for k, v in out.items() if k not in ('launches', 'windows')})}")
    log(f"fe_bench rows: {json.dumps(tools['fe_rows'])}")
    log(f"total {time.monotonic() - t_all:.1f} s; sms {sms}, max sm clock {clock / 1e6:.0f} MHz")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
