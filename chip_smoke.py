#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Praos replay on one NVIDIA card.

    python3 chip_smoke.py                 # the full run (needs one CUDA card)
    python3 chip_smoke.py --headers 4096  # shorter chains, same phases

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (nvidia-smi), torch / CUDA versions, and
   the build of the thirteen kernel sources (one nvcc per source, in
   parallel) and of the C++ host crypto, with ptxas's registers and
   local memory per thread.
2. Kernels against their plain versions: 256 port-forged headers tiled
   to the main path's 8192 lanes, with corrupted lanes of every kind.
   Batch-compatible (128-byte proof) lanes for ed, kes, vrf_bc_prep,
   vrf_ladders and finish (OCert signature, KES signature, VRF proof, VRF
   output, non-canonical s, off-curve and non-canonical keys, x = 0 with
   the sign bit, a KES period out of range, a short SHA-512 block count);
   draft-03 (80-byte proof) lanes for vrf_prep and vrf_ladders (a flipped
   challenge byte, a flipped Γ byte, s + L, an off-curve VRF key, an
   off-curve Γ, a wrong alpha). Each kernel and its plain PyTorch
   version (run on the card, same inputs) must agree byte for byte; both
   are timed with CUDA events; the verdict rows must flag exactly the
   corrupted lanes. Then the two wire kernels at 8, 128 and 8,192 lanes
   (`phase_wire`): `unpack` on bc and draft-03 packed windows under the
   neutral and a set epoch nonce, every wire corruption (a flipped bit in
   each body field, the KES R ‖ s, int32-extreme counter and slot, a c0
   past the slot's KES period, new KES-tail and threshold rows) and
   bucket-padding lanes; `nonce_fold` over seeded declared VRF outputs β
   from neutral and set carry-ins over all lanes and all but the last
   three. Both are timed around their wrappers and, alone, in a CUDA
   graph of 20 launches (the kernel's own device time, which the kernels
   line reports as `ms`). Then one Blake2b compression on one warp
   (`b2b_bench`: cycles a compression on one thread, through pk.cuh's
   looped hash and on four lanes, the four-lane chain's G steps and
   exchanges alone, and each loop's SASS instructions). Then the window
   aggregate (`phase_agg`) at 8, 128 and 8,192 lanes of a tiled bc
   window, clean and with a torsion-offset R_k, a flipped OCert s and a
   wrong β: `agg_prep` and `agg_tables` byte for byte against their
   plain versions, the dedupe (torch) on the card against the CPU (and
   its cap-2 overflow), `msm` against its plain version as points
   (compressed total, identity flag; not on the widest dirty window),
   and `aggregate_window`: the identity and the five stages' verdicts on
   the clean window, agg_ok false on the dirty one; then the same on a
   full 8,192-lane window of the forged bc chain (`phase_agg_chain`: the
   bucket shape the replay gives msm, which the tiled window's repeated
   scalars do not), whose times the kernels line reports, each kernel
   beside its bound (msm's from this run's bucket entries, `msm_work`).
3. The main paths, each with the launch counts zeroed just before its
   device replay and read just after: every packed window launches
   `unpack`, the five stage kernels and `nonce_fold`, the fold on a
   stream of its own (checked) beside the stages, the carry chained
   from window to window on the card; a batch-compatible packed window
   takes the window aggregate (`agg_prep`, the dedupe, `agg_tables`,
   `msm`) in place of the five stages, and none of a clean chain's
   windows may be re-dispatched (`batch.AGG_REDISPATCH`). Chains are
   forged with bench.py's
   parameters (1 pool, KES depth 7, f = 1/2, 3600 slots per KES period,
   43200-slot epochs) and sealed at forge time, each in a process of its
   own that starts after the build and runs beside phase 2 (`Forges`),
   replayed through
   `tools.db_analyser.revalidate(backend="device")` on its default path
   (every chunk's sealed sidecar into ViewColumns, which must be a `hit`
   on every chunk; columnar prechecks, packed staging and epilogue; the
   next segment read on a prefetch thread and three windows staged
   ahead on a staging thread and three in flight) and through the C++
   verifier, which must agree on n_valid, error and final state:
   a. a batch-compatible chain, also on the list path
      (`revalidate(columnar=False)`: HeaderView lists from the same scan),
      which must equal the columnar one; then (`sidecar_checks`) the scan
      path (`sidecar=False`) and the serial loop (`pipeline_depth=1`,
      `prefetch=False`), which must equal the default, a copy with a
      stale and a torn seal, which must fall back on those two chunks,
      device == native, the read's parts on both paths
      (`read_breakdown`), the replay with and without its overlap in
      turns (`overlap_turns`, each with its garbage-collector pauses) and
      one default replay's timeline (`pipeline_timeline`: each window's
      staging, launch, device interval and retire, and the card's busy
      share of the wall); the replay with `aggregate=False` (the five
      stages on every window, `bc_lanes`) and its serial layer split;
      three corrupted copies through the aggregate (a KES-signature byte
      two thirds of the way in, an OCert-signature byte and a VRF-proof
      byte, KES-signed again, an eighth of the way in), each
      re-dispatching its dirty window to the stages (`bc_dirty`); and the
      port bench's measurement (`tools.bench.measure`: a native replay, a
      warm-up and the best of two timed device replays, every chunk a
      sidecar hit; the native replay is the bc path's own) of the same
      chain with the aggregate on and off, on `bench {...}` and
      `bench_lanes {...}` lines;
   b. a draft-03 chain, and a copy with one VRF-proof byte flipped two
      thirds of the way in and the header KES-signed again (both
      backends stop there with VRFKeyBadProof);
   c. a mixed chain of an eighth as many headers (draft-03 proofs in
      its first half, batch-compatible in its second: 4,096 headers and
      the switch at block 2,048 by default), whose windows must be cut
      at the switch.
   d. the generic staging: the views of a bc chain of an eighth as many
      headers with their KES-signed bodies replaced by a stand-in that
      embeds no header field (testing/corrupt.standin_views), so the
      packed staging declines the window (`field-offsets`, which must be
      recorded) and `protocol/batch.stage` feeds the same kernels;
      replayed by `validate_chain` on the card and by the C++ verifier,
      then a copy with one VRF-proof byte flipped two thirds of the way in,
      then the chain with only its middle third on stand-in bodies, in
      64-header windows: the packed window after the generic ones (the
      stand-ins, and the windows that hold a body-width step) must seed
      the nonce carry from the host state again, and every packed window
      launch unpack and nonce_fold.
   Each main path logs headers/s over `validate_s` (the validate_chain
   calls) and over `wall_s` (the read as well), the read's own time
   (`read_s`, overlapped) and the time validation waited for it
   (`wait_s`), and the single-format chains a host wall per layer of a
   serial replay (`layer_breakdown`: the columnar layers by their own
   names, and `read`).
4. The tools: the primitive harness (tools/debug_pk.py, all seven
   bodies OK on the card) and the field-op microbenchmark
   (tools/fe_bench.py: fe_mul against fe_sq, ns per op beside the bound).
5. A `kernels` JSON line (thirteen kernels), the card line, and the
   final status line.

Phase 2 also times the six stage kernels at the main path's one-block
widths (8 and 128 lanes), and phase 1 prints ptxas's registers, stack
and spill stores of each launched kernel with its resident blocks per SM.

    python3 chip_smoke.py --ab PARENT     # A/B against another checkout

runs, on one card and in turns (parent, this tree, this tree, parent),
one process per turn: each tree's own phase 1 and phase 2 and the six
stage kernels of each tree at 8, 128 and 8192 lanes (`stage_times`), and
the two wire kernels alone where the tree has them (`wire_times`); one
`AB {...}` JSON line per turn.

    python3 chip_smoke.py --ab-replay PARENT   # the replay, against PARENT

forges the bc chain once (`--headers`), then in the same turns each
tree's own replay of it: three device `revalidate`s (the first warms
up) and the tree's own `layer_breakdown`; one `ABR {...}` JSON line per
turn and the minimum of each side.

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
    ("unpack", "ouroboros_consensus_tpu_torch/ops/pk/csrc/unpack.cu",
     "ouroboros_consensus_tpu/protocol/batch.py:1221"),
    ("nonce_fold", "ouroboros_consensus_tpu_torch/ops/pk/csrc/nonce_fold.cu",
     "ouroboros_consensus_tpu/ops/blake2b.py:271"),
    ("primitives", "ouroboros_consensus_tpu_torch/ops/pk/csrc/primitives.cu",
     "scripts/debug_pk_tpu.py:27"),
    ("fe_bench", "ouroboros_consensus_tpu_torch/ops/pk/csrc/fe_bench.cu",
     "scripts/exp_sqr.py:116"),
    ("agg_prep", "ouroboros_consensus_tpu_torch/ops/pk/csrc/agg_prep.cu",
     "ouroboros_consensus_tpu/ops/pk/aggregate.py:232"),
    ("agg_tables", "ouroboros_consensus_tpu_torch/ops/pk/csrc/agg_tables.cu",
     "ouroboros_consensus_tpu/ops/pk/limbs.py:489"),
    ("msm", "ouroboros_consensus_tpu_torch/ops/pk/csrc/msm.cu",
     "ouroboros_consensus_tpu/ops/pk/msm.py:381"),
)
# the kernels each path must launch (and the replay kernels it must not)
WIRE = {"unpack", "nonce_fold"}  # every packed window's, around the stages
AGG = {"agg_prep", "agg_tables", "msm"}  # the window aggregate's
BC_STAGES = {"ed", "kes", "vrf_bc_prep", "vrf_ladders", "finish"}
D3_STAGES = {"ed", "kes", "vrf_prep", "vrf_ladders", "finish"}
PATH_KERNELS = {
    # batch-compatible packed windows take the aggregate (the default)
    "bc": AGG | WIRE,
    # the same chain with aggregate=False: the five per-lane stages
    "bc_lanes": BC_STAGES | WIRE,
    # corrupted bc copies: the aggregate, then the stages on the dirty window
    "bc_dirty": AGG | BC_STAGES | WIRE,
    "draft03": D3_STAGES | WIRE,
    "mixed": D3_STAGES | AGG | WIRE,
    # generically staged windows: no unpack, and the nonces fold on the host
    "generic": BC_STAGES,
    "tools": {"primitives", "fe_bench"},
}
REPLAY_KERNELS = BC_STAGES | D3_STAGES | AGG | WIRE
STAGES = ("ed", "kes", "vrf_prep", "vrf_bc_prep", "vrf_ladders", "finish")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def bench_params():
    """bench.py's chain parameters, as the port's bench forges them."""
    from ouroboros_consensus_tpu_torch.tools import bench

    return bench.bench_params()


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
        f"native {native_s:.1f} s; each source's nvcc done at (s): "
        f"{json.dumps({k: round(v, 1) for k, v in build.BUILD_SECONDS.items()})}")
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


def packed_window(lanes: int, distinct: int, seed: int, workdir: str,
                  proof_format: str, nonce: bytes | None = None):
    """`distinct` port-forged headers (one pool, bench-shaped params, KES
    depth 7) of one body width, tiled to `lanes` lanes and packed (on the
    CPU) under the epoch nonce `nonce` (None: the neutral nonce the
    chain's first epoch has). -> (layout, packed numpy columns, the
    seeded generator)."""
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    db = os.path.join(tempfile.mkdtemp(dir=workdir), f"views_{proof_format}")
    synth.synthesize(db, params, pools, lview, distinct, proof_format=proof_format)
    hvs = db_analyser.read_header_views(db)
    # one packed window per body width: take the widest run of views
    key = max({len(h.signed_bytes) for h in hvs},
              key=lambda w: sum(len(h.signed_bytes) == w for h in hvs))
    hvs = [h for h in hvs if len(h.signed_bytes) == key]
    rng = np.random.default_rng(seed)
    pick = rng.integers(len(hvs), size=lanes)
    window = [hvs[i] for i in pick.tolist()]
    layout, packed = pbatch.stage_packed(params, lview, nonce, window)
    return layout, packed, rng


def tiled_window(lanes: int, distinct: int, seed: int, workdir: str,
                 proof_format: str):
    """packed_window's headers under the neutral nonce, unpacked and
    relaid as the stage kernels' limb-first columns (on the CPU).
    -> (limb-first columns, the seeded generator)."""
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch

    layout, packed, rng = packed_window(lanes, distinct, seed, workdir, proof_format)
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
    outputs or AssertionError; on the card both are timed with CUDA events
    (`reps` launches of the kernel; none with reps 0).
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
    if dev.type == "cuda" and reps:  # reps 0: held, not timed
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


def stage_times(dev, lanes_list=(8, 128), distinct: int = 64, seed: int = 7,
                reps: int = 5, workdir: str | None = None) -> dict:
    """Each of the six stage kernels at each width of `lanes_list` (the
    first lanes of a port-forged bc window, and of a draft-03 one for
    vrf_prep), CUDA events over `reps` launches after a warm-up. Only
    wrappers every port slice has, so `--ab` runs it on another tree's
    package too. -> {kernel: {lanes: ms}}"""
    from ouroboros_consensus_tpu_torch.device import time_ms
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    top = max(lanes_list)
    bc, _ = tiled_window(top, distinct, seed, workdir, "bc")
    d3, _ = tiled_window(top, distinct, seed + 4, workdir, "draft03")
    out: dict = {k: {} for k in STAGES}
    for n in lanes_list:
        c = [x[..., :n].contiguous().to(dev) for x in bc]
        d = [x[..., :n].contiguous().to(dev) for x in d3]
        (ed_pk, ed_r, ed_s, ed_hb, ed_hnb, kes_vk, kes_per, kes_r, kes_s,
         kes_leaf, kes_sib, kes_hb, kes_hnb, vrf_pk, vrf_g, vrf_u, vrf_v,
         vrf_s, vrf_al, beta, tlo, thi) = c
        ed = K.ed_points(ed_pk, ed_s, ed_hb, ed_hnb)
        kes = K.kes_points(kes_vk, kes_per, kes_s, kes_leaf, kes_sib, kes_hb, kes_hnb, 7)
        vok, c16, prep = K.vrf_bc_prep(vrf_pk, vrf_g, vrf_u, vrf_v, vrf_s, vrf_al)
        pts = K.vrf_ladders(c16, vrf_s, prep)
        runs = {
            "ed": lambda: K.ed_points(ed_pk, ed_s, ed_hb, ed_hnb),
            "kes": lambda: K.kes_points(kes_vk, kes_per, kes_s, kes_leaf, kes_sib,
                                        kes_hb, kes_hnb, 7),
            "vrf_prep": lambda: K.vrf_prep(d[13], d[14], d[16], d[17]),
            "vrf_bc_prep": lambda: K.vrf_bc_prep(vrf_pk, vrf_g, vrf_u, vrf_v, vrf_s, vrf_al),
            "vrf_ladders": lambda: K.vrf_ladders(c16, vrf_s, prep),
            "finish": lambda: K.finish(ed[0], ed[1], ed_r, kes[0], kes[1], kes_r, vok,
                                       pts, c16, beta, tlo, thi),
        }
        for k, fn in runs.items():
            out[k][n] = time_ms(fn, reps)
    log(f"stage ms by lanes: {json.dumps(out)}")
    return out


DRAFT03_KINDS = ("challenge", "gamma_byte", "noncanon_s", "offcurve_vk",
                 "offcurve_gamma", "wrong_alpha")


def phase_vrf_prep(dev, lanes: int = 8192, distinct: int = 256, seed: int = 11,
                   reps: int = 5, workdir: str | None = None) -> dict:
    """The draft-03 prep kernel, and the ladders over the proof's own c,
    against their plain versions on `lanes` draft-03 lanes with the
    draft-03 corrupt kinds (4 lanes each); the five draft-03 stages'
    verdict rows must fail exactly the corrupted lanes' VRF check and
    pass everything else. -> the vrf_prep record."""
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
    # the ladders on the draft-03 window too, over the proof's own c
    prep = K.vrf_prep(vrf_pk, vrf_g, vrf_s, vrf_al)[1]

    def plain_ladders():
        h, y, g = (pc.unstack(prep[40 * k: 40 * (k + 1)].to(torch.int64)) for k in range(3))
        pts = pv.vrf_core_ladders(vrf_c, vrf_s, h, y, g)
        return torch.cat([pc.stack(p) for p in pts]).to(torch.int32)

    hold("vrf_ladders (draft-03 window)", lambda: K.vrf_ladders(vrf_c, vrf_s, prep),
         plain_ladders, (vrf_c, vrf_s, prep), lanes, dev, 1)
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


def graph_ms(launch, reps: int) -> float:
    """Device time of one call of `launch(stream)` without the host's
    share of it: `reps` calls captured in one CUDA graph, the graph
    replayed once to warm up and once between CUDA events; over `reps`."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            launch(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wire_window(fmt: str, nonce, lanes: int, distinct: int, seed: int, workdir):
    """A packed window of `lanes` lanes: lanes - 5 port-forged headers of
    proof format `fmt` under the epoch nonce `nonce`, five bucket-padding
    lanes, and every testing.corrupt.WIRE_KINDS corruption.
    -> (layout, packed numpy columns, the seeded generator)"""
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.testing.corrupt import corrupt_packed

    layout, packed, rng = packed_window(lanes - 5, distinct, seed, workdir, fmt, nonce)
    return layout, corrupt_packed(layout, pbatch.pad_packed_to(packed, lanes), rng), rng


def hold_unpack(tag: str, layout, packed, n: int, dev, reps: int):
    """`unpack` on the first n lanes of a packed window, held to its plain
    version (hold). -> (the record, the uploaded columns)"""
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.testing.corrupt import first_lanes

    cols = pbatch.upload_packed(first_lanes(packed, n), dev)
    rec = hold(f"unpack ({tag}) at {n} lanes", lambda: K.unpack_limb_first(layout, cols, dev),
               lambda: K._limb_first(pbatch.unpack_packed(layout, cols, dev)),
               tuple(cols[:10]), n, dev, reps)
    return rec, cols


def hold_fold(tag: str, beta, within, n_real: int, cin, dev, reps: int) -> dict:
    """`nonce_fold` over the first n_real lanes of its input column (the
    β rows of this tree's fold, or an eta column for an older tree's)
    from the carry-in `cin`, held to its plain version (hold)."""
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    return hold(f"nonce_fold ({tag}, {n_real} of {beta.shape[-1]} lanes)",
                lambda: K.nonce_fold(beta, within, n_real, cin),
                lambda: K.nonce_fold_plain(beta, within, n_real, cin),
                (beta[:, :n_real], within[:n_real], cin), beta.shape[-1], dev, reps)


def fold_rows() -> int:
    """The rows of the fold's input column in the tree on sys.path: 64
    for a fold fed the declared VRF outputs β, 32 for one fed finish's
    eta (the wrapper's first parameter names it)."""
    import inspect

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    return 64 if next(iter(inspect.signature(K.nonce_fold).parameters)) == "beta" else 32


def seeded_fold_inputs(rng: np.random.Generator, n: int, dev, rows: int = 64):
    """A seeded byte column [rows, n] int32 (β rows, or eta rows) and
    stability flags [n] uint8."""
    import torch

    col = torch.from_numpy(rng.integers(0, 256, (rows, n)).astype(np.int32)).to(dev)
    within = torch.from_numpy((rng.random(n) < 0.7).astype(np.uint8)).to(dev)
    return col, within


def wire_records(dev, lanes_list=(8, 128, 8192), distinct: int = 256, seed: int = 13,
                 reps: int = 5, workdir: str | None = None) -> dict:
    """The two wire kernels timed at each width of `lanes_list`: `unpack`
    on the first lanes of a corrupted bc window (wire_window) under a set
    epoch nonce, `nonce_fold` over all lanes of a seeded input column
    (fold_rows: β for this tree, eta for an older one) from a set
    carry-in. Each is held to its plain version (hold: CUDA events
    around `reps` wrapper calls, `ms`), then on the card its launch alone
    is timed in a CUDA graph of 20 launches (graph_ms, `kernel_ms`: no
    host work of the wrapper). Empty for a package without them, so that
    `--ab` runs it on an older tree. -> {kernel: {lanes: record}}"""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    if not hasattr(K, "nonce_fold"):
        return {}
    from ouroboros_consensus_tpu_torch.ops.pk import build
    from ouroboros_consensus_tpu_torch.protocol import nonces

    layout, packed, rng = wire_window("bc", bytes(range(32)), max(lanes_list), distinct,
                                      seed, workdir)
    cin = torch.from_numpy(nonces.pack_carry(rng.bytes(32), rng.bytes(32))).to(dev)
    recs: dict = {"unpack": {}, "nonce_fold": {}}
    for n in lanes_list:
        unpack, cols = hold_unpack("bc, set nonce", layout, packed, n, dev, reps)
        col, within = seeded_fold_inputs(rng, n, dev, fold_rows())
        fold = hold_fold("set carry-in", col, within, n, cin, dev, reps)
        if dev.type == "cuda":
            lib_u, lib_f = build.kernel_lib("unpack"), build.kernel_lib("nonce_fold")
            unpack["kernel_ms"] = graph_ms(
                lambda st: K._unpack_launch(lib_u, st, layout, cols), 20)
            fold["kernel_ms"] = graph_ms(
                lambda st: K._nonce_fold_launch(lib_f, st, col, within, n, cin), 20)
            log(f"wire kernels alone at {n} lanes (CUDA graph): unpack "
                f"{unpack['kernel_ms']:.4f} ms, nonce_fold {fold['kernel_ms']:.4f} ms")
        recs["unpack"][n], recs["nonce_fold"][n] = unpack, fold
    return recs


def wire_times(dev, lanes_list=(8, 128, 8192), workdir: str | None = None) -> dict:
    """wire_records' kernel times, for `--ab`. -> {kernel: {lanes: ms}}"""
    recs = wire_records(dev, lanes_list, workdir=workdir)
    return {k: {n: r["kernel_ms"] for n, r in by.items()} for k, by in recs.items()}


def sass_loops(path: str, fn: str) -> dict:
    """The instructions of the longest backward-branch loop of each kernel
    whose name holds `fn`, as cuobjdump -sass shows them in the built
    library `path` (branch targets are addresses) -> {kernel name:
    {"instructions": n, "opcodes": {op: count}}}; empty when cuobjdump is
    missing."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    return sass_loops_of(text, fn)


def sass_loops_of(text: str, fn: str) -> dict:
    """sass_loops over cuobjdump's text."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        if fn not in name:
            continue
        instrs = [(int(a, 16), ins) for a, ins in
                  re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", part)]
        best = []
        for k, (addr, ins) in enumerate(instrs):
            tgt = re.search(r"BRA\s+(0x[0-9a-f]+)", ins)
            if tgt and int(tgt.group(1), 16) <= addr:
                body = [i for a, i in instrs[: k + 1] if a >= int(tgt.group(1), 16)]
                best = max(best, body, key=len)
        if best:
            ops: dict = {}
            for ins in best:
                op = (ins.split()[1] if ins.startswith("@") else ins.split()[0]).split(".")[0]
                ops[op] = ops.get(op, 0) + 1
            out[name] = {"instructions": len(best),
                         "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return out


def b2b_bench(dev, reps: int = 2048) -> dict:
    """One compression on one warp (nonce_fold.cu's instrument
    b2b_bench_kernel), each mode a chain of `reps` dependent steps timed
    in SM cycles a step (clock64) and in ms a step (a CUDA graph of 3
    launches), beside the launch alone (reps = 0). Modes: ev <-
    Blake2b-256(ev ‖ e) on one thread with the unrolled b2b_256_1
    (the etas' and the alpha's), on one thread with pk.cuh's looped
    blake2b_256 (the stage kernels' hash), on four lanes (b2b_compress4, the fold's
    chain), each held to hashlib; then the four-lane compression's 24
    dependent G steps alone on one lane, and its 24 exchanges alone (a
    chain of 64-bit shuffles). The SASS instructions of each mode's loop
    are counted (cuobjdump). -> {mode name: record, "launch_ms": ms,
    "sass": sass_loops}"""
    import hashlib

    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import build

    lib = build.kernel_lib("nonce_fold", "pk_b2b_bench")
    words = np.random.default_rng(29).integers(0, 2**63, 8, dtype=np.uint64)
    inp = torch.from_numpy(words.view(np.int64).copy()).to(dev)
    out = torch.empty(4, dtype=torch.int64, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    ev, e = words[:4].tobytes(), words[4:].tobytes()
    for _ in range(reps):
        ev = hashlib.blake2b(ev + e, digest_size=32).digest()

    def launch(st, mode, n=reps):
        rc = lib(n, mode, inp.data_ptr(), out.data_ptr(), cyc.data_ptr(), st)
        if rc != 0:
            raise RuntimeError(f"b2b_bench launch failed: cudaError {rc}")

    rec: dict = {}
    for mode, name in enumerate(("b2b_256_1", "looped_blake2b_256", "four_lane",
                                 "four_lane_g_chain", "four_lane_exchanges")):
        launch(torch.cuda.current_stream().cuda_stream, mode)
        torch.cuda.synchronize()
        if mode < 3 and out.cpu().numpy().view(np.uint64).tobytes() != ev:
            raise AssertionError(f"b2b_bench {name}: chain disagrees with hashlib")
        rec[name] = {"cycles": int(cyc.item()) / reps,
                     "ms": graph_ms(lambda st, m=mode: launch(st, m), 3) / reps}
    rec["launch_ms"] = graph_ms(lambda st: launch(st, 0, 0), 20)
    rec["sass"] = sass_loops(build.build_cuda()["nonce_fold"], "b2b_bench_kernel")
    log(f"b2b_bench (one warp, {reps} dependent steps): " + json.dumps(rec))
    return rec


def phase_wire(dev, lanes_list=(8, 128, 8192), distinct: int = 256, seed: int = 13,
               reps: int = 5, workdir: str | None = None) -> dict:
    """The two wire kernels against their plain versions on the card, at
    each width of `lanes_list`: `unpack` on corrupted bc and draft-03
    windows (wire_window) under the neutral and a set epoch nonce;
    `nonce_fold` on seeded β columns and stability flags from neutral
    and set carry-ins, over every lane and over all but the last three;
    then one compression on one thread (b2b_bench).
    The bc, set-nonce window and the set carry-in over every lane are
    wire_records' timed ones; the rest are held once. -> {unpack: rec,
    nonce_fold: rec} at the widest, with `ms` the kernel's own time
    (`wrapper_ms` the wrapper's) and the bound."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import nonces

    top = max(lanes_list)
    recs = wire_records(dev, lanes_list, distinct, seed, reps, workdir)
    for fmt, nonce in (("bc", None), ("draft03", None), ("draft03", bytes(range(32)))):
        layout, packed, _ = wire_window(fmt, nonce, top, distinct, seed, workdir)
        for n in lanes_list:
            hold_unpack(f"{fmt}, {'set' if nonce else 'neutral'} nonce", layout, packed,
                        n, dev, 1)
    rng = np.random.default_rng(seed)
    seeds = {"neutral": nonces.pack_carry(None, None),
             "set": nonces.pack_carry(rng.bytes(32), rng.bytes(32))}
    for n in lanes_list:
        beta, within = seeded_fold_inputs(rng, n, dev)
        for mode, c in seeds.items():
            cin = torch.from_numpy(c).to(dev)
            for n_real in (n, max(n - 3, 1)):
                if mode == "neutral" or n_real < n:
                    hold_fold(f"{mode} carry-in", beta, within, n_real, cin, dev, 1)
    out = {key: {**recs[key][top]} for key in ("unpack", "nonce_fold")}
    if dev.type == "cuda":
        out["nonce_fold"]["b2b_bench"] = b2b_bench(dev)
    for key, rec in out.items():
        if dev.type == "cuda":
            rec["wrapper_ms"], rec["ms"] = rec["ms"], rec["kernel_ms"]
            rec["ms_by_lanes"] = {n: r["kernel_ms"] for n, r in recs[key].items()}
            rec["wrapper_ms_by_lanes"] = {n: r["ms"] for n, r in recs[key].items()}
            # the least time: bytes over 3.35 TB/s; top dependent compressions
            # (the set carry-in: every lane hashes)
            rec["bound_ms"] = (rec["bytes"] / 3.35e12 * 1e3 if key == "unpack"
                               else K.nonce_fold_bound_ms(top))
        rec["bound_by"] = "bytes" if key == "unpack" else "operations"
    return out


# ---------------------------------------------------------------------------
# Phase 2b: the window aggregate's kernels
# ---------------------------------------------------------------------------


def torsion8():
    """A point of exact order 8 (the port's torch curve code, on the CPU):
    L·Q for the first decodable encoding Q = (b0, 0, ...) whose
    small-order part has full order."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
    from ouroboros_consensus_tpu_torch.ops.pk import field as fe
    from ouroboros_consensus_tpu_torch.ops.pk import msm as pm

    digits = fe.nibbles_msb(torch.tensor(list(fe.L.to_bytes(32, "little"))).reshape(32, 1), 32)
    for b0 in range(256):
        enc = torch.tensor([b0] + [0] * 31).reshape(32, 1)
        ok, q = pc.decompress(enc)
        if not bool(ok[0]):
            continue
        t = pc.scalar_mul_w4(digits, q)
        t4 = pc.double(pc.double(t, False), True)
        if not bool(pm.is_identity(t4)[0]):
            return t
    raise AssertionError("no order-8 point")


def add_to_encoding(col, lane: int, pt) -> None:
    """Column `col` ([32, B] int32 bytes) at `lane`: the encoding of the
    point it encodes plus `pt` (in place, on the CPU)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc

    ok, p = pc.decompress(col[:, lane: lane + 1].to(torch.int64))
    assert bool(ok[0])
    (enc,) = pc.compress_many([pc.add(p, pt)])
    col[:, lane] = enc[:, 0].to(torch.int32)


def msm_work(scalars, n_small: int) -> dict:
    """The point operations one `msm` launch does on these scalars ([N,
    32] uint8): a bucket addition per nonzero digit past each nonempty
    bucket's first, the segments' two additions a bucket, each window's
    joins (three additions a segment and six doublings), the Horner
    chain (twelve doublings and one addition a window), the B term's 32
    additions and the final one. -> {adds, dbls, entries, buckets}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import msm as pm

    s = scalars.cpu().T.to(torch.int64)
    ww = pm.signed_digit_windows(pm.WIDE_BITS)
    keys = []
    for part, bits in ((s[:, :n_small], pm.SMALL_BITS), (s[:, n_small:], pm.WIDE_BITS)):
        d = pm.recode_signed(part, bits)
        w = torch.arange(d.shape[0]).reshape(-1, 1).expand_as(d)
        keys.append((w * pm.NBUCKETS + d.abs())[d != 0])
    keys = torch.cat(keys)
    entries, buckets = keys.numel(), torch.unique(keys).numel()
    adds = (entries - buckets) + ww * pm.NSEG * pm.SEG * 2 + ww * (3 * pm.NSEG - 1) \
        + (ww - 1) + 32 + 1
    dbls = ww * 6 + (ww - 1) * 12
    return {"adds": adds, "dbls": dbls, "entries": entries, "buckets": buckets}


def hold_points(key: str, kern, plain, inputs, lanes: int, dev) -> dict:
    """`msm` against its plain version: the totals equal as points
    (compressed bytes: the bucket sums' order differs, so the projective
    limbs may) and the identity flags equal. -> hold's record, untimed."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc

    def enc(out):
        total, ident = out
        (e,) = pc.compress_many([pc.unstack(total.to(torch.int64).reshape(40, 1))])
        return e.to(torch.int32), ident

    return hold(key, lambda: enc(kern()), lambda: enc(plain()), inputs, lanes, dev, 0)


def held(key: str, kern, plain, inputs, lanes: int, dev, reps: int, points: bool = False):
    """hold (or hold_points) without its timings; then, with `reps`, the
    kernel's time over `reps` launches and the plain version's over the
    one call the comparison made (the twins of the aggregate take seconds
    a call on the card, mostly launches). -> the record."""
    import torch

    box = {}

    def plain_timed():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        box["ms"] = (time.perf_counter() - t0) * 1e3
        return out

    if points:
        rec = hold_points(key, kern, plain_timed, inputs, lanes, dev)
    else:
        rec = hold(key, kern, plain_timed, inputs, lanes, dev, 0)
    if dev.type == "cuda" and reps:
        from ouroboros_consensus_tpu_torch.device import time_ms

        rec["ms"] = time_ms(kern, reps)
        rec["plain_ms"] = box["ms"]
        log(f"kernel {key}: {rec['ms']:.4f} ms/launch, plain {rec['plain_ms']:.1f} ms "
            f"(one call)")
    return rec


def hold_agg(tag: str, cols, n: int, dev, reps: int, depth: int, msm_twin: bool = True):
    """The aggregate's kernels on one window's limb-first columns (on
    `dev`) against their plain versions: `agg_prep` and `agg_tables` byte
    for byte, the dedupe (torch) on the card against the CPU, `msm` as
    points (`msm_twin` False: not held; its plain version takes seconds
    on a tiled window's crowded buckets); with `reps`, each kernel and
    the dedupe timed. -> ({agg_prep, agg_tables[, msm]: records,
    msm_work, dedupe_ms}, aggregate_window's verdicts)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
    from ouroboros_consensus_tpu_torch.ops.pk import msm as pm

    def prep():
        return pa.agg_prep(*cols, kes_depth=depth)

    recs = {"agg_prep": held(f"agg_prep ({tag}, {n} lanes)", prep,
                             lambda: pa.agg_prep_plain(*cols, kes_depth=depth),
                             cols, n, dev, reps)}
    pts, scal, _flags, _eta, _lv = prep()

    def dedupe(dv):
        return pa.window_tables([c.to(dv) for c in cols], pts.to(dv), scal.to(dv))

    raw, tpts, _ok = dedupe(dev)
    if not all(torch.equal(a.cpu(), b) for a, b in zip((raw, tpts, _ok), dedupe("cpu"))):
        raise AssertionError(f"the dedupe of the {n}-lane {tag} window differs on the card")
    recs["agg_tables"] = held(f"agg_tables ({tag}, {n} lanes)", lambda: pa.agg_tables(raw),
                              lambda: pa.agg_tables_plain(raw), (raw,), n, dev, reps)
    points, scalars, n_small, base = pa.msm_inputs(pts, scal, tpts, pa.agg_tables(raw))
    if msm_twin:
        recs["msm"] = held(f"msm ({tag}, {n} lanes)",
                           lambda: pm.msm(points, scalars, n_small, base),
                           lambda: pm.msm_plain(points, scalars, n_small, base),
                           (points, scalars, base), n, dev, reps, points=True)
    if reps:
        recs["msm_work"] = msm_work(scalars, n_small)
        if dev.type == "cuda":
            from ouroboros_consensus_tpu_torch.device import time_ms

            recs["dedupe_ms"] = time_ms(lambda: dedupe(dev), reps)
    return recs, pa.aggregate_window(*cols, kes_depth=depth)


def agg_matches_stages(tag: str, av, cols, depth: int) -> None:
    """A clean window's aggregate: the identity (agg_ok), and flags, eta
    and leader value equal to the five stage kernels' on the same
    columns."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    f, e, lv = K.verify_praos_tiles_bc(*cols, kes_depth=depth)
    if not (bool(av.agg_ok) and torch.equal(av.flags, f) and torch.equal(av.eta, e)
            and torch.equal(av.leader_value, lv)):
        raise AssertionError(f"the {tag} window's aggregate is not the identity or its "
                             "verdicts differ from the stage kernels'")


def phase_agg(dev, lanes_list=(8, 128, 8192), distinct: int = 256, seed: int = 17,
              reps: int = 5, workdir: str | None = None) -> dict:
    """The window aggregate's three kernels against their plain versions
    on the card, at each width of `lanes_list` (the first lanes of a
    tiled bc window; `hold_agg`), clean and on a copy with a
    torsion-offset R_k, an OCert s flipped and a wrong β in three lanes
    (at the widest, msm is not held on that copy); the dedupe's cap 2 on
    a key column of three groups. The whole aggregate_window: the
    identity on the clean window (agg_ok, flags, eta and leader value
    equal to the five stage kernels'), not on the dirty one (agg_ok
    false; the cheap checks flag the β lane). Each kernel is timed on
    the clean window at each width. -> {agg_prep, agg_tables, msm:
    records at the widest; dedupe_ms}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa

    depth = 7
    top = max(lanes_list)
    clean, _ = tiled_window(top, distinct, seed, workdir, "bc")
    dirty = [c.clone() for c in clean]
    add_to_encoding(dirty[7], 3, torsion8())  # R_k + T8
    dirty[2][0, 5] ^= 1  # an OCert s
    dirty[19][0, 6] ^= 1  # a declared β
    recs: dict = {"agg_prep": {}, "agg_tables": {}, "msm": {}, "dedupe_ms": {}}
    for n in lanes_list:
        for tag, src in (("clean", clean), ("dirty", dirty)):
            cols = [c[..., :n].contiguous().to(dev) for c in src]
            got, av = hold_agg(tag, cols, n, dev, reps if tag == "clean" else 0, depth,
                               msm_twin=tag == "clean" or n < top)
            if tag == "clean":
                agg_matches_stages(f"clean {n}-lane", av, cols, depth)
                got["msm"]["work"] = got["msm_work"]
                for key in ("agg_prep", "agg_tables", "msm"):
                    recs[key][n] = got[key]
                if "dedupe_ms" in got:
                    recs["dedupe_ms"][n] = got["dedupe_ms"]
            elif bool(av.agg_ok) or n > 6 and int(av.flags[2, 6]) != 0:
                raise AssertionError(f"the dirty {n}-lane window's aggregate passed")
    # the dedupe's cap: three groups in two slots overflow
    key = clean[13][:, :12].clone()
    key[0, 4:8] ^= 1
    key[31, 8:] ^= 2
    coeff = torch.arange(12 * 32, dtype=torch.int64).reshape(12, 32).remainder(251).to(torch.uint8)
    ptsk = torch.arange(12 * 40, dtype=torch.int32).reshape(12, 40)
    got = pa.dedupe_column(key.to(dev), coeff.to(dev), ptsk.to(dev), cap=2)
    want = pa.dedupe_column(key, coeff, ptsk, cap=2)
    if bool(got[2]) or not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise AssertionError("the dedupe's cap-2 overflow differs on the card")
    log(f"aggregate: dedupe ms by lanes {json.dumps(recs['dedupe_ms'])}; cap-2 overflow "
        "equal on the card")
    out = {}
    for key in ("agg_prep", "agg_tables", "msm"):
        out[key] = {**recs[key][top]}
        if dev.type == "cuda":
            out[key]["ms_by_lanes"] = {n: r["ms"] for n, r in recs[key].items()}
    one = [c[..., :1].clone() for c in clean]
    out["agg_prep"]["field_ops"] = count_field_ops(
        lambda: pa.agg_prep_plain(*one, kes_depth=depth))
    w = out["msm"]["work"]
    out["msm"]["products"] = w["adds"] * 900 + w["dbls"] * 620
    out["dedupe_ms"] = recs["dedupe_ms"]
    return out


def chain_window(db: str, lanes: int):
    """The first `lanes` consecutive headers of one body width in the
    forged chain's first epoch (a full window as the replay cuts it:
    distinct R_k, U, V, Γ and H in every lane, the OCert and KES keys
    repeated), staged packed under that epoch's neutral nonce, unpacked
    and relaid as limb-first columns (on the CPU)."""
    from ouroboros_consensus_tpu_torch.block.praos_block import Block
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB
    from ouroboros_consensus_tpu_torch.testing import synth

    params = bench_params()
    lview = synth.make_ledger_view([synth.make_pool(0, kes_depth=params.kes_depth)])
    run: list = []
    imm = ImmutableDB(os.path.join(db, "immutable"))
    for blk in imm.stream_validated(Block.from_bytes, Block.check_integrity):
        hv = blk.header.to_view()
        if hv.slot >= params.epoch_length:
            break
        if run and len(hv.signed_bytes) != len(run[0].signed_bytes):
            run = []  # a CBOR width step: the replay cuts the window here
        run.append(hv)
        if len(run) == lanes:
            break
    if len(run) < lanes:
        raise AssertionError(f"no run of {lanes} headers of one width in the first epoch")
    layout, packed = pbatch.stage_packed(params, lview, None, run)
    return list(K.staged_to_limb_first_bc(*pbatch.unpack_packed(layout, packed, "cpu")))


def phase_agg_chain(dev, db: str, stages: dict, lanes: int = 8192, reps: int = 5) -> None:
    """The aggregate's kernels on a full window of the forged bc chain
    (`chain_window`), the bucket shape the replay gives msm (about ten
    entries a bucket, where the tiled window crowds 32 copies of each
    scalar into few): held against their plain versions and timed
    (`hold_agg`), and the window's aggregate the identity with the stage
    kernels' verdicts. The records replace phase_agg's in `stages` (the
    kernels line's ms and bound are this window's); phase_agg's stay
    beside them under `tiled`."""
    cols = [c.contiguous().to(dev) for c in chain_window(db, lanes)]
    depth = bench_params().kes_depth
    got, av = hold_agg("chain window", cols, lanes, dev, reps, depth)
    agg_matches_stages(f"chain {lanes}-lane", av, cols, depth)
    got["msm"]["work"] = got["msm_work"]
    for key in ("agg_prep", "agg_tables", "msm"):
        tiled = stages[key]
        rec = got[key]
        rec["tiled"] = {k: tiled[k] for k in ("ms", "plain_ms", "lanes", "bytes", "work",
                                              "products") if k in tiled}
        rec["ms_by_lanes"] = tiled.get("ms_by_lanes")  # the tiled windows'
        if "field_ops" in tiled:
            rec["field_ops"] = tiled["field_ops"]
        stages[key] = rec
    w = stages["msm"]["work"]
    stages["msm"]["products"] = w["adds"] * 900 + w["dbls"] * 620
    if "dedupe_ms" in got:
        stages["dedupe_ms"]["chain"] = got["dedupe_ms"]
    log(f"aggregate on a {lanes}-lane chain window: msm work {json.dumps(w)} "
        f"(tiled {json.dumps(stages['msm']['tiled'].get('work'))})")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def forge_chain(db: str, headers: int, proof_format: str, switch: int) -> None:
    """Forge one main-path chain at `db` with bench.py's parameters (one
    pool, made from seed 0 as every phase makes it): `proof_format`'s
    proofs, or with `switch` > 0 draft-03 proofs below block `switch` and
    batch-compatible ones from there. Runs in a worker process."""
    from ouroboros_consensus_tpu_torch.testing import synth

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    fmt = (lambda k: 80 if k < switch else 128) if switch else proof_format
    t0 = time.monotonic()
    synth.synthesize(db, params, pools, synth.make_ledger_view(pools), headers,
                     proof_format=fmt)
    log(f"forged {headers} headers at {os.path.basename(db)} in "
        f"{time.monotonic() - t0:.1f} s (worker process)")


class Forges:
    """The main paths' four chains (bc and draft-03 of `headers` headers,
    the mixed chain and the stand-in-body chain of an eighth as many),
    each forged in a process of its own (spawned: the parent holds a CUDA
    context) while phase 2 runs; `get` waits for one, `close` stops any
    still running."""

    def __init__(self, workdir: str, headers: int):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        small = headers // 8
        self.jobs = {}
        for tag, n, fmt, switch in (("bc", headers, "bc", 0), ("draft03", headers, "draft03", 0),
                                    ("mixed", small, "bc", small // 2),
                                    ("generic", small, "bc", 0)):
            db = os.path.join(workdir, f"chain_{tag}")
            proc = ctx.Process(target=forge_chain, args=(db, n, fmt, switch), daemon=True)
            proc.start()
            self.jobs[tag] = (db, n, proc)

    def get(self, tag: str) -> tuple[str, int]:
        """-> (the chain's directory, its headers), once forged."""
        db, n, proc = self.jobs[tag]
        proc.join()
        if proc.exitcode != 0:
            raise RuntimeError(f"forging the {tag} chain failed: exit code {proc.exitcode}")
        return db, n

    def close(self) -> None:
        for _db, _n, proc in self.jobs.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()


def compare(tag: str, dres, nres) -> None:
    """Device and native replays (revalidate's or validate_chain's
    results) agree on n_valid, error and final state."""
    from ouroboros_consensus_tpu_torch import carry

    def state(r):
        return carry.state_to_plain(getattr(r, "final_state", None) or r.state)

    same = (dres.n_valid == nres.n_valid
            and carry.error_to_plain(dres.error) == carry.error_to_plain(nres.error)
            and state(dres) == state(nres))
    if not same:
        raise AssertionError(
            f"{tag}: device ({dres.n_valid}, {dres.error!r}) != native "
            f"({nres.n_valid}, {nres.error!r}) or final states differ")
    log(f"{tag}: device == native: n_valid {dres.n_valid}, "
        f"error {carry.error_to_plain(dres.error)}")


STAGE_WRAPPERS = ("ed_points", "kes_points", "vrf_prep", "vrf_bc_prep", "vrf_ladders", "finish",
                  "unpack_limb_first", "nonce_fold")
AGG_WRAPPERS = (("aggregate", "agg_prep"), ("aggregate", "agg_tables"), ("msm", "msm"))


def replay_path(tag: str, db: str, params, lview, max_batch: int, dev,
                columnar: bool = True, native=None, aggregate: bool = True) -> dict:
    """One main path: the device replay (`columnar` or on HeaderView
    lists; `aggregate` revalidate's) with the launch counts, the sidecar
    counters and AGG_REDISPATCH zeroed just before it and read just
    after (CUDA events around each stage and aggregate wrapper, and the
    windows it cut), then the native replay, which must agree (`native`:
    its result, when already run). A columnar replay must read every
    chunk through its sidecar (the forge sealed them all)."""
    import importlib

    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.storage import sidecar
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    events: dict = {}
    streams: dict = {}
    lanes: list = []
    windows: list = []
    saved = [(K, name, getattr(K, name)) for name in STAGE_WRAPPERS]
    for mod, name in AGG_WRAPPERS:
        m = importlib.import_module(f"ouroboros_consensus_tpu_torch.ops.pk.{mod}")
        saved.append((m, name, getattr(m, name)))
    saved.append((pbatch, "prepare_window", pbatch.prepare_window))

    def timed(*args, _fn, _name, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = _fn(*args, **kw)
        b.record()
        events.setdefault(_name, []).append((a, b))
        streams.setdefault(_name, set()).add(torch.cuda.current_stream().cuda_stream)
        if _name in ("ed_points", "agg_prep"):
            lanes.append((_name, res[0].shape[-1] if _name == "ed_points" else res[0].shape[1]))
        return res

    def window(params_, lview_, eta0, hvs, *args, _fn=pbatch.prepare_window, **kw):
        # on the staging thread, one window at a time in window order
        windows.append((len(hvs), len(hvs[0].vrf_proof),
                        "cols" if isinstance(hvs, pbatch.ViewColumns) else "list"))
        return _fn(params_, lview_, eta0, hvs, *args, **kw)

    if dev.type == "cuda":
        for mod, name, fn in saved[:-1]:
            setattr(mod, name, lambda *a, _fn=fn, _name=name, **kw: timed(
                *a, _fn=_fn, _name=_name, **kw))
    pbatch.prepare_window = window
    try:
        K.reset_launches()
        sidecar.reset_counters()
        pbatch.AGG_REDISPATCH = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dres = db_analyser.revalidate(db, params, lview, backend="device",
                                      max_batch=max_batch, device=dev, columnar=columnar,
                                      aggregate=aggregate)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        counts = sidecar.counters()
        redispatched = pbatch.AGG_REDISPATCH
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    chunks = chunk_count(db)
    if columnar and counts != {**dict.fromkeys(counts, 0), "hit": chunks}:
        raise AssertionError(f"{tag}: not every one of the {chunks} chunks read "
                             f"through its sidecar: {counts}")
    out = {
        "launches": launches,
        "stage_device_ms": {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()},
        "lanes_per_launch": lanes,
        "windows": windows,
        "sidecar": counts,
        "aggregate": aggregate,
        "agg_redispatch": redispatched,
    }
    if dev.type == "cuda" and launches["nonce_fold"]:
        # the fold on a stream of its own, the stage and aggregate kernels on another
        staged = set().union(*(streams.get(k, set()) for k in
                               (*STAGE_WRAPPERS[:6], *(n for _m, n in AGG_WRAPPERS))))
        if streams["nonce_fold"] & staged or len(streams["nonce_fold"]) != 1:
            raise AssertionError(f"{tag}: nonce_fold streams {streams['nonce_fold']} "
                                 f"against the stages' {staged}")
        out["fold_stream_apart"] = True
    log(f"{tag}: launches {json.dumps(launches)}; sidecar {json.dumps(counts)}; "
        f"aggregate {aggregate}, windows re-dispatched {redispatched}")
    log(f"{tag}: device time per stage (ms): {json.dumps(out['stage_device_ms'])}")
    log(f"{tag}: windows (headers, proof bytes, form): {windows}")
    nres = native or db_analyser.revalidate(db, params, lview, backend="native",
                                            max_batch=max_batch)
    compare(f"{tag} chain", dres, nres)
    n = dres.n_valid
    out.update(n_valid=n, error=type(dres.error).__name__ if dres.error else None,
               device_hps=n / dres.validate_s, native_hps=n / nres.validate_s,
               device_wall_hps=n / dres.wall_s, native_wall_hps=n / nres.wall_s,
               device_validate_s=dres.validate_s, native_validate_s=nres.validate_s,
               device_wall_s=dres.wall_s, native_wall_s=nres.wall_s,
               device_read_s=dres.read_s, device_wait_s=dres.wait_s,
               result=dres, native=nres)
    log(f"{tag}: headers/s over validate_s: device {out['device_hps']:.1f} "
        f"({dres.validate_s:.4f} s), native {out['native_hps']:.1f} "
        f"({nres.validate_s:.4f} s); over wall_s: device {out['device_wall_hps']:.1f} "
        f"({dres.wall_s:.4f} s), native {out['native_wall_hps']:.1f} ({nres.wall_s:.4f} s); "
        f"device read_s {dres.read_s:.4f} (overlapped), wait_s {dres.wait_s:.4f}")
    return out


def chunk_count(db: str) -> int:
    from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB

    return len(list(ImmutableDB(os.path.join(db, "immutable")).chunk_entries()))


def same_replay(a, b) -> bool:
    """Two revalidate results with the same storage prefix, n_valid, error
    and final state."""
    from ouroboros_consensus_tpu_torch import carry

    def key(r):
        return (r.n_blocks, r.n_valid, carry.error_to_plain(r.error),
                carry.state_to_plain(r.final_state))

    return key(a) == key(b)


def corrupted_replay(tag: str, db: str, headers: int, field: str, expect: str,
                     params, lview, max_batch: int, dev, pool=None,
                     at: float = 2 / 3) -> dict:
    """Copy the chain, flip one byte of `field` in the header a fraction
    `at` of the way in (KES-signing the header again when `pool` is
    given), and require both backends to stop there with `expect`.
    -> the device replay's launches and re-dispatched windows."""
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.testing import corrupt
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    bad = f"{db}_bad_{field}"
    shutil.copytree(db, bad)
    target = int(headers * at)
    corrupt.flip_header_byte(bad, target, field, params=params if pool else None, pool=pool)
    K.reset_launches()
    pbatch.AGG_REDISPATCH = 0
    dres = db_analyser.revalidate(bad, params, lview, backend="device",
                                  max_batch=max_batch, device=dev)
    out = {"launches": dict(K.LAUNCHES), "agg_redispatch": pbatch.AGG_REDISPATCH}
    nres = db_analyser.revalidate(bad, params, lview, backend="native", max_batch=max_batch)
    compare(f"{tag} chain, {field} byte flipped", dres, nres)
    if dres.n_valid != target or type(dres.error).__name__ != expect:
        raise AssertionError(f"{tag} corrupted chain: expected {expect} at {target}, "
                             f"got {dres.n_valid} {dres.error!r}")
    shutil.rmtree(bad, ignore_errors=True)
    log(f"{tag} chain, {field} byte flipped at {target}: windows re-dispatched "
        f"{out['agg_redispatch']}")
    return out


LAYERS = (  # (module, function, layer) timed by layer_breakdown
    ("batch", "host_prechecks", "host_prechecks"), ("batch", "stage_packed", "stage_packed"),
    ("batch", "host_prechecks_columns", "host_prechecks_columns"),
    ("batch", "stage_packed_columns", "stage_packed_columns"),
    ("batch", "staging_buffer", "pin_alloc"), ("batch", "pad_packed_into", "pad_packed_into"),
    ("batch", "upload_staged", "h2d"),
    ("K", "unpack_limb_first", "unpack"), ("K", "_tiles", "stages"),
    ("pa", "agg_prep", "agg_prep"), ("pa", "dedupe_columns", "dedupe"),
    ("pa", "agg_tables", "agg_tables"), ("pm", "msm", "msm"),
    ("batch", "verdict_reduce", "reduce"), ("batch", "dispatch_window", "device_step"),
    ("batch", "materialize", "redispatch"), ("batch", "epilogue", "epilogue"),
)
STEP_PARTS = ("stage_packed", "stage_packed_columns", "pin_alloc", "pad_packed_into", "h2d",
              "unpack", "stages", "agg_prep", "dedupe", "agg_tables", "msm", "reduce")


def layer_breakdown(db: str, params, lview, max_batch: int, dev,
                    aggregate: bool = True) -> dict:
    """Host wall per layer of one more device replay, serial
    (`pipeline_depth=1`, `prefetch=False`: a layer's timer synchronises,
    which would serialise the pipeline anyway), each layer's work on the
    current stream synchronised (that stream alone, so that the fold's
    side stream keeps running beside the stages; which is why this is not
    the timed replay): the host stages, and the packed device step
    (`dispatch_window`) split into the pinned staging buffer's
    allocation, the padding into it, the H2D of the packed columns, the
    unpack kernel, the five stage kernels, the reduce (mask words and the
    wait for the fold) and the D2H of the words and the carry (the step's
    rest, with `stage_packed` taken out). The fold itself is read by an
    event pair on its side stream around each launch (`fold_side`): it
    overlaps the stages, so it is not one of the step's parts, which still
    sum to the step's wall. The columnar host stages are their own layers
    (`host_prechecks` is then the dispatching wrapper's own time, without
    `host_prechecks_columns`), and `read` is the replay's read_s (the
    chunk reads, checks and pieces, inline)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
    from ouroboros_consensus_tpu_torch.ops.pk import msm as pm

    spent: dict = {}
    saved = []
    mods = {"batch": pbatch, "K": K, "pa": pa, "pm": pm}

    def sync():
        if dev.type == "cuda":
            torch.cuda.current_stream().synchronize()

    for mod, name, layer in ((mods[m], n, y) for m, n, y in LAYERS):
        fn = getattr(mod, name)

        def wrapper(*args, _fn=fn, _name=layer, **kw):
            sync()
            t0 = time.perf_counter()
            res = _fn(*args, **kw)
            sync()
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t0
            return res

        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)
    folds = []
    if dev.type == "cuda":
        fold = K.nonce_fold

        def fold_events(*args, _fn=fold, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res = _fn(*args, **kw)
            b.record()
            folds.append((a, b))
            return res

        saved.append((K, "nonce_fold", fold))
        K.nonce_fold = fold_events
    try:
        res = db_analyser.revalidate(db, params, lview, backend="device",
                                     max_batch=max_batch, device=dev, prefetch=False,
                                     pipeline_depth=1, aggregate=aggregate)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    step = spent.pop("device_step")
    spent["d2h"] = step - sum(spent.get(k, 0.0) for k in STEP_PARTS)
    if "host_prechecks_columns" in spent:  # nested in host_prechecks
        spent["host_prechecks"] -= spent["host_prechecks_columns"]
    spent["other"] = res.validate_s - step - sum(spent.get(k, 0.0) for k in (
        "host_prechecks", "host_prechecks_columns", "redispatch", "epilogue"))
    spent["validate_s"] = res.validate_s
    spent["read"] = res.read_s
    spent["device_step"] = step
    spent["fold_side"] = sum(a.elapsed_time(b) for a, b in folds) / 1e3
    return spent


def read_breakdown(db: str, params, lview, dev, use_sidecar: bool) -> dict:
    """Host wall per part of the read of one more device replay, inline
    (`prefetch=False`, `pipeline_depth=1`, so that the reader has the
    host to itself): the open's index parse (`index_load`), the file
    reads; on the sidecar's hit path the probe
    (`load_sidecar`: the map and the seals) with its chunk and payload
    CRCs, the body-hash sweep (`native.blake2b_spans`) and `pieces`; on
    the scan path (`use_sidecar=False`) the CRC sweep, the two header
    scans (`extract_headers`: the integrity check's and the pieces') and
    the pieces; the epoch merge (`ViewColumns.concat`) on both; `other`
    is the rest of the replay's read_s."""
    from ouroboros_consensus_tpu_torch import native, native_scan
    from ouroboros_consensus_tpu_torch.protocol.views import ViewColumns
    from ouroboros_consensus_tpu_torch.storage import immutable, sidecar
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    spent: dict = {}
    crcs = [0]  # load_sidecar's CRC calls: the chunk's, then the payload's
    targets = [
        (immutable.ImmutableDB, "_load", "index_load"),
        (immutable.ImmutableDB, "read_chunk", "file_read"), (sidecar, "load_sidecar", "probe"),
        (sidecar, "_crc32", None), (native, "blake2b_spans", "body_hash_sweep"),
        (sidecar.SidecarColumns, "pieces", "pieces"),
        (native_scan, "crc32_first_bad", "crc_sweep"),
        (native_scan, "extract_headers", "header_scans"),
        (ViewColumns, "pieces_from_header_columns", "pieces"),
        (ViewColumns, "concat", "epoch_merge"),
    ]
    saved = []
    for owner, name, part in targets:
        fn = owner.__dict__[name]
        saved.append((owner, name, fn))
        call = fn.__func__ if isinstance(fn, (classmethod, staticmethod)) else fn

        def wrapper(*args, _fn=call, _part=part, **kw):
            if _part is None:
                _part = ("chunk_crc", "payload_crc")[min(crcs[0], 1)]
                crcs[0] += 1
            elif _part == "probe":
                crcs[0] = 0
            t0 = time.perf_counter()
            res = _fn(*args, **kw)
            spent[_part] = spent.get(_part, 0.0) + time.perf_counter() - t0
            return res

        if isinstance(fn, classmethod):
            wrapped = classmethod(lambda cls, *a, _w=wrapper, **kw: _w(cls, *a, **kw))
        elif isinstance(fn, staticmethod):
            wrapped = staticmethod(wrapper)
        else:
            wrapped = wrapper
        setattr(owner, name, wrapped)
    try:
        sidecar.reset_counters()
        res = db_analyser.revalidate(db, params, lview, backend="device", max_batch=8192,
                                     device=dev, sidecar=use_sidecar, prefetch=False,
                                     pipeline_depth=1)
        counts = sidecar.counters()
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    if use_sidecar:
        spent["probe"] -= spent.get("chunk_crc", 0.0) + spent.get("payload_crc", 0.0)
    spent["other"] = res.read_s - sum(spent.values())
    spent["read_s"] = res.read_s
    spent["sidecar"] = counts
    return spent


def overlap_turns(db: str, params, lview, dev, pairs: int = 5) -> dict:
    """The replay with its overlap (the defaults: prefetch, pipeline_depth
    3) and without (`prefetch=False`, `pipeline_depth=1`), in turns
    (default, serial, serial, default, ...), each with the time the
    garbage collector paused it (`gc_s`), the part of that in full
    (generation 2) collections (`gc2_s`) and their count (`gc2_n`): ->
    each side's runs and minimum wall."""
    import gc

    import torch

    from ouroboros_consensus_tpu_torch.tools import db_analyser

    pauses = []  # (generation, seconds)

    def on_gc(phase, info, _t=[0.0]):
        if phase == "start":
            _t[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - _t[0]))

    sides = {"overlap": {}, "serial": {"prefetch": False, "pipeline_depth": 1}}
    order = [("overlap", "serial")[(k + k // 2) % 2] for k in range(2 * pairs)]
    runs: dict = {k: [] for k in sides}
    gc.callbacks.append(on_gc)
    try:
        for side in order:
            pauses.clear()
            torch.cuda.synchronize()
            r = db_analyser.revalidate(db, params, lview, backend="device", device=dev,
                                       **sides[side])
            torch.cuda.synchronize()
            full = [t for g, t in pauses if g == 2]
            runs[side].append({"wall_s": r.wall_s, "validate_s": r.validate_s,
                               "read_s": r.read_s, "wait_s": r.wait_s,
                               "gc_s": sum(t for _g, t in pauses), "gc2_s": sum(full),
                               "gc2_n": len(full)})
    finally:
        gc.callbacks.remove(on_gc)
    return {side: {"runs": rs, "min_wall_s": min(x["wall_s"] for x in rs)}
            for side, rs in runs.items()}


def pipeline_timeline(db: str, params, lview, dev) -> dict:
    """One default replay's timeline (ms from its start): the open, each
    validate_chain call (one an epoch segment of one width), each window's
    staging (on the staging thread), launch and retire (on the caller's),
    and its device interval (CUDA events: from the stream reaching the
    launch to the read-back's end; the fold's side stream is inside it);
    -> the segments, the windows, and the card's busy share of the wall
    (the union of the device intervals)."""
    import torch

    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    t0 = [0.0]

    def now():
        return (time.perf_counter() - t0[0]) * 1e3

    stage, launch, retire, segments, opened = {}, [], {}, [], []
    prep, disp, epi = pbatch.prepare_window, pbatch.dispatch_prepared, pbatch.epilogue
    chain, imm_init = pbatch.validate_chain, ImmutableDB.__init__
    ref = torch.cuda.Event(enable_timing=True)

    def p_prep(*args, **kw):
        a = now()
        sw = prep(*args, **kw)
        stage[id(sw.hvs)] = (a, now())
        return sw

    def p_disp(sw, device, carry=None):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        a = now()
        v = disp(sw, device, carry)
        b = now()
        e1.record()
        launch.append((sw.b, stage.get(id(sw.hvs)), a, b, e0, e1, id(sw.hvs)))
        return v

    def p_epi(params_, ticked, hvs, pre, v):
        a = now()
        res = epi(params_, ticked, hvs, pre, v)
        retire[id(hvs)] = (a, now())
        return res

    def p_chain(params_, lv, state, hvs, *args, **kw):
        a = now()
        res = chain(params_, lv, state, hvs, *args, **kw)
        segments.append((len(hvs), round(a, 3), round(now(), 3)))
        return res

    def p_open(self, *args, **kw):
        a = now()
        imm_init(self, *args, **kw)
        opened.append((round(a, 3), round(now(), 3)))

    saved = [(pbatch, "prepare_window", prep), (pbatch, "dispatch_prepared", disp),
             (pbatch, "epilogue", epi), (pbatch, "validate_chain", chain),
             (ImmutableDB, "__init__", imm_init)]
    pbatch.prepare_window, pbatch.dispatch_prepared, pbatch.epilogue = p_prep, p_disp, p_epi
    pbatch.validate_chain, ImmutableDB.__init__ = p_chain, p_open
    try:
        torch.cuda.synchronize()
        ref.record()
        torch.cuda.synchronize()
        t0[0] = time.perf_counter()
        res = db_analyser.revalidate(db, params, lview, backend="device", device=dev)
        torch.cuda.synchronize()
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    windows, busy = [], []
    for b, st, a, bb, e0, e1, key in launch:
        d = (ref.elapsed_time(e0), ref.elapsed_time(e1))
        busy.append(d)
        windows.append({"lanes": b, "stage": [round(x, 3) for x in st] if st else None,
                        "launch": [round(a, 3), round(bb, 3)],
                        "device": [round(x, 3) for x in d],
                        "retire": [round(x, 3) for x in retire.get(key, ())]})
    union, end = 0.0, -1.0
    for a, b in sorted(busy):
        a = max(a, end)
        if b > a:
            union += b - a
            end = b
    wall_ms = res.wall_s * 1e3
    return {"open": opened, "segments": segments, "windows": windows,
            "wall_ms": wall_ms, "device_busy_ms": union, "device_busy_share": union / wall_ms,
            "read_s": res.read_s, "wait_s": res.wait_s, "validate_s": res.validate_s}


def sidecar_checks(tag: str, db: str, params, lview, max_batch: int, dev, cols) -> dict:
    """On the bc chain, beside its timed replay `cols` (a sidecar hit on
    every chunk): the scan path (`sidecar=False`) gives the same verdicts;
    the serial loop (`pipeline_depth=1`, `prefetch=False`) gives the same
    as the pipeline; a copy whose first chunk's seal is stale (a payload
    byte flipped) and whose second chunk's is torn (cut short) falls back
    to the scan on those two, device == native; and the read's parts on
    both paths (`read_breakdown`)."""
    from ouroboros_consensus_tpu_torch.storage import sidecar
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    def replay(path, backend="device", **kw):
        sidecar.reset_counters()
        r = db_analyser.revalidate(path, params, lview, backend=backend, max_batch=max_batch,
                                   device=dev if backend == "device" else None, **kw)
        return r, {k: v for k, v in sidecar.counters().items() if v}

    scan, counts = replay(db, sidecar=False)
    if not same_replay(scan, cols) or counts:
        raise AssertionError(f"{tag}: the scan path differs from the sidecar's ({counts})")
    serial, _ = replay(db, pipeline_depth=1, prefetch=False)
    if not same_replay(serial, cols):
        raise AssertionError(f"{tag}: pipeline_depth 1 differs from 3")
    log(f"{tag}: sidecar == scan path, pipeline_depth 3 == 1: n_blocks {cols.n_blocks}, "
        f"n_valid {cols.n_valid}; walls: sidecar {cols.wall_s:.4f} s, scan "
        f"{scan.wall_s:.4f} s, serial {serial.wall_s:.4f} s")
    spoiled = db + "_spoiled"
    shutil.copytree(db, spoiled)
    chunks = chunk_count(db)
    try:  # the first chunk's seal stale, the last's torn
        for n, torn in {0: False, chunks - 1: True}.items():
            p = os.path.join(spoiled, "immutable", sidecar.sidecar_name(n))
            raw = bytearray(open(p, "rb").read())
            if torn:
                raw = raw[: sidecar.HEADER_SIZE + 3]
            else:
                raw[sidecar.HEADER_SIZE + 9] ^= 0x01
            with open(p, "wb") as f:
                f.write(bytes(raw))
        dres, dcounts = replay(spoiled)
        nres, _ = replay(spoiled, "native")
    finally:
        shutil.rmtree(spoiled, ignore_errors=True)
    compare(f"{tag} chain, a stale and a torn seal", dres, nres)
    want = {"hit": chunks - 2, "stale": 1, "torn": 1} if chunks > 1 else {"torn": 1}
    if dcounts != want or not same_replay(dres, cols):
        raise AssertionError(f"{tag}: stale and torn seals: {dcounts} (want {want})")
    log(f"{tag}: a stale and a torn seal fall back to the scan: {json.dumps(dcounts)}")
    parts = {"hit": read_breakdown(db, params, lview, dev, True),
             "scan": read_breakdown(db, params, lview, dev, False)}
    log(f"{tag}: the read's parts, inline (s): {json.dumps(parts)}")
    out = {"scan_wall_s": scan.wall_s, "serial_wall_s": serial.wall_s,
           "spoiled": dcounts, "read_parts": parts}
    if dev.type == "cuda":
        out["overlap"] = overlap_turns(db, params, lview, dev)
        log(f"{tag}: with and without the overlap, in turns: {json.dumps(out['overlap'])}")
        out["timeline"] = pipeline_timeline(db, params, lview, dev)
        log(f"{tag}: one default replay's timeline (ms): {json.dumps(out['timeline'])}")
    return out


def phase_main(dev, forges: Forges, max_batch: int) -> dict:
    """The three main paths (bc, draft03, mixed) on the chains `forges`
    makes; -> {path: replay_path's dict, with the layer split for the two
    single-format chains}."""
    from ouroboros_consensus_tpu_torch import carry
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import bench as port_bench

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    paths = {}
    for tag in ("bc", "draft03", "mixed"):
        t0 = time.monotonic()
        db, n = forges.get(tag)
        switch = n // 2
        log(f"{tag}: {n} headers forged; waited {time.monotonic() - t0:.1f} s for them")
        out = replay_path(tag, db, params, lview, max_batch, dev)
        if out["error"] is not None or out["n_valid"] != n:
            raise AssertionError(f"{tag} chain did not validate: {out['n_valid']}/{n}")
        if out["agg_redispatch"]:
            raise AssertionError(f"{tag}: {out['agg_redispatch']} clean windows re-dispatched")
        if tag == "mixed":
            starts = np.cumsum([0] + [w for w, *_ in out["windows"]])
            cut = int(np.searchsorted(starts, switch))
            if starts[cut] != switch or out["windows"][cut][1] != 128 \
                    or out["windows"][cut - 1][1] != 80:
                raise AssertionError(f"mixed chain: no window cut at block {switch}")
            log(f"mixed: windows cut at the format switch (block {switch}): "
                f"{out['windows'][cut - 1]} | {out['windows'][cut]}")
        else:
            out["layers_s"] = layer_breakdown(db, params, lview, max_batch, dev)
            log(f"{tag}: host wall per layer, one more device replay (s; fold_side, "
                f"the fold's own time on its stream, overlaps the stages and is not "
                f"one of device_step's parts): {json.dumps(out['layers_s'])}")
        if tag == "bc":
            out["layers_s_lanes"] = layer_breakdown(db, params, lview, max_batch, dev,
                                                    aggregate=False)
            log(f"bc, aggregate off: host wall per layer, one more device replay (s): "
                f"{json.dumps(out['layers_s_lanes'])}")
        if tag == "bc":
            listed = replay_path("bc list", db, params, lview, max_batch, dev,
                                 columnar=False, native=out["native"])
            cols, lst = out["result"], listed["result"]
            if (cols.n_blocks, cols.n_valid, carry.error_to_plain(cols.error),
                    carry.state_to_plain(cols.final_state)) != (
                    lst.n_blocks, lst.n_valid, carry.error_to_plain(lst.error),
                    carry.state_to_plain(lst.final_state)):
                raise AssertionError("bc chain: the columnar replay differs from the list one")
            log("bc: columnar == list: n_blocks, n_valid, error and final state")
            out["list"] = {k: v for k, v in listed.items() if k not in ("result", "native")}
            out["sidecar_checks"] = sidecar_checks(tag, db, params, lview, max_batch, dev, cols)
            lanes = replay_path("bc lanes", db, params, lview, max_batch, dev,
                                native=out["native"], aggregate=False)
            paths["bc_lanes"] = {k: v for k, v in lanes.items() if k not in ("result", "native")}
            # one corrupted copy a kind through the aggregate: each dirty
            # window is re-dispatched to the per-lane stages
            dirty = [corrupted_replay(tag, db, n, field, expect, params, lview, max_batch,
                                      dev, pool=pool, at=at)
                     for field, expect, pool, at in (
                         ("kes_sig", "InvalidKesSignatureOCERT", None, 2 / 3),
                         ("ocert_sigma", "InvalidSignatureOCERT", None, 1 / 8),
                         ("vrf_proof", "VRFKeyBadProof", pools[0], 1 / 8))]
            if any(d["agg_redispatch"] < 1 for d in dirty):
                raise AssertionError("a corrupted bc copy re-dispatched no window")
            paths["bc_dirty"] = {
                "launches": {k: sum(d["launches"][k] for d in dirty) for k in dirty[0]["launches"]},
                "agg_redispatch": [d["agg_redispatch"] for d in dirty]}
            out["bench"] = port_bench.measure(db, device=dev, native=out["native"])
            print("bench " + json.dumps(out["bench"]), flush=True)
            out["bench_lanes"] = port_bench.measure(db, device=dev, aggregate=False,
                                                    native=out["native"])
            print("bench_lanes " + json.dumps(out["bench_lanes"]), flush=True)
            if out["bench"]["agg_redispatch"] or not out["bench"]["aggregate"]:
                raise AssertionError("the bench's aggregated replays re-dispatched a window")
        elif tag == "draft03":
            corrupted_replay(tag, db, n, "vrf_proof", "VRFKeyBadProof",
                             params, lview, max_batch, dev, pool=pools[0])
        out.pop("result")
        out.pop("native")
        paths[tag] = out
    return paths


def phase_generic(dev, forges: Forges, max_batch: int) -> dict:
    """The generic staging on the card (phase 3d): stand-in-body views
    replayed on the card with the launch counts zeroed just before and
    read just after, and by the C++ verifier; the packed staging's decline
    must be recorded. Then one VRF-proof byte flipped two thirds of the
    way in: both backends stop there with VRFKeyBadProof."""
    import dataclasses

    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.protocol.praos import PraosState
    from ouroboros_consensus_tpu_torch.testing import corrupt, synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    db, headers = forges.get("generic")
    hvs = corrupt.standin_views(db_analyser.read_header_views(db), params, pools[0])

    def replay(views, backend, batch=max_batch):
        return pbatch.validate_chain(params, lambda _e: lview, PraosState(), views,
                                     max_batch=batch, backend=backend,
                                     device=dev if backend == "device" else None)

    before = pbatch.DECLINES.get("field-offsets", 0)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dres = replay(hvs, "device")
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    declined = pbatch.DECLINES.get("field-offsets", 0) - before
    if declined <= 0:
        raise AssertionError("generic path: the packed staging's decline was not recorded")
    log(f"generic: launches {json.dumps(launches)}; field-offsets declines {declined}")
    t0 = time.perf_counter()
    nres = replay(hvs, "native")
    native_s = time.perf_counter() - t0
    compare("generic (stand-in bodies)", dres, nres)
    if dres.n_valid != headers or dres.error is not None:
        raise AssertionError(f"generic path: {dres.n_valid}/{headers}, {dres.error!r}")
    target = int(headers * 2 / 3)
    bad = list(hvs)
    pi = bytearray(bad[target].vrf_proof)
    pi[40] ^= 0x01
    bad[target] = dataclasses.replace(bad[target], vrf_proof=bytes(pi))
    dbad, nbad = replay(bad, "device"), replay(bad, "native")
    compare("generic (stand-in bodies), vrf_proof byte flipped", dbad, nbad)
    if dbad.n_valid != target or type(dbad.error).__name__ != "VRFKeyBadProof":
        raise AssertionError(f"generic corrupted: expected VRFKeyBadProof at {target}, "
                             f"got {dbad.n_valid} {dbad.error!r}")
    log(f"generic: device {device_s:.3f} s, native {native_s:.3f} s for {headers} headers")
    # the carry chain broken and seeded again: the middle third on
    # stand-in bodies, packed windows on both sides of it (64-header
    # windows: validate_chain does not cut a list at a body-width step, so
    # a window that holds one, or a stand-in, is staged generically)
    real = db_analyser.read_header_views(db)
    third = headers // 3
    views = real[:third] + hvs[third: 2 * third] + real[2 * third:]
    K.reset_launches()
    seeded = []
    dispatch = pbatch.dispatch_prepared

    def spy(sw, device, carry_in=None):
        v = dispatch(sw, device, carry_in)
        seeded.append((isinstance(carry_in, np.ndarray), v.carried))
        return v

    pbatch.dispatch_prepared = spy
    try:
        dmid = replay(views, "device", 64)
    finally:
        pbatch.dispatch_prepared = dispatch
    torch.cuda.synchronize()
    compare("stand-in middle third (carry seeded again)", dmid, replay(views, "native", 64))
    mid = dict(K.LAUNCHES)
    packed = sum(c for _s, c in seeded)
    cut = [k for k in range(1, len(seeded)) if seeded[k][1] and not seeded[k - 1][1]]
    if (dmid.n_valid != headers or not cut or any(not seeded[k][0] for k in cut)
            or dev.type == "cuda" and not mid["unpack"] == mid["nonce_fold"] == packed):
        raise AssertionError(f"stand-in middle third: {dmid.n_valid}/{headers}, "
                             f"windows (host seed, carried) {seeded}, launches {mid}")
    log(f"generic: stand-in middle third device == native; windows (host seed, "
        f"carried) {seeded}; launches {json.dumps(mid)}")
    return {"launches": launches, "declines": declined, "n_valid": dres.n_valid,
            "device_s": device_s, "native_s": native_s, "middle_launches": mid}


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
# --ab: this tree against another checkout, in turns on one card
# ---------------------------------------------------------------------------

AB_CHILD = r"""
import json, sys, tempfile, importlib.util
root, this, lanes = sys.argv[1], sys.argv[2], [int(x) for x in sys.argv[3].split(",")]
sys.path.insert(0, root)
import torch
import chip_smoke as own
spec = importlib.util.spec_from_file_location("chip_smoke_this", this)
new = importlib.util.module_from_spec(spec)
spec.loader.exec_module(new)
dev = torch.device("cuda")
w = tempfile.mkdtemp(prefix="chip_smoke_ab_")
rec = {"root": root, "ptxas": own.phase_build()}
st = own.phase_kernels(dev, workdir=w)
st["vrf_prep"] = own.phase_vrf_prep(dev, workdir=w)
rec["phase2_ms"] = {k: v["ms"] for k, v in st.items()}
rec["stage_ms"] = new.stage_times(dev, lanes, workdir=w)
rec["stage_ms"].update(new.wire_times(dev, lanes, workdir=w))
print("AB " + json.dumps(rec), flush=True)
"""


def ab_main(parent: str, lanes=(8, 128, 8192)) -> int:
    """This tree against `parent` (a checkout of another commit), in turns
    parent, this, this, parent; one process per turn, each building its
    own tree's kernels. Prints each turn's `AB {...}` line and the card."""
    this = os.path.abspath(__file__)
    recs = []
    for root in (parent, REPO, REPO, parent):
        p = subprocess.run([sys.executable, "-c", AB_CHILD, os.path.abspath(root), this,
                            ",".join(map(str, lanes))],
                           capture_output=True, text=True)
        line = [x for x in p.stdout.splitlines() if x.startswith("AB ")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"A/B turn for {root} failed (exit {p.returncode})")
        recs.append(json.loads(line[0][3:]))
        print(line[0], flush=True)
    for key in (*STAGES, *sorted(WIRE)):
        if not all(key in r["stage_ms"] for r in recs):
            continue
        row = []
        for n in lanes:
            par = [r["stage_ms"][key][str(n)] for r in (recs[0], recs[3])]
            cur = [r["stage_ms"][key][str(n)] for r in (recs[1], recs[2])]
            row.append(f"{n}: parent {min(par):.4f} this {min(cur):.4f} "
                       f"({min(par) / min(cur):.2f}x)")
        log(f"A/B {key}: " + "; ".join(row))
    print(f"card: {card_line()}", flush=True)
    return 0


AB_REPLAY_CHILD = r"""
import json, sys
root, db = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch
import chip_smoke as own
from ouroboros_consensus_tpu_torch import native
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_analyser
native.build()
build.build_cuda()
params = own.bench_params()
lview = synth.make_ledger_view([synth.make_pool(0, kes_depth=params.kes_depth)])
dev = torch.device("cuda")
runs = []
for _ in range(3):
    torch.cuda.synchronize()
    r = db_analyser.revalidate(db, params, lview, backend="device", max_batch=8192, device=dev)
    torch.cuda.synchronize()
    assert r.error is None and r.n_valid > 0, (r.n_valid, r.error)
    runs.append({"n_valid": r.n_valid, "wall_s": r.wall_s, "validate_s": r.validate_s,
                 "read_s": getattr(r, "read_s", None), "wait_s": getattr(r, "wait_s", None)})
rec = {"root": root, "runs": runs,
       "layers_s": own.layer_breakdown(db, params, lview, 8192, dev)}
print("ABR " + json.dumps(rec), flush=True)
"""


def ab_replay_main(parent: str, headers: int) -> int:
    """The replay of one forged bc chain by this tree and by `parent`, in
    turns parent, this, this, parent (one process per turn): each turn's
    three device revalidates (the first warms up) and the tree's own
    layer_breakdown. Prints each turn's `ABR {...}` line, each side's
    minimum over its timed replays and turns, and the card."""
    from ouroboros_consensus_tpu_torch.testing import synth

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    work = tempfile.mkdtemp(prefix="chip_smoke_abr_")
    try:
        db = os.path.join(work, "chain_bc")
        t0 = time.monotonic()
        synth.synthesize(db, params, pools, synth.make_ledger_view(pools), headers)
        log(f"ab-replay: forged {headers} headers in {time.monotonic() - t0:.1f} s")
        recs = []
        for root in (parent, REPO, REPO, parent):
            p = subprocess.run([sys.executable, "-c", AB_REPLAY_CHILD,
                                os.path.abspath(root), db], capture_output=True, text=True)
            line = [x for x in p.stdout.splitlines() if x.startswith("ABR ")]
            if p.returncode != 0 or not line:
                print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"replay A/B turn for {root} failed (exit {p.returncode})")
            recs.append(json.loads(line[0][4:]))
            print(line[0], flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sides = {"parent": (recs[0], recs[3]), "this": (recs[1], recs[2])}
    summary = {}
    for side, rs in sides.items():
        timed = [run for r in rs for run in r["runs"][1:]]
        layers = {}
        for r in rs:
            for k, v in r["layers_s"].items():
                layers[k] = min(layers.get(k, v), v)
        wall = min(run["wall_s"] for run in timed)
        summary[side] = {"wall_s": wall, "validate_s": min(run["validate_s"] for run in timed),
                         "headers_per_wall_s": timed[0]["n_valid"] / wall,
                         "layers_s_min": layers}
    print("ABR-SUMMARY " + json.dumps(summary), flush=True)
    print(f"card: {card_line()}", flush=True)
    return 0


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headers", type=int, default=32768,
                    help="headers of the bc and of the draft-03 chain; the "
                         "mixed chain and the stand-in-body chain have an "
                         "eighth as many")
    ap.add_argument("--ab", metavar="PARENT",
                    help="time this tree against the checkout PARENT instead")
    ap.add_argument("--ab-replay", metavar="PARENT",
                    help="time this tree's replay of one bc chain against PARENT's instead")
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if a.ab:
        return ab_main(a.ab)
    if a.ab_replay:
        return ab_replay_main(a.ab_replay, a.headers)
    from ouroboros_consensus_tpu_torch.device import max_sm_clock_hz, resolve, wide_product_rate

    dev = resolve(None)
    card = card_line()
    log(f"card: {card}")
    t_all = time.monotonic()
    ptxas = phase_build()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    forges = Forges(work, a.headers)
    try:
        stages = phase_kernels(dev, workdir=work)
        stages["vrf_prep"] = phase_vrf_prep(dev, workdir=work)
        stages.update(phase_wire(dev, workdir=work))
        stages.update(phase_agg(dev, workdir=work))
        for key, by_lanes in stage_times(dev, workdir=work).items():
            stages[key]["ms_by_lanes"] = {**by_lanes, stages[key]["lanes"]: stages[key]["ms"]}
        phase_agg_chain(dev, forges.get("bc")[0], stages)
        paths = phase_main(dev, forges, 8192)
        generic = phase_generic(dev, forges, 8192)
    finally:
        forges.close()
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
    by_path["generic"] = generic["launches"]
    by_path["tools"] = tools["launches"]
    for path, ks in PATH_KERNELS.items():
        missing = sorted(k for k in ks if by_path[path][k] <= 0)
        stray = sorted(k for k in REPLAY_KERNELS - ks if by_path[path].get(k, 0))
        if missing or stray:
            raise AssertionError(f"{path} path: not launched {missing}, launched {stray}")
    kernels = []
    for name, src, rep in KERNEL_ROWS:
        st = stages[name]
        if "bound_ms" in st:  # the wire kernels: phase_wire's bound
            per_lane = None
            bound, bound_by = st["bound_ms"], st["bound_by"]
        elif name in ("msm", "agg_tables"):
            # msm: this run's point operations (msm_work); agg_tables: its bytes
            per_lane = None
            ops_ms = st.get("products", 0) / wide_rate * 1e3
            bytes_ms = st["bytes"] / 3.35e12 * 1e3
            bound = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        else:
            per_lane = st.get("products_per_lane") or wide_products(st["field_ops"])
            ops_ms = per_lane * st["lanes"] / wide_rate * 1e3
            bytes_ms = st["bytes"] / 3.35e12 * 1e3
            bound = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        used = [p for p, ks in PATH_KERNELS.items() if name in ks]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path[p][name] for p in used),
            "launches_by_path": {p: by_path[p][name] for p in used},
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "field_ops_per_lane": st.get("field_ops"),
            "wide_products_per_lane": per_lane,
            "ms_by_lanes": st.get("ms_by_lanes"), "wrapper_ms": st.get("wrapper_ms"),
            "wrapper_ms_by_lanes": st.get("wrapper_ms_by_lanes"),
            "lanes": st["lanes"], "bytes": st["bytes"], "ptxas": ptxas.get(name),
            "msm_work": st.get("work"), "tiled": st.get("tiled"),
        })
    for p, out in paths.items():
        fill = [{"kernel": k, "lanes": n, "blocks": -(-n // 32)}
                for k, n in out.get("lanes_per_launch", [])]
        log(f"{p}: grid fill per window (32 lanes a block in every stage kernel: ed, "
            f"kes, agg_prep 4 warps, vrf_prep, vrf_bc_prep, finish 3, vrf_ladders 8; "
            f"{sms} SMs): {json.dumps(fill)}")
        log(f"{p}: {json.dumps({k: v for k, v in out.items() if k not in ('launches', 'windows', 'list', 'lanes_per_launch')})}")
    log(f"aggregate dedupe (torch) ms by lanes: {json.dumps(stages['dedupe_ms'])}")
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
