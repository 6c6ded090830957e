#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Praos replay and of the mixed-era
composite on one NVIDIA card.

    python3 chip_smoke.py                 # the full run (needs one CUDA card)
    python3 chip_smoke.py --headers 4096  # shorter chains, same phases

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (nvidia-smi), torch / CUDA versions, and
   the build of the twenty kernel sources (one nvcc per source, in
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
   window of 256 distinct headers, clean and with a torsion-offset R_k, a
   flipped OCert s and a wrong β: `agg_prep` and `dedupe` (its slots and
   B row reduced mod L) byte for byte against their plain versions, `msm` against its plain
   version as points (compressed total, identity flag; not on the widest
   dirty window), and `aggregate_window`: the identity and the five
   stages' verdicts on the clean window, agg_ok false on the dirty one;
   `dedupe` also on columns of 256 distinct keys (the cap exactly), of
   300 (ok_cap false), of keys sharing their first 8, 16, 24 and 31
   bytes (many keys a warp, and a few), of 1, 8, 8,193, 20,000 and 70,000
   lanes, and three groups in two slots (`dedupe_windows`); msm's
   launches split by kernel (`msm_split`, torch.profiler) at 8 lanes;
   then the same on a
   full 8,192-lane window of the forged bc chain (`phase_agg_chain`: the
   bucket shape the replay gives msm, which the tiled window's repeated
   scalars do not), whose times the kernels line reports, each kernel
   beside its bound (msm's from this run's bucket entries, `msm_work`).
   Then the forge's two kernels (`phase_forge`): `forge_sweep` on 256
   lanes of three pools under a set epoch nonce and on one full election
   window (16,384 lanes of the main path's pool under the neutral
   nonce), `ed_sign` on the main path's two OCert signables, on serve-
   1024's 34 and on 256 and 4,096 messages of 0 to 200 bytes (one of the
   256 of 400 bytes: `hold_ed_sign`), each byte for byte against its
   plain version,
   timed at the main path's shapes (`ed_sign` at each of its four
   widths: the launch alone, the wrapper, and the wrapper with its
   caller's read of the signatures), with the sweep's field work by part
   (`forge_role_ops`) and its stamped build's timeline by warp at one
   block and a full window (`forge_stamps`: its dependent path), and the
   signer's stamped build's phases at 2 and 256 signables
   (`ed_sign_stamps`).
3. The main paths, each with the launch counts zeroed just before its
   device replay and read just after: every packed window launches
   `unpack`, the five stage kernels and `nonce_fold`, the fold on a
   stream of its own (checked) beside the stages, the carry chained
   from window to window on the card; a batch-compatible packed window
   takes the window aggregate (`agg_prep`, `dedupe`, `msm`) in place of the five stages, and none of a clean chain's
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
      chain with the aggregate on, off, on and off, on `bench {...}` and
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
   e. the forge (`phase_forge_chains`): once every worker is done, the bc
      chain and the mixed chain forged again in this process through
      tools/db_synthesizer.py's device engine (`forge_sweep` an election
      window, `ed_sign` a window's OCert issues, the assembly on the
      host), each with the launch counts zeroed just before and read
      just after; every chunk, index and sidecar file must equal the
      worker's (the per-slot loop engine). One `forge {...}` line a
      chain: election s, assembly s, headers/s, against the loop's.
   f. the store's crash protocol and the self-healing replay
      (`phase_recovery`, one `recovery {...}` line): the bc chain with
      validate_all=True (revalidate's default: a writer's deep open) and
      "stream" in turns, equal to the native replay; three corrupted
      copies of the 4,096-header chain (a flipped byte under its index
      CRC, a torn tail, a torn index) repaired at the open, device ==
      native and the files identical; four chaos faults on the bc
      chain's replay (a dispatch, the finish kernel, the staging thread,
      a chunk read), each healed on the card by its first rung; a replay
      and a device-engine forge killed by SIGKILL in child processes and
      resumed in others, to the clean state and the uninterrupted
      forge's files.
   g. the serving plane (`phase_serve`, `serve {...}` lines): many
      peers' real-crypto candidate suffixes (testing/traffic.py, forged
      on the card: `forge_sweep` elects each pool's slots, `ed_sign`
      issues the OCerts) batched into shared windows by
      node/serve.ValidationService, against a window per suffix
      (`validate_batch`, "per-peer"), at bench.py's parameters:
      serve-64 (64 tenants, 4 rounds of 8-header suffixes, 4 pools,
      256-lane windows, every 2nd tenant bc, a fork storm of 8 with 2
      equivocating pairs, a counter jump every 16th tenant, an unknown
      pool every 32nd), also on the host plane; serve-1024 (1,024 bc
      tenants, 2 rounds of 8, 16 pools, 8,192-lane windows) clean and
      with a counter jump every 64th tenant. Each tenant's verdict rows
      and final state must equal the per-peer discipline's (and on
      serve-64 the host plane's); serve-64 with
      `device-error@serve-dispatch:1` must shed to the ladder and heal
      with the same verdicts, its degraded interval closed; a child
      serving serve-64 killed by `sigkill@serve:4` and another resuming
      it on the checkpoint must end in the uninterrupted verdicts and
      states. The launch counts are zeroed before each batched run and
      read after it.
   h. the hard-fork composite (`phase_ed_verify`, `phase_cardano`, one
      `cardano {...}` line): the batched Ed25519 verify kernel
      (`ed_verify`) against its plain version byte for byte at 8, 128 and
      8,192 lanes of 0- to 300-byte messages (one to three SHA-512 blocks in
      one batch) with one corrupted lane of each kind (a flipped R byte,
      s + L, a flipped message byte, an off-curve A, a non-canonical A,
      x = 0 with the sign bit), which its verdicts must flag exactly, and
      at the Byron segment's 21,600 lanes, there and at 65,536 lanes of
      32-byte messages (64k standalone witness signatures) also against the
      C++ verifier, with its stamped build's timeline by warp at 8, 21,600
      and 65,536 lanes (`ed_verify_stamps`); then a mainnet-shaped Byron (PBFT) → Shelley (TPraos) →
      Babbage (Praos) chain (k = 2,160, 21,600-slot epochs, 7 genesis
      delegates, a 0.22 signing threshold, CompactSum7 KES, d = 1/2; one
      epoch an era, 64,800 slots) forged by `composite.synthesize` in a
      worker and replayed by `composite.revalidate` on the card (each era's
      launches counted from its trace: Byron `ed_verify`, Shelley the five
      stages of its epoch's generic window, Babbage its packed window's
      unpack, stages and fold) and through the C++ verifier, which must
      agree; each of those seven kernels held to its plain version on the
      replay's own Shelley and Babbage windows at their 22,528-lane bucket,
      with every corrupt kind of phase 2 (and of `unpack`'s wire); three
      tampered copies (a Byron signature byte, a Shelley
      KES-signature byte, a Babbage VRF-proof byte with the header
      KES-signed again) that stop the card's replay at their index with
      the reference's error class; and both `--cardano` CLIs.
   i. observability (`phase_obs`, `obs {...}` line) on a's chain at
      max_batch 8,192: an untraced replay, then one with the flight
      recorder installed and the live plane armed (a heartbeat file, the
      metrics port), whose verdicts, final state and launches (kernel by
      kernel) must equal the untraced one's, whose oct_windows_total,
      oct_headers_validated_total and byte counters must equal its
      result's windows, headers and bytes, with one WindowStaged and one
      WindowSpan a window, /healthz answered mid-replay with a phase
      that is not idle, the heartbeat's last document "done" and the
      Perfetto document valid (written under _build/); then untraced and
      traced replays in alternating pairs (the overhead: each side's
      median and quartiles, each pair's ratio, "unresolved" where the
      pairs' quartiles take both signs), each with the untraced launches,
      and the seconds inside every call of the seam (the Enclose
      brackets, the transfer and window events, the recorder) over one
      more traced replay, pipelined and serial (one thread: no waits for
      the GIL); the warmup report with every source's nvcc wall
      and every launched kernel's first launch wall (the five largest of
      each printed). The resources report is held after phase 4 (the
      tools' kernels too): a row for every kernel the run launched, its
      registers, local and static shared bytes equal to ptxas's for the
      kernel its attributes entry reads, and its blocks per SM from the
      occupancy API equal to sm_90's own count from those figures at the
      entry's geometry (`sm90_blocks_per_sm`).
   The main paths' replays use revalidate's default (validate_all=True);
   the read's measurements (`sidecar_checks`, `read_breakdown`,
   `overlap_turns`, `pipeline_timeline`, `layer_breakdown`) and the
   bench use the read-only "stream", the bench's path.
   Each main path logs headers/s over `validate_s` (the validate_chain
   calls) and over `wall_s` (the read as well), the read's own time
   (`read_s`, overlapped) and the time validation waited for it
   (`wait_s`), and the single-format chains a host wall per layer of a
   serial replay (`layer_breakdown`: the columnar layers by their own
   names, and `read`).
4. The tools: the primitive harness (tools/debug_pk.py, all seven
   bodies OK on the card) and the field-op microbenchmark
   (tools/fe_bench.py: fe_mul against fe_sq, ns per op beside the bound).
5. A `kernels` JSON line (sixteen kernels; the forge's two with their
   launches on each forged chain beside its headers; every kernel's
   launches by path, the serving plane's included; each kernel's
   resources row, held to ptxas after phase 4), the card line, and
   the final status line.

Phase 2 also times the six stage kernels at the main path's one-block
widths (8 and 128 lanes), and phase 1 prints ptxas's registers, stack
and spill stores of each launched kernel with its resident blocks per SM.

    python3 chip_smoke.py --ab PARENT     # A/B against another checkout

runs, on one card and in turns (parent, this tree, this tree, parent),
one process per turn: each tree's own phase 1 and phase 2 and the six
stage kernels of each tree at 8, 128 and 8192 lanes (`stage_times`), the
two wire kernels alone where the tree has them (`wire_times`), `ed_verify`
at its five widths, `forge_sweep` at its two and `ed_sign` at 2, 256
and 4,096 signables (`verify_forge_times`, `A/B ed_verify`, `A/B
forge_sweep` and `A/B ed_sign launch | wrapper | read` lines; the two
trees' outputs must be equal), and
`agg_prep`, `msm` and the dedupe with its mod-L reductions on a full
window of a chain forged once for all turns, on tiled windows, on
20,000 lanes and on 256 and 300 distinct keys (`agg_times`); one `AB
{...}` JSON line per turn.

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
    ("dedupe", "ouroboros_consensus_tpu_torch/ops/pk/csrc/dedupe.cu",
     "ouroboros_consensus_tpu/ops/pk/aggregate.py:153"),
    ("msm", "ouroboros_consensus_tpu_torch/ops/pk/csrc/msm.cu",
     "ouroboros_consensus_tpu/ops/pk/msm.py:381"),
    ("forge_sweep", "ouroboros_consensus_tpu_torch/ops/pk/csrc/forge.cu",
     "ouroboros_consensus_tpu/protocol/forge.py:91"),
    ("ed_sign", "ouroboros_consensus_tpu_torch/ops/pk/csrc/forge.cu",
     "ouroboros_consensus_tpu/protocol/forge.py:125"),
    ("ed_verify", "ouroboros_consensus_tpu_torch/ops/pk/csrc/ed_verify.cu",
     "ouroboros_consensus_tpu/ops/ed25519_batch.py:96"),
)
# a row whose LAUNCHES key is not its build name: (build name, kernel)
KERNEL_SOURCE = {"forge_sweep": ("forge", "forge_sweep_kernel"),
                 "ed_sign": ("forge", "ed_sign_kernel")}
# the kernels each path must launch (and the replay kernels it must not)
WIRE = {"unpack", "nonce_fold"}  # every packed window's, around the stages
# the reference functions a kernel replaces beside its row's own: the
# dedupe's launch also reduces the slots and the B coefficient mod L
ALSO_REPLACES = {"dedupe": ["ouroboros_consensus_tpu/ops/pk/limbs.py:489",
                            "ouroboros_consensus_tpu/ops/pk/limbs.py:502"],
                 "forge_sweep": ["ouroboros_consensus_tpu/ops/ecvrf_batch.py:83",
                                 "ouroboros_consensus_tpu/ops/ecvrf_batch.py:130",
                                 "ouroboros_consensus_tpu/ops/ecvrf_batch.py:265"],
                 "ed_sign": ["ouroboros_consensus_tpu/ops/ed25519_batch.py:140"],
                 "ed_verify": ["ouroboros_consensus_tpu/ops/ed25519_batch.py:71",
                               "ouroboros_consensus_tpu/ops/ed25519_batch.py:192"]}
AGG = {"agg_prep", "dedupe", "msm"}  # the window aggregate's
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
    # the device engine's forge of the bc and the mixed chain
    "forge": {"forge_sweep", "ed_sign"},
    # phase 3i's traced replay of the bc chain
    "obs": AGG | WIRE,
    # phase 3f's replays: the aggregate, and the stages of its finish fault
    "recovery": AGG | BC_STAGES | WIRE,
    # phase 3g's batched serving runs: draft-03 and bc windows, a dirty
    # bc window's re-dispatch
    "serve": D3_STAGES | BC_STAGES | AGG | WIRE,
    # phase 3h's composite replay: the Byron signatures' batch verify, the
    # TPraos epoch's five stages (the generic staging), the Babbage epoch's
    # packed window (unpack, the five stages, the fold beside them)
    "cardano": {"ed_verify"} | BC_STAGES | WIRE,
}
REPLAY_KERNELS = BC_STAGES | D3_STAGES | AGG | WIRE
# none may launch off its path
PATH_ONLY = REPLAY_KERNELS | PATH_KERNELS["forge"] | {"ed_verify"}
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
        source, kernel = KERNEL_SOURCE.get(name, (name, None))
        with open(build.ptxas_report(source)) as f:
            ptxas[name] = ptxas_record(f.read(), kernel)
        ptxas[name]["blocks_per_sm"] = build.blocks_per_sm(
            source, None if name in (source, "forge_sweep") else name)
        log(f"ptxas {name}: {json.dumps(ptxas[name])}")
    for name, kernel in (("ed_verify_stamps", None), ("forge_stamps", "forge_sweep_kernel"),
                         ("ed_sign_stamps", "ed_sign_kernel")):
        with open(build.ptxas_report(name)) as f:  # the instruments' own lines
            log(f"ptxas {name}: {json.dumps(ptxas_record(f.read(), kernel))}")
    return ptxas


def ptxas_record(text: str, kernel: str | None) -> dict:
    """ptxas's registers, stack and spill stores from its -v report of one
    source (`kernel`: that kernel's own entries, up to the next kernel's;
    else the source's largest)."""
    if kernel is not None:
        parts = re.split(r"(?=ptxas info\s*: Compiling entry function)", text)
        text = "".join(p for p in parts if re.search(rf"'_Z\d+{kernel}", p))
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    # the cumulative size where a kernel calls a function, else its frame
    stack = [int(x) for x in
             re.findall(r"(\d+) bytes (?:cumulative stack size|stack frame)", text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", text)]
    # each function's own spill stores, by its name (of the mangled
    # `_Z<length><name>...`), where it spills
    by_fn = {}
    for fn, n in re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                            r"(\d+) bytes spill stores", text):
        m = re.match(r"_Z(\d+)(\w+)", fn)
        key = m.group(2)[:int(m.group(1))] if m else fn
        if int(n):
            by_fn[key] = by_fn.get(key, 0) + int(n)
    return {"registers": max(regs, default=None), "stack_bytes": max(stack, default=None),
            "shared_bytes": max(smem, default=0),
            "spill_store_bytes": sum(spills), "spill_stores_by_function": by_fn}


# the CUDA occupancy calculator's per-SM figures for compute capability
# 9.0 (H100): registers, their unit (a warp's registers are allocated in
# 256s) and the sub-partitions they are split over, warps, blocks, shared
# bytes, the shared bytes the runtime reserves a block and their unit
SM90 = {"regs": 65536, "reg_unit": 256, "sub_partitions": 4, "warps": 64, "blocks": 32,
        "smem": 233472, "smem_reserved": 1024, "smem_unit": 128}


def sm90_blocks_per_sm(registers: int, shared_bytes: int, threads: int) -> int:
    """Resident blocks an SM of a kernel with `registers` a thread and
    `shared_bytes` (static and dynamic) a block, at `threads` a block,
    counted from sm_90's limits (SM90): the least of the blocks, the
    warps, the registers each sub-partition holds and the shared memory
    allow. Independent of the runtime's occupancy API, which
    check_resources holds to it."""
    warps = -(-threads // 32)
    reg_warp = -(-registers * 32 // SM90["reg_unit"]) * SM90["reg_unit"]
    by_regs = (SM90["regs"] // SM90["sub_partitions"] // reg_warp) * SM90["sub_partitions"]
    smem = shared_bytes + SM90["smem_reserved"]
    smem = -(-smem // SM90["smem_unit"]) * SM90["smem_unit"]
    return min(SM90["blocks"], SM90["warps"] // warps, by_regs // warps, SM90["smem"] // smem)


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


# 32-bit integer instructions of one compression, at their fewest as the
# card runs them: SHA-512's 80 rounds at 28 (three funnel-shift pairs and
# a three-input XOR a Σ, one LOP3 pair for Ch and for Maj, 64-bit adds as
# IADD3 pairs of three inputs) and its 64 schedule words at 20, plus the
# final adds; Blake2b's 96 G steps at 22 (four three-input adds, four XORs
# and three rotations the 32-bit swap aside), plus its set-up and output
SHA512_INSTRS = 80 * 28 + 64 * 20 + 16
BLAKE2B_INSTRS = 96 * 22 + 40


def count_hash_ops(fn) -> dict:
    """SHA-512 and Blake2b compressions one lane of `fn` performs (the
    plain twin's count: `hashes.sha512_compress` calls, and
    `hashes.blake2b_fixed` calls, each one block)."""
    from ouroboros_consensus_tpu_torch.ops.pk import hashes as ph

    comp, b2b = ph.sha512_compress, ph.blake2b_fixed
    n = {"sha512": 0, "blake2b": 0}

    def counting_comp(state, block):
        n["sha512"] += 1
        return comp(state, block)

    def counting_b2b(data, digest_size=32):
        n["blake2b"] += 1
        return b2b(data, digest_size)

    ph.sha512_compress, ph.blake2b_fixed = counting_comp, counting_b2b
    try:
        fn()
    finally:
        ph.sha512_compress, ph.blake2b_fixed = comp, b2b
    return n


def agg_prep_work(one, depth: int) -> dict:
    """agg_prep's work a lane, from its plain twin on one lane (`one`, the
    22 columns): field multiplies and squarings (`count_field_ops`), the
    same with its two inversions batched (each inverted Z then costs three
    products, Montgomery's trick, and the window one inversion: its
    products are left out), and the SHA-512 and Blake2b compressions."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
    from ouroboros_consensus_tpu_torch.ops.pk import field as fe

    twin = count_field_ops(lambda: pa.agg_prep_plain(*one, kes_depth=depth))
    inv = count_field_ops(lambda: fe.inv(one[0][:10].to(torch.int64)))
    batched = {"mul": twin["mul"] - 2 * inv["mul"] + 2 * 3, "sqr": twin["sqr"] - 2 * inv["sqr"]}
    return {"field_ops": twin, "inversion_ops": inv, "field_ops_batched": batched,
            "hash_ops": count_hash_ops(lambda: pa.agg_prep_plain(*one, kes_depth=depth))}


def agg_prep_bound(st: dict, wide_rate: float, int_rate: float) -> dict:
    """agg_prep's operation bound on `st["lanes"]` lanes, the larger of two
    pipes' times: its field products with the inversions batched at the
    wide-product rate (IMAD.WIDE, on the FMA pipe) and its hash
    compressions' 32-bit instructions at the integer rate (LOP3, SHF and
    IADD3, on the ALU pipe, which issues beside the FMA pipe); each part
    beside it, and the field-only bound of the twin's count (two
    inversions a lane), as earlier PRs gave it.
    -> {bound_ms, bound_pipe, field_ms, hash_ms, bound_field_only_ms,
    per_lane}."""
    n = st["lanes"]
    field = wide_products(st["field_ops_batched"]) * n / wide_rate * 1e3
    h = st["hash_ops"]
    hashes = (h["sha512"] * SHA512_INSTRS + h["blake2b"] * BLAKE2B_INSTRS) * n / int_rate * 1e3
    old = wide_products(st["field_ops"]) * n / wide_rate * 1e3
    return {"bound_ms": max(field, hashes), "bound_pipe": "fma" if field >= hashes else "alu",
            "field_ms": field, "hash_ms": hashes, "bound_field_only_ms": old,
            "per_lane": {"wide_products": wide_products(st["field_ops_batched"]),
                         "hash_instructions": h["sha512"] * SHA512_INSTRS
                         + h["blake2b"] * BLAKE2B_INSTRS}}


# agg_prep.cu's clock64 stamps (the agg_stamps build): a warp's stamp k
# ends the step named here (k 0 its start, 11 the block's end; a step
# after a barrier includes the wait)
AGG_STEPS = {
    "ae": {1: "OCert digest", 2: "h_e, A_e", 10: "wait z, z1, z1·h_e"},
    "re": {8: "R_e", 10: "wait z, z1·s_e"},
    "v": {8: "V", 10: "wait z, z3, z3·s_v"},
    "al": {10: "A_l, Merkle walk"},
    "rk": {8: "R_k", 10: "wait z, z2·s_k"},
    "y": {10: "Y, leader value, eta"},
    "u": {8: "U", 10: "wait z, z4, z4·s_v"},
    "g": {1: "Γ, 8Γ", 3: "wait inverses, β'", 10: "wait c and z, z4·c"},
    "h": {1: "H (hash, Elligator2, 8·)", 3: "wait 8Γ leaves, tree up", 4: "root inverse (warp)",
          5: "tree down", 6: "c", 10: "wait z, z3·c"},
    "hash": {1: "KES digest", 3: "wait OCert digest, transcript", 10: "h_k, z2, z2·h_k"},
}
AGG_NSTAMP = 12


def agg_dependent_path(by_lanes: dict) -> dict:
    """agg_prep's dependent path from its stamps at one block (8 lanes)
    and on the chain window: the warp that ends last, and AW_H's and
    AW_HASH's paths as counts of steps times their measured costs (at one
    block: three SHA-512 compressions, one exponentiation and the root's
    265 rounds on a warp for AW_H; the KES digest's and the transcript's
    compressions for AW_HASH) beside their measured ends."""
    out = {}
    for tag in (8, "chain"):
        st = by_lanes.get(tag)
        if st is None:
            continue
        c = st["costs_us"]
        one = by_lanes.get(8, st)["costs_us"]
        out[str(tag)] = {
            "warp": st["path"]["warp"], "end_us": st["path"]["end_us"],
            "h": {"end_us": st["warps"]["h"]["end_us"],
                  "model": "3 sha512 + 1 exponentiation + 265 warp rounds",
                  "model_us": 3 * one["sha512"] + one["decompression"] + 265 * one["warp_round"]},
            "hash": {"end_us": st["warps"]["hash"]["end_us"],
                     "model": "KES digest + transcript compressions",
                     "model_us": (st["nb_kes"] + 5) * one["sha512"]},
            "costs_us": c,
        }
    return out


def agg_stamps(cols, depth: int) -> dict:
    """One launch of the stamped agg_prep (agg_stamps.cu) on these columns
    (on the card; its outputs held to the shipped kernel's): each role's
    steps in µs (clock64 cycles at the maximum SM clock), the mean over
    blocks, each role's end (before the block barrier) from the block's
    first stamp, and the block's whole time. The dependent path is the
    role that ends last; the costs: one decompression chain (V and U),
    one SHA-512 compression (the KES digest over its blocks), one product
    round of the root's inversion on the warp (265 rounds)."""
    import torch

    from ouroboros_consensus_tpu_torch.device import max_sm_clock_hz
    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
    from ouroboros_consensus_tpu_torch.ops.pk import build
    from ouroboros_consensus_tpu_torch.ops.pk.kernels import _p

    b = cols[0].shape[-1]
    dev = cols[0].device
    nblk = -(-b // 32)
    stamps = torch.zeros((nblk, len(AGG_STEPS), AGG_NSTAMP), dtype=torch.int64, device=dev)
    fn = build.kernel_lib("agg_stamps")

    got = pa._agg_prep_launch(lambda *a: fn(*a[:-1], _p(stamps), a[-1]),
                              torch.cuda.current_stream().cuda_stream, cols, depth)
    torch.cuda.synchronize()
    want = pa.agg_prep(*cols, kes_depth=depth)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("the stamped agg_prep differs from the shipped kernel")
    us = 1e6 / max_sm_clock_hz()
    t = stamps.cpu().to(torch.float64)
    start = t[:, :, 0].min(1).values  # each block's first stamp
    out = {"lanes": b, "blocks": nblk, "warps": {}}
    for w, (role, steps) in enumerate(AGG_STEPS.items()):
        rec, prev = {}, t[:, w, 0]
        for k, name in sorted(steps.items()):
            rec[name] = float((t[:, w, k] - prev).mean()) * us
            prev = t[:, w, k]
        out["warps"][role] = {"steps_us": rec,
                              "end_us": float((t[:, w, 10] - start).mean()) * us}
    out["block_us"] = float((t[:, :, 11].max(1).values - start).mean()) * us
    path = max(out["warps"], key=lambda r: out["warps"][r]["end_us"])
    nbk = cols[11].shape[0]
    out["path"] = {"warp": path, **out["warps"][path]}
    out["nb_kes"] = nbk
    out["costs_us"] = {
        "decompression": (out["warps"]["v"]["steps_us"]["V"]
                          + out["warps"]["u"]["steps_us"]["U"]) / 2,
        "sha512": out["warps"]["hash"]["steps_us"]["KES digest"] / nbk,
        "warp_round": out["warps"]["h"]["steps_us"]["root inverse (warp)"] / 265,
    }
    return out


# the wide window's four columns: (distinct keys, shared prefix bytes)
WIDE_SPEC = [(300, 8), (3000, 0), (200, 16), (1, 0)]


# the stamped dedupe's (dedupe_stamps.cu, csrc/agg.cuh: dd_block) stamps:
# stamp k ends phase k of a block's tile; 6 its last merge, 7 its root's
# slots, 8 the B row, 9 the merge levels it ran; 10-14 its last merge's
# phases; 15 its root's tile groups gathered into the slots (and the
# overflow slot's lane)
DD_TILE_PHASES = {1: "keys", 2: "compare", 3: "rank", 4: "sums", 5: "store"}
DD_MERGE_PHASES = {11: "stage", 12: "entries", 13: "scan", 14: "compact"}
DD_NSTAMP = 16


def dedupe_stamps(cols, pts, scal, reps: int = 10) -> dict:
    """`reps` launches of the stamped dedupe (dedupe_stamps.cu) on one
    window (on the card; its outputs held to the shipped kernel's), in µs
    (the global timer's ns: one clock for all SMs), the mean over launches: the
    tile phases (the mean over blocks), the merges (from a block's tile
    list to its last merge, by the levels it ran), each column's root
    finish (its slots mod L), the B row, each column's end and the
    launch's span from its first block's start, and the spread of the
    blocks' starts."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
    from ouroboros_consensus_tpu_torch.ops.pk import build

    keys = [cols[k] for k in pa.DEDUPE_KEYS]
    b = keys[0].shape[-1]
    blocks = pa._dedupe_shape(b)[0]
    fn = build.kernel_lib("dedupe_stamps")
    stream = torch.cuda.current_stream().cuda_stream
    us = 1e-3  # a stamp is in ns
    want = pa.window_tables(cols, pts, scal)
    runs = []
    for _ in range(reps):
        stamps = torch.zeros((blocks, DD_NSTAMP), dtype=torch.int64, device=pts.device)
        got = pa._dedupe_launch(lambda *a: fn(*a[:-1], stamps.data_ptr(), a[-1]), stream, keys,
                                scal[pa.SC_Z1:pa.SC_Z3C + 1].data_ptr(),
                                pts[pa.PT_RE:pa.PT_Y + 1].data_ptr(),
                                scal[pa.SC_B1:pa.SC_B3 + 1].data_ptr(), pa._DEDUPE_CAP)
        torch.cuda.synchronize()
        if got[3] != 0 or not all(torch.equal(g, w) for g, w in zip(got[:3], want)):
            raise AssertionError(f"the stamped dedupe differs from the shipped kernel "
                                 f"(rc {got[3]})")
        runs.append(stamps.cpu().to(torch.float64))
    t = torch.stack(runs)  # [reps, blocks, DD_NSTAMP]
    start = t[:, :, 0].min(1, keepdim=True).values
    out = {"lanes": b, "blocks": blocks, "reps": reps,
           "tile_us": {name: float((t[:, :, k] - t[:, :, k - 1]).mean()) * us
                       for k, name in DD_TILE_PHASES.items()},
           "start_spread_us": float((t[:, :, 0].max(1, keepdim=True).values - start).mean()) * us}
    merges = {}  # by the last level a block merged: its blocks, from its tile's list
    for lv in range(1, int(t[..., 9].max()) + 1):
        sel = t[..., 9] == lv
        merges[str(lv)] = {"blocks": float(sel.sum()) / reps,
                           "us": float((t[..., 6] - t[..., 5])[sel].mean()) * us}
    out["merges_by_levels_us"] = merges
    root = t[..., 7] > 0
    merged = torch.where(t[..., 9] > 0, t[..., 6], t[..., 5])  # a root's list ready
    out["finish_us"] = float((t[..., 7] - merged)[root].mean()) * us
    out["gather_us"] = float((t[..., 15] - merged)[root].mean()) * us
    top = root & (t[..., 9] > 0)  # the roots' own merges
    if bool(top.any()):
        out["root_merge_us"] = {name: float((t[..., k] - t[..., k - 1])[top].mean()) * us
                                for k, name in DD_MERGE_PHASES.items()}
        out["root_merge_us"]["from_ticket"] = float((t[..., 6] - t[..., 10])[top].mean()) * us
    col_end = (t[..., 7] - start)[root].reshape(reps, -1)
    out["column_end_us"] = [float(x) * us for x in col_end.mean(0)]
    brow = t[..., 8] > 0
    out["b_row_us"] = float((t[..., 8] - t[..., 5])[brow].mean()) * us
    out["launch_us"] = float((t[..., :9].max(2).values.max(1, keepdim=True).values
                              - start).mean()) * us
    return out


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


def hold_stages(tag: str, cols, kinds: dict, dev, reps: int, depth: int,
                no_leader=None) -> tuple[dict, dict]:
    """The five bc stage kernels against their plain versions (hold) on
    the limb-first columns `cols` on `dev`, which corrupt_columns marked as
    `kinds` says; then every corrupted lane fails its kind's check row and
    every other lane passes rows 0-3 (row 3, the leader check, is not
    asked of the lanes of the bool mask `no_leader`). `tag` names the
    window in the log. -> ({key: hold's record}, the plain versions'
    outputs that the operation count reads)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.ops.pk import verify as pv

    lanes = cols[0].shape[-1]
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
        stages[key] = hold(f"{key} ({tag})" if tag else key, kern, plain, inputs[key],
                           lanes, dev, reps)
    # the verdicts must flag the corrupted lanes as the kinds dictate
    f = flags_plain[0].cpu()
    for kind, ls in kinds.items():
        row = {"ocert_sig": 0, "noncanon_s": 0, "offcurve_vk": 0, "short_blocks": 0,
               "kes_sig": 1, "noncanon_y": 1, "kes_period_range": 1,
               "kes_sibling": 1}.get(kind, 2)
        if f[row, ls].any():
            raise AssertionError(f"{tag or 'phase 2'}: corrupt lanes of kind {kind} "
                                 f"passed check row {row}")
    clean = np.ones(lanes, bool)
    clean[np.concatenate(list(kinds.values()))] = False
    asked = np.ones((4, lanes), bool)
    if no_leader is not None:
        asked[3] = ~np.asarray(no_leader, bool)
    if not bool(f[:4].numpy()[asked & clean].all()):
        raise AssertionError(f"{tag or 'phase 2'}: an uncorrupted lane failed a check")
    return stages, {"ed_ok": ed_ok, "ed_pt": ed_pt, "kes_ok": kes_ok, "kes_pt": kes_pt,
                    "vrf_ok": vrf_ok, "c16": c16, "prep": prep, "pts": pts}


def phase_kernels(dev, lanes: int = 8192, distinct: int = 256, seed: int = 7,
                  reps: int = 5, workdir: str | None = None):
    """Kernel vs plain version, byte for byte, at the main path's shapes.
    -> {key: dict(ms, plain_ms, max_abs_err, field_ops, lanes, bytes)}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
    from ouroboros_consensus_tpu_torch.ops.pk import verify as pv

    depth = 7
    cols, rng = tiled_window(lanes, distinct, seed, workdir, "bc")
    kinds = corrupt_columns(cols, rng, depth)
    log("corrupt lanes: " + json.dumps({k: len(v) for k, v in kinds.items()}))
    cols = [c.to(dev).contiguous() for c in cols]
    stages, pl = hold_stages("", cols, kinds, dev, reps, depth)
    ed_ok, ed_pt, kes_ok, kes_pt = pl["ed_ok"], pl["ed_pt"], pl["kes_ok"], pl["kes_pt"]
    vrf_ok, c16, prep, pts = pl["vrf_ok"], pl["c16"], pl["prep"], pl["pts"]

    def i64(t):
        return t.to(torch.int64)

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
    """The point operations of the function `msm` computes on these
    scalars ([N, 32] uint8), at their least: a bucket addition per nonzero
    digit past each nonempty bucket's first, the weighted sums by running
    sums (two additions a bucket), the Horner chain (twelve doublings and
    one addition a window), the B term's 32 additions and the final one.
    The bound is taken from these. The tree that forms the weighted sums
    on the card does more: its first two levels as running sums over four
    buckets (nine additions and two doublings a node), then three
    additions and one doubling a node; `tree` counts its operations and
    `overhead` what they add to the running sums'. -> {adds, dbls,
    entries, buckets, path, tree, overhead}: path, the dependent
    operations of the Horner chain and the B term's last addition."""
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
    running = 2 * ww * pm.HALF
    adds = (entries - buckets) + running + (ww - 1) + 32 + 1
    dbls = (ww - 1) * pm.SHARED_BITS
    leaf4, upper = ww * pm.HALF // 4, ww * (pm.HALF // 4 - 1)
    tree = {"adds": 9 * leaf4 + 3 * upper, "dbls": 2 * leaf4 + upper}
    return {"adds": adds, "dbls": dbls, "entries": entries, "buckets": buckets,
            "path": {"dbls": (ww - 1) * pm.SHARED_BITS, "adds": ww}, "tree": tree,
            "overhead": {"adds": tree["adds"] - running, "dbls": tree["dbls"]}}


def kernel_split(fn, once: str, reps: int = 5) -> dict:
    """The device time of `fn` split by kernel: torch.profiler's CUDA
    activity over `reps` calls after one warm-up (`once`: a kernel that
    launches once a call, which counts the calls: the profiler may drop
    a call's events at the end of its cycle). -> {kernel name (cut at
    its argument list): {ms: device ms a launch, launches: a call},
    "total": device ms a call}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict = {}
    for _attempt in range(3):  # a profile that caught no launch of `once` is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            # a kernel's own time; the host ops that launched it have none
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us <= 0 or e.device_type != DeviceType.CUDA or "Activity Buffer" in e.key:
                continue
            name = e.key.split("(")[0].split("<")[0].strip() or e.key
            rec = out.setdefault(name, {"us": 0.0, "count": 0})
            rec["us"] += us
            rec["count"] += e.count
        if once in out:
            break
    calls = out.get(once, {}).get("count") or reps
    split = {k: {"ms": r["us"] / r["count"] / 1e3, "launches": r["count"] / calls}
             for k, r in out.items()}
    split["total"] = sum(r["us"] for r in out.values()) / calls / 1e3
    return split


def msm_split(args, reps: int = 5) -> dict:
    """`msm`'s device time split by kernel (`kernel_split`; the wrapper's
    fill included)."""
    from ouroboros_consensus_tpu_torch.ops.pk import msm as pm

    return kernel_split(lambda: pm.msm(*args), "msm_final_kernel", reps)


def msm_args(cols, depth: int):
    """`msm`'s arguments for a window's limb-first columns (on their
    device): agg_prep, the dedupe, then `msm_inputs`."""
    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa

    pts, scal, _flags, _eta, _lv = pa.agg_prep(*cols, kes_depth=depth)
    red, tpts, _ok = pa.window_tables(cols, pts, scal)
    if hasattr(pa, "agg_tables"):  # a tree whose dedupe leaves the reductions to agg_tables
        red = pa.agg_tables(red)
    return pa.msm_inputs(pts, scal, tpts, red)


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


def hold_dedupe(key: str, cols, pts, scal, lanes: int, dev, reps: int) -> dict:
    """The `dedupe` kernel against its plain version on the card, byte
    for byte (the slots and the B row mod L, slot points, ok_cap), through
    its one entry, `window_tables` (a window's key columns `cols`, points
    and scalar rows; the cap `aggregate._DEDUPE_CAP` at the call); with
    `reps`, both timed. -> hold's record (bytes: the keys, coefficients
    and B rows read once, the slot points read and written, the rows
    written)."""
    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa

    def kern():
        if dev.type != "cuda":  # a CPU rehearsal: the plain version
            return plain()
        return pa.window_tables(cols, pts, scal)

    def plain():
        return pa.window_tables_reduced_plain(cols, pts, scal, pa._DEDUPE_CAP)

    got = kern()
    ins = (*(cols[k] for k in pa.DEDUPE_KEYS), scal[pa.SC_Z1:pa.SC_Z3C + 1],
           scal[pa.SC_B1:pa.SC_B3 + 1], got[1])
    return hold(key, kern, plain, ins, lanes, dev, reps)


def hold_agg(tag: str, cols, n: int, dev, reps: int, depth: int, msm_twin: bool = True):
    """The aggregate's kernels on one window's limb-first columns (on
    `dev`) against their plain versions: `agg_prep` and `dedupe` byte for
    byte, `msm` as points (`msm_twin` False: not held; its plain version
    takes seconds on a tiled window's crowded buckets); with `reps`, each
    kernel timed, the dedupe also split by phase (`dedupe_stamps`). ->
    ({agg_prep, dedupe[, msm]: records, msm_work, msm_args},
    aggregate_window's verdicts)."""
    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
    from ouroboros_consensus_tpu_torch.ops.pk import msm as pm

    def prep():
        return pa.agg_prep(*cols, kes_depth=depth)

    recs = {"agg_prep": held(f"agg_prep ({tag}, {n} lanes)", prep,
                             lambda: pa.agg_prep_plain(*cols, kes_depth=depth),
                             cols, n, dev, reps)}
    if reps and dev.type == "cuda":
        st = recs["agg_prep"]["stamps"] = agg_stamps(cols, depth)
        log(f"agg_prep stamps ({tag}, {n} lanes): block {st['block_us']:.1f} us, path "
            f"{st['path']['warp']} ends {st['path']['end_us']:.1f} us "
            f"{json.dumps({k: round(v, 2) for k, v in st['path']['steps_us'].items()})}; "
            f"costs {json.dumps({k: round(v, 3) for k, v in st['costs_us'].items()})}")
    pts, scal, _flags, _eta, _lv = prep()
    recs["dedupe"] = hold_dedupe(f"dedupe ({tag}, {n} lanes)", cols, pts, scal, n, dev, reps)
    if reps and dev.type == "cuda":
        recs["dedupe"]["device_ms"] = kernel_split(
            lambda: pa.window_tables(cols, pts, scal), "dedupe_kernel")["total"]
        log(f"dedupe ({tag}, {n} lanes): device {recs['dedupe']['device_ms']:.4f} ms a call")
        st = recs["dedupe"]["stamps"] = dedupe_stamps(cols, pts, scal, 3)
        log(f"dedupe stamps ({tag}, {n} lanes): {json.dumps(st)}")
    red, tpts, _ok = pa.window_tables(cols, pts, scal)
    points, scalars, n_small, base = pa.msm_inputs(pts, scal, tpts, red)
    recs["msm_args"] = (points, scalars, n_small, base)
    if msm_twin:
        recs["msm"] = held(f"msm ({tag}, {n} lanes)",
                           lambda: pm.msm(points, scalars, n_small, base),
                           lambda: pm.msm_plain(points, scalars, n_small, base),
                           (points, scalars, base), n, dev, reps, points=True)
    if reps:
        recs["msm_work"] = msm_work(scalars, n_small)
    return recs, pa.aggregate_window(*cols, kes_depth=depth)


def spread_keys(lanes: int, distinct: int, share: int, seed: int):
    """A key column in which each of `distinct` keys takes at least one of
    `lanes` lanes (in seeded order), the keys sharing their first `share`
    bytes (and a third of them differing from another in the last byte
    alone), with seeded coefficients and points -> (key [32, lanes]
    int32, coeff [lanes, 32] uint8, pts [lanes, 40] int32), on the CPU."""
    import torch

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (distinct, 32))
    pool[:, :share] = pool[0, :share]
    pool[1::3, :31] = pool[0::3, :31][:len(pool[1::3])]
    pick = rng.permutation(np.concatenate([np.arange(distinct),
                                           rng.integers(0, distinct, lanes - distinct)]))
    key = np.ascontiguousarray(pool[pick].T, dtype=np.int32)
    coeff = rng.integers(0, 256, (lanes, 32)).astype(np.uint8)
    pts = rng.integers(-2**31, 2**31, (lanes, 40)).astype(np.int32)
    return torch.from_numpy(key), torch.from_numpy(coeff), torch.from_numpy(pts)


def dedupe_inputs(made, dev, seed: int):
    """Four key columns (spread_keys' triples) as a window that
    `window_tables` takes: the keys at their places among the 22 columns
    (DEDUPE_KEYS), their coefficients and points at theirs among the
    scalar and point rows, seeded B rows, the other rows zero. -> (cols,
    pts, scal) on `dev`."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa

    b = made[0][0].shape[-1]
    cols = {k: m[0].to(dev) for k, m in zip(pa.DEDUPE_KEYS, made)}
    pts = torch.zeros((pa.N_PTS, b, 40), dtype=torch.int32)
    pts[pa.PT_RE:pa.PT_Y + 1] = torch.stack([m[2] for m in made])
    scal = torch.zeros((pa.N_SC, b, 32), dtype=torch.uint8)
    scal[pa.SC_Z1:pa.SC_Z3C + 1] = torch.stack([m[1] for m in made])
    rng = np.random.default_rng(seed)
    brows = rng.integers(0, 256, (3, b, 32)).astype(np.uint8)
    scal[pa.SC_B1:pa.SC_B3 + 1] = torch.from_numpy(brows)
    return cols, pts.to(dev), scal.to(dev)


def dedupe_windows(dev, lanes: int = 8192, seed: int = 19) -> dict:
    """The `dedupe` kernel byte for byte against its plain version on the
    card beyond the aggregate's own windows (whose one pool gives each
    column a key or two), each through `window_tables` with its B rows:
    one lane and 8 lanes; four columns of 256 distinct keys (the cap
    exactly: ok_cap true), of 300 (ok_cap false); four columns whose keys
    share their first 8, 16, 24 and 31 bytes, 200 keys a column (a warp
    of many keys ranks lane by lane) and 3 to 8 (a warp's keys in turn);
    one lane past `lanes` (a tile of one lane); 20,000 lanes (more tiles
    and one merge level more than 8,192); 70,000 lanes, one column a key a
    lane (its merges searched in L2); and three groups in two slots (cap
    2); each column's groups counted on the CPU against ok_cap. -> {tag:
    record}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa

    out = {}
    cases = (("one_lane", 1, [(1, 0)] * 4),
             ("eight", 8, [(1, 0), (2, 0), (1, 0), (1, 0)]),
             ("cap_exact", lanes, [(pa._DEDUPE_CAP, 0)] * 4),
             ("over_cap", lanes, [(300, 0)] * 4),
             ("prefix", lanes, [(200, 8), (200, 16), (200, 24), (200, 31)]),
             ("few_prefix", lanes, [(4, 8), (6, 16), (8, 24), (3, 31)]),
             ("past_tile", lanes + 1, [(300, 8), (5, 0), (1, 0), (257, 0)]),
             ("wide", 20000, WIDE_SPEC),
             ("epoch_wide", 70000, [(70000, 0), (1, 0), (3000, 8), (256, 0)]))
    for tag, n, spec in cases:
        made = [spread_keys(n, d, share, seed + c) for c, (d, share) in enumerate(spec)]
        win = dedupe_inputs(made, dev, seed)
        reps = 5 if tag == "wide" else 0  # the wide window timed
        out[tag] = hold_dedupe(f"dedupe ({tag}, {n} lanes)", *win, n, dev, reps)
        ok = pa.window_tables(*win)[2].tolist()
        if ok != [d <= pa._DEDUPE_CAP for d, _s in spec]:
            raise AssertionError(f"dedupe {tag}: ok_cap {ok} for {spec}")
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (3, 32))
    pool[1, :31] = pool[0, :31]
    key = torch.from_numpy(np.ascontiguousarray(pool[np.arange(12) % 3].T, dtype=np.int32))
    coeff = torch.arange(12 * 32).reshape(12, 32).remainder(251).to(torch.uint8)
    ptsk = torch.arange(12 * 40, dtype=torch.int32).reshape(12, 40)
    win = dedupe_inputs([(key, coeff, ptsk)] * 4, dev, seed)
    cap = pa._DEDUPE_CAP
    pa._DEDUPE_CAP = 2  # window_tables reads the cap at the call
    try:
        out["cap2"] = hold_dedupe("dedupe (three groups in two slots)", *win, 12, dev, 0)
        if any(pa.window_tables(*win)[2].tolist()):
            raise AssertionError("the dedupe's cap-2 overflow passed")
    finally:
        pa._DEDUPE_CAP = cap
    return out


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
    """The window aggregate's four kernels against their plain versions
    on the card, at each width of `lanes_list` (the first lanes of a
    tiled bc window of `distinct` headers; `hold_agg`), clean and on a
    copy with a torsion-offset R_k, an OCert s flipped and a wrong β in
    three lanes (at the widest, msm is not held on that copy); then
    `dedupe_windows`. The whole
    aggregate_window: the identity on the clean window (agg_ok, flags,
    eta and leader value equal to the five stage kernels'), not on the
    dirty one (agg_ok false; the cheap checks flag the β lane). Each
    kernel is timed on the clean window at each width, and msm's launches
    split by kernel at the narrowest (`msm_split`). -> {agg_prep, dedupe,
    msm: records at the widest}."""
    depth = 7
    top = max(lanes_list)
    clean, _ = tiled_window(top, distinct, seed, workdir, "bc")
    dirty = [c.clone() for c in clean]
    add_to_encoding(dirty[7], 3, torsion8())  # R_k + T8
    dirty[2][0, 5] ^= 1  # an OCert s
    dirty[19][0, 6] ^= 1  # a declared β
    names = ("agg_prep", "dedupe", "msm")
    recs: dict = {k: {} for k in names}
    split = None
    for n in lanes_list:
        for tag, src in (("clean", clean), ("dirty", dirty)):
            cols = [c[..., :n].contiguous().to(dev) for c in src]
            got, av = hold_agg(tag, cols, n, dev, reps if tag == "clean" else 0, depth,
                               msm_twin=tag == "clean" or n < top)
            if tag == "clean":
                agg_matches_stages(f"clean {n}-lane", av, cols, depth)
                got["msm"]["work"] = got["msm_work"]
                for key in names:
                    recs[key][n] = got[key]
                if n == min(lanes_list) and dev.type == "cuda":
                    split = msm_split(got["msm_args"])
                    log(f"msm split ({n} lanes, ms a launch): {json.dumps(split)}")
            elif bool(av.agg_ok) or n > 6 and int(av.flags[2, 6]) != 0:
                raise AssertionError(f"the dirty {n}-lane window's aggregate passed")
    extra = dedupe_windows(dev, max(top, 1024))  # room for 300 keys in a CPU rehearsal
    out = {}
    for key in names:
        out[key] = {**recs[key][top]}
        if dev.type == "cuda":
            out[key]["ms_by_lanes"] = {n: r["ms"] for n, r in recs[key].items()}
    one = [c[..., :1].clone() for c in clean]
    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa

    out["agg_prep"].update(agg_prep_work(one, depth))
    out["agg_prep"]["stamps_by_lanes"] = {n: r["stamps"] for n, r in recs["agg_prep"].items()
                                          if "stamps" in r}
    w = out["msm"]["work"]
    out["msm"]["products"] = w["adds"] * 900 + w["dbls"] * 620
    out["msm"]["split_by_lanes"] = {min(lanes_list): split}
    out["dedupe"]["windows"] = {k: {"max_abs_err": r["max_abs_err"], "bytes": r["bytes"],
                                    **({"ms": r["ms"]} if "ms" in r else {})}
                                for k, r in extra.items()}
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
    (`hold_agg`), msm's launches split by kernel (`msm_split`), and the
    window's aggregate the identity with the stage kernels' verdicts. The
    records replace phase_agg's in `stages` (the kernels line's ms and
    bound are this window's); phase_agg's stay beside them under
    `tiled`."""
    cols = [c.contiguous().to(dev) for c in chain_window(db, lanes)]
    depth = bench_params().kes_depth
    got, av = hold_agg("chain window", cols, lanes, dev, reps, depth)
    agg_matches_stages(f"chain {lanes}-lane", av, cols, depth)
    got["msm"]["work"] = got["msm_work"]
    if dev.type == "cuda":
        split = msm_split(got["msm_args"])
        log(f"msm split (chain window, {lanes} lanes, ms a launch): {json.dumps(split)}")
        got["msm"]["split_by_lanes"] = {**stages["msm"].get("split_by_lanes", {}),
                                        "chain": split}
        got["msm"]["device_ms"] = split["total"]
    for key in ("agg_prep", "dedupe", "msm"):
        tiled = stages[key]
        rec = got[key]
        rec["tiled"] = {k: tiled[k] for k in ("ms", "plain_ms", "lanes", "bytes", "work",
                                              "products") if k in tiled}
        rec["ms_by_lanes"] = tiled.get("ms_by_lanes")  # the tiled windows'
        for k in ("field_ops", "field_ops_batched", "inversion_ops", "hash_ops", "windows",
                  "stamps_by_lanes"):
            if k in tiled:
                rec[k] = tiled[k]
        stages[key] = rec
    if "stamps" in stages["agg_prep"]:
        prep = stages["agg_prep"]
        prep["stamps_by_lanes"] = {**prep.get("stamps_by_lanes", {}), "chain": prep.pop("stamps")}
        prep["dependent_path"] = agg_dependent_path(prep["stamps_by_lanes"])
        log(f"agg_prep dependent path: {json.dumps(prep['dependent_path'])}")
    w = stages["msm"]["work"]
    stages["msm"]["products"] = w["adds"] * 900 + w["dbls"] * 620
    log(f"aggregate on a {lanes}-lane chain window: msm work {json.dumps(w)} "
        f"(tiled {json.dumps(stages['msm']['tiled'].get('work'))})")


# ---------------------------------------------------------------------------
# Phase 2c: the forge's kernels
# ---------------------------------------------------------------------------


def forge_role_ops() -> dict:
    """Field multiplies and squarings one sweep lane spends on each part of
    the kernel (warp 0: the hash to the curve; warp 2: H's compression;
    pair A: Γ = x·H with its table, 8Γ; pair B: k·B, k·H; the finish: the
    four compressions), counted on the twin's pieces on one CPU lane. A
    pair splits each point operation's products over its two warps, so the
    dependent path in wide products a warp is the hash, H's compression,
    half of pair B's, and the finish (the finish's inversion counted whole,
    though the kernel batches it over the block)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
    from ouroboros_consensus_tpu_torch.ops.pk import field as fe
    from ouroboros_consensus_tpu_torch.ops.pk import verify as pv

    b = torch.arange(32, dtype=torch.int64).reshape(32, 1)
    h = pv.hash_to_curve(b, b)
    parts = {
        "hash_to_curve": lambda: pv.hash_to_curve(b, b),
        "h_compression": lambda: pc.compress_many([h]),
        "pair_a": lambda: pc.mul_cofactor(pc.scalar_mul_w4(fe.nibbles_msb(b, 32), h)),
        "pair_b": lambda: (pc.base_mul_w8(b), pc.scalar_mul_w4(fe.nibbles_msb(b, 32), h)),
        "finish": lambda: pc.compress_many([h, h, h, h]),
    }
    out = {k: count_field_ops(fn) for k, fn in parts.items()}
    for rec in out.values():
        rec["wide_products"] = wide_products(rec)
    out["dependent_path_wide_products"] = (
        out["hash_to_curve"]["wide_products"] + out["h_compression"]["wide_products"]
        + out["pair_b"]["wide_products"] // 2 + out["finish"]["wide_products"])
    return out


def phase_forge(dev, reps: int = 5) -> dict:
    """The forge's two kernels against their plain versions on the card:
    `forge_sweep` on 256 lanes of three pools under a set epoch nonce and
    on one full election window (window_slots(1) lanes) of the main
    path's one pool under the neutral nonce, timed there; `ed_sign` as
    `hold_ed_sign` holds it. -> {forge_sweep: rec, ed_sign: rec} with the
    twins' field work a lane (the bound's) and the sweep's split by warp
    (forge_role_ops)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.ops.pk import prove as pp
    from ouroboros_consensus_tpu_torch.protocol import forge as pforge
    from ouroboros_consensus_tpu_torch.testing import synth

    params = bench_params()
    full = pforge.window_slots(1)
    recs, tabs = {}, {}
    for tag, seeds, lanes, nonce, r in (("3 pools, set nonce", (0, 1, 2), 256, bytes(range(32)), 1),
                                        ("1 pool, neutral nonce", (0,), full, None, reps)):
        pools = [synth.make_pool(n, kes_depth=params.kes_depth) for n in seeds]
        thr = pforge.pool_thresholds(params, synth.make_ledger_view(pools), pools)
        table = pforge.device_table(pforge.stage_pools(pools), thr, dev)
        nt = None if nonce is None else torch.tensor(list(nonce), dtype=torch.uint8, device=dev)
        slot0 = 40_000
        recs[lanes] = hold(f"forge_sweep ({tag})", lambda: K.forge_sweep(table, slot0, lanes, nt),
                           lambda: pp.forge_sweep_plain(table, slot0, lanes, nt),
                           (table,) if nt is None else (table, nt), lanes, dev, r)
        tabs[lanes] = (table, slot0, lanes, nt)
    sweep = recs[full]
    sweep["ms_by_lanes"] = {full: sweep.get("ms")}
    zero = np.zeros((1, 32), np.uint8)
    cpu = pforge.device_table(pforge.stage_pools([synth.make_pool(0)]), (zero, zero), "cpu")
    sweep["field_ops"] = count_field_ops(lambda: pp.forge_sweep_plain(cpu, 0, 1, None))
    sweep["dependent_path"] = forge_role_ops()
    if dev.type == "cuda":  # the stamped build at one block and at a full window
        from ouroboros_consensus_tpu_torch.ops.pk import build

        fn = build.kernel_lib("forge_stamps")
        sweep["stamps_by_lanes"] = {n: forge_stamps(fn, *args[:2], n, args[3])
                                    for n, args in ((32, tabs[256]), (full, tabs[full]))}
        for n, tl in sweep["stamps_by_lanes"].items():
            log(f"forge_sweep stamps {n} lanes: {json.dumps(tl['path'])}")
    rec = hold_ed_sign(dev, reps)
    log(f"forge kernels: the sweep's field work a lane {json.dumps(sweep['field_ops'])}, "
        f"by warp {json.dumps(sweep['dependent_path'])}; ed_sign's {json.dumps(rec['field_ops'])}")
    return {"forge_sweep": sweep, "ed_sign": rec}


# ed_sign's widths: the main path's OCert batch (two signables), serve-1024's
# election span ((16 pools + 1) x 2 counters), and 256 and 4,096 messages of 0
# to 200 bytes (1 to 3 SHA-512 blocks)
ED_SIGN_LANES = (2, 34, 256, 4096)
ED_SIGN_STEPS = ("r's hash", "r mod L", "R = r·B", "R compressed", "h's hash",
                 "h mod L, s = r + h·a")


def ed_sign_inputs(lanes: int, dev, long_last: bool = False) -> list:
    """The seeded signer inputs at `lanes` (stage_sign_np's six arrays on
    `dev`): 48-byte OCert signables at 2 and 34 lanes, else messages of
    k mod 201 bytes; with `long_last` the last message has 400 bytes (four
    SHA-512 blocks a side: h's fourth is read from global memory)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import prove as pp

    seeds = [bytes([k % 256, k // 256]) * 16 for k in range(lanes)]
    msgs = [bytes(48) if lanes <= 34 else bytes([k % 251]) * (k % 201) for k in range(lanes)]
    if long_last:
        msgs[-1] = bytes([lanes % 251]) * 400
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in pp.stage_sign_np(seeds, msgs)]


def ed_sign_stamps(fn, staged) -> dict:
    """The stamped signer (`fn`: ed_sign_stamps.cu's entry) on these
    inputs, its second launch's signatures held to the shipped kernel's: each
    phase's µs (ED_SIGN_STEPS, the mean over the signables at the card's
    maximum SM clock, from the phase before's stamp), when each ends, and
    the span."""
    import torch

    from ouroboros_consensus_tpu_torch.device import max_sm_clock_hz
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    dev, b = staged[0].device, staged[0].shape[0]
    stamps = torch.zeros((b, len(ED_SIGN_STEPS) + 1), dtype=torch.int64, device=dev)
    for _ in range(2):  # the second launch's stamps: the first warms the caches
        got, _bad = K._ed_sign_launch(lambda *a: fn(*a[:-1], K._p(stamps), a[-1]),
                                      K._stream(dev), *staged)
    torch.cuda.synchronize()
    if not torch.equal(got, K.ed_sign(*staged)):
        raise AssertionError("the stamped ed_sign differs from the shipped kernel")
    us = 1e6 / max_sm_clock_hz()
    t = stamps.cpu().to(torch.float64)
    start = t[:, 0]
    step = {n: float((t[:, k + 1] - t[:, k]).mean()) * us for k, n in enumerate(ED_SIGN_STEPS)}
    at = {n: float((t[:, k + 1] - start).mean()) * us for k, n in enumerate(ED_SIGN_STEPS)}
    return {"lanes": b, "step_us": step, "at_us": at,
            "span_us": float((t[:, -1] - start).max()) * us}


def ed_sign_times(dev, lanes, reps: int) -> dict:
    """`ed_sign` of the tree this process imports at each of `lanes`: the
    launch alone (`kernels._ed_sign_launch`, the tree's own entry), the
    wrapper, and the wrapper with its caller's read of the signatures
    (`.cpu()`, as `forge.sign_ocerts_batch` reads them), CUDA events over
    `reps` calls, and a digest of the wrapper's signatures. -> {lanes:
    {"launch_ms", "wrapper_ms", "read_ms", "digest"}}."""
    import hashlib

    from ouroboros_consensus_tpu_torch.device import time_ms
    from ouroboros_consensus_tpu_torch.ops.pk import build
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    fn = build.kernel_lib("forge", "pk_ed_sign")
    out = {}
    for n in lanes:
        staged = ed_sign_inputs(n, dev)
        st = K._stream(dev)
        got = K.ed_sign(*staged).cpu().numpy()
        out[str(n)] = {
            "launch_ms": time_ms(lambda s=staged: K._ed_sign_launch(fn, st, *s), reps),
            "wrapper_ms": time_ms(lambda s=staged: K.ed_sign(*s), reps),
            "read_ms": time_ms(lambda s=staged: K.ed_sign(*s).cpu(), reps),
            "digest": hashlib.sha256(got.tobytes()).hexdigest()[:16]}
    return out


def hold_ed_sign(dev, reps: int = 5) -> dict:
    """`ed_sign` against its plain version (`hold`) at ED_SIGN_LANES (at
    256, the last message of 400 bytes), the launch alone and the wrapper timed at each on the card (CUDA events;
    the plain version timed at 2 lanes), and the stamped build
    (`ed_sign_stamps`) at 2 and 256. -> the record at 2 lanes (`ms` the
    launch alone, `wrapper_ms` the wrapper's), with `ms_by_lanes`,
    `wrapper_ms_by_lanes`, `stamps_by_lanes` and the twin's field work a
    lane."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.ops.pk import prove as pp

    sign = {}
    for lanes in ED_SIGN_LANES:
        long_last = lanes == 256  # NB = 4: h's blocks past the staged three
        staged = ed_sign_inputs(lanes, dev, long_last)
        sign[lanes] = hold(f"ed_sign ({lanes} signables{', one of 400 bytes' * long_last})",
                           lambda: K.ed_sign(*staged), lambda: pp.ed_sign_plain(*staged),
                           staged, lanes, dev, reps if lanes == 2 else 0)
    rec = sign[2]
    if dev.type == "cuda":
        from ouroboros_consensus_tpu_torch.ops.pk import build

        times = ed_sign_times(dev, ED_SIGN_LANES, max(reps, 20))
        rec["ms"] = times["2"]["launch_ms"]
        rec["wrapper_ms"] = times["2"]["wrapper_ms"]
        rec["ms_by_lanes"] = {n: times[str(n)]["launch_ms"] for n in ED_SIGN_LANES}
        rec["wrapper_ms_by_lanes"] = {n: times[str(n)]["wrapper_ms"] for n in ED_SIGN_LANES}
        rec["read_ms_by_lanes"] = {n: times[str(n)]["read_ms"] for n in ED_SIGN_LANES}
        fn = build.kernel_lib("ed_sign_stamps")
        rec["stamps_by_lanes"] = {n: ed_sign_stamps(fn, ed_sign_inputs(n, dev)) for n in (2, 256)}
        for n in ED_SIGN_LANES:
            log(f"ed_sign {n} signables: the launch alone {times[str(n)]['launch_ms']:.4f} ms, "
                f"the wrapper {times[str(n)]['wrapper_ms']:.4f} ms, with the caller's read "
                f"{times[str(n)]['read_ms']:.4f} ms")
        for n, tl in rec["stamps_by_lanes"].items():
            log(f"ed_sign stamps {n} signables: {json.dumps(tl)}")
    one = [torch.from_numpy(np.ascontiguousarray(a))
           for a in pp.stage_sign_np([bytes(32)], [bytes(48)])]
    rec["field_ops"] = count_field_ops(lambda: pp.ed_sign_plain(*one))
    return rec


# the stamped builds' steps (csrc/ed_verify.cu, csrc/forge.cu: EDV_STAMP,
# FS_STAMP): {warp: {stamp: the step it ends}}; a step after a wait
# includes the wait
_EDV_AFTER = {2: "s·B parts' sum, table of −A (quad), with the barrier's wait",
              3: "h·(−A) chain", 4: "s·B windows 25-31 and the addition (quad)", 5: "compare"}
EDV_STEPS = {0: {1: "hash h, s·B windows 0-9", **_EDV_AFTER,
                 6: "P compressed (the first version's tail, off the path)"},
             1: {1: "A", **_EDV_AFTER},
             2: {1: "R", **_EDV_AFTER},
             3: {1: "s < L, s·B windows 10-24", **_EDV_AFTER}}
FS_STEPS = {0: {1: "H (hash to the curve)", 2: "table of H (pair A)",
                3: "k·B windows 0-13 (pair A)", 4: "Γ, 8Γ (pair A)",
                8: "wait, points stored, tree, root inverse", 9: "encodings", 10: "c, s"},
            1: {2: "table of H (pair A)", 3: "k·B windows 0-13 (pair A)", 4: "Γ, 8Γ (pair A)",
                10: "wait, β, leader value"},
            2: {2: "H's tree, k", 3: "k·H (pair B)", 5: "k·B windows 14-31 (pair B)"},
            3: {3: "k·H (pair B)", 5: "k·B windows 14-31 (pair B)"}}


def stamp_timeline(stamps, steps: dict) -> dict:
    """clock64 stamps [blocks][warps][n] -> each warp's steps as µs from its
    block's first stamp (the mean over blocks, at the card's maximum SM
    clock), each step's own µs, and the block's span."""
    import torch

    from ouroboros_consensus_tpu_torch.device import max_sm_clock_hz

    us = 1e6 / max_sm_clock_hz()
    t = stamps.cpu().to(torch.float64)
    start = t[:, :, 0].min(1).values
    out = {"blocks": int(t.shape[0]), "warps": {}}
    ends = []
    for w, named in steps.items():
        at, own, prev = {}, {}, t[:, w, 0]
        for k, name in sorted(named.items()):
            at[name] = float((t[:, w, k] - start).mean()) * us
            own[name] = float((t[:, w, k] - prev).mean()) * us
            prev = t[:, w, k]
            ends.append(t[:, w, k])
        out["warps"][str(w)] = {"at_us": at, "step_us": own}
    out["block_us"] = float((torch.stack(ends).max(0).values - start).mean()) * us
    return out


def ed_verify_stamps(fn, cols) -> dict:
    """One launch of the stamped ed_verify (`fn`: ed_verify_stamps.cu's
    entry) on these columns, its verdicts held to the shipped kernel's:
    the timeline by warp (EDV_STEPS), phase 1's longest role, the chain,
    the additions and the compare (warp 0), and the first version's tail
    (P's compression, timed after the verdict: what the design took off
    the path)."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    b, dev = cols[0].shape[-1], cols[0].device
    stamps = torch.zeros((-(-b // 32), 4, 8), dtype=torch.int64, device=dev)
    got = K._ed_verify_launch(lambda *a: fn(*a[:-1], K._p(stamps), a[-1]), K._stream(dev),
                              *cols)
    torch.cuda.synchronize()
    if not torch.equal(got, K.ed_verify(*cols)):
        raise AssertionError("the stamped ed_verify differs from the shipped kernel")
    tl = stamp_timeline(stamps, EDV_STEPS)
    w = tl["warps"]
    phase1 = {r: w[r]["at_us"][EDV_STEPS[int(r)][1]] for r in w}
    tl["path"] = {"phase1_us": max(phase1.values()), "phase1_by_warp_us": phase1,
                  "table_us": w["0"]["step_us"][_EDV_AFTER[2]],
                  "chain_us": w["0"]["step_us"]["h·(−A) chain"],
                  "sb_rest_us": w["0"]["step_us"][_EDV_AFTER[4]],
                  "compare_us": w["0"]["step_us"]["compare"],
                  "verdict_at_us": w["0"]["at_us"]["compare"],
                  "first_version_tail_us": w["0"]["step_us"][EDV_STEPS[0][6]]}
    return tl


def forge_stamps(fn, table, slot0: int, b: int, nonce) -> dict:
    """One launch of the stamped sweep (`fn`: forge_stamps.cu's entry), its
    rows held to the shipped kernel's: the timeline by warp (FS_STEPS) and
    the dependent path."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    dev = table.device
    stamps = torch.zeros((-(-b // 32), 4, 11), dtype=torch.int64, device=dev)
    got = K._forge_sweep_launch(lambda *a: fn(*a[:-1], K._p(stamps), a[-1]), K._stream(dev),
                                table, slot0, b, nonce)
    torch.cuda.synchronize()
    if not torch.equal(got, K.forge_sweep(table, slot0, b, nonce)):
        raise AssertionError("the stamped forge_sweep differs from the shipped kernel")
    tl = stamp_timeline(stamps, FS_STEPS)
    w = tl["warps"]
    a_end, b_end = w["0"]["at_us"][FS_STEPS[0][4]], w["2"]["at_us"][FS_STEPS[2][5]]
    tl["path"] = {"h_us": w["0"]["at_us"]["H (hash to the curve)"],
                  "table_us": w["0"]["at_us"]["table of H (pair A)"],
                  "k_us": w["2"]["at_us"]["H's tree, k"],
                  "gamma_end_us": w["0"]["at_us"]["Γ, 8Γ (pair A)"],
                  "v_end_us": w["2"]["at_us"]["k·H (pair B)"],
                  "pair_a_end_us": a_end, "pair_b_end_us": b_end,
                  "tree_us": w["0"]["at_us"][FS_STEPS[0][8]] - max(a_end, b_end),
                  "encodings_us": w["0"]["step_us"]["encodings"],
                  "challenge_us": w["0"]["step_us"]["c, s"],
                  "end_us": max(w["0"]["at_us"]["c, s"], w["1"]["at_us"][FS_STEPS[1][10]])}
    return tl


def verify_forge_inputs(dev, seed: int = 29) -> dict:
    """The seeded inputs `verify_forge_times` times: ed_verify's
    columns at 8, 128 and 8,192 lanes (messages of 0 to 300 bytes), the
    Byron segment's 21,600 (100 to 120) and 65,536 (32 bytes), no lane
    corrupted; the sweep's pool table of three pools under a set nonce
    (256 lanes) and of the main path's one pool under the neutral nonce (a
    full election window). -> {"ed_verify": {lanes: cols}, "forge_sweep":
    {tag: (table, slot0, lanes, nonce)}}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops import ed25519_batch as eb
    from ouroboros_consensus_tpu_torch.protocol import forge as pforge
    from ouroboros_consensus_tpu_torch.testing import synth

    rng = np.random.default_rng(seed)
    ed = {}
    for lanes in (8, 128, 8192, BYRON_LANES, WITNESS_LANES):
        if lanes == WITNESS_LANES:
            msg_len = lambda r, n: np.full(n, 32)  # noqa: E731
        elif lanes == BYRON_LANES:
            msg_len = lambda r, n: r.integers(100, 121, n)  # noqa: E731
        else:
            msg_len = lambda r, n: np.concatenate([[0, 150, 300], r.integers(0, 301, n - 3)])[:n]  # noqa: E731
        pks, sigs, msgs, _ = ed_verify_inputs(lanes, rng, msg_len)
        ed[lanes] = eb.limb_columns(eb.stage_np(pks, sigs, msgs), dev)
    params = bench_params()
    sweep = {}
    for tag, seeds, lanes, nonce in (("256x3", (0, 1, 2), 256, bytes(range(32))),
                                     (str(pforge.window_slots(1)), (0,), pforge.window_slots(1),
                                      None)):
        pools = [synth.make_pool(n, kes_depth=params.kes_depth) for n in seeds]
        thr = pforge.pool_thresholds(params, synth.make_ledger_view(pools), pools)
        table = pforge.device_table(pforge.stage_pools(pools), thr, dev)
        nt = None if nonce is None else torch.tensor(list(nonce), dtype=torch.uint8, device=dev)
        sweep[tag] = (table, 40_000, lanes, nt)
    return {"ed_verify": ed, "forge_sweep": sweep}


def verify_forge_times(dev, reps: int = 5) -> dict:
    """`ed_verify` at its five widths and `forge_sweep` at its two through
    the wrappers of the tree this process imports (CUDA events over `reps`
    calls), and `ed_sign` at 2, 256 and 4,096 signables (`ed_sign_times`:
    the launch alone, the wrapper, with the caller's read), with a digest
    of each output so that two trees' turns can be held to each other.
    -> {"ed_verify": {lanes: ms}, "forge_sweep": {tag: ms}, "ed_sign":
    {lanes: {...}}, "digests": {...}}."""
    import hashlib

    from ouroboros_consensus_tpu_torch.device import time_ms
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    ins = verify_forge_inputs(dev)
    out = {"ed_verify": {}, "forge_sweep": {}, "digests": {}}
    for lanes, cols in ins["ed_verify"].items():
        out["ed_verify"][str(lanes)] = time_ms(lambda c=cols: K.ed_verify(*c), reps)
        got = K.ed_verify(*cols).cpu().numpy()
        out["digests"][f"ed_verify {lanes}"] = hashlib.sha256(got.tobytes()).hexdigest()[:16]
    for tag, args in ins["forge_sweep"].items():
        out["forge_sweep"][tag] = time_ms(lambda a=args: K.forge_sweep(*a), reps)
        got = K.forge_sweep(*args).cpu().numpy()
        out["digests"][f"forge_sweep {tag}"] = hashlib.sha256(got.tobytes()).hexdigest()[:16]
    out["ed_sign"] = ed_sign_times(dev, (2, 256, 4096), max(reps, 20))
    for n, rec in out["ed_sign"].items():
        out["digests"][f"ed_sign {n}"] = rec.pop("digest")
    return out


ED_VERIFY_KINDS = ("r_byte", "s_plus_l", "msg_byte", "offcurve_a", "noncanon_a", "x0_sign")
# R's encodings where a byte compare of P's compression and a decoded R
# compared projectively could part (tests/test_torch_ed_verify_edges.py
# holds the host build to the JAX package on these and more): with s = h·a,
# s·B − h·A is the identity, so R's decoding alone decides the verdict
ED_VERIFY_R_KINDS = ("r_identity_p1", "r_x0_sign", "r_y_p", "r_order8", "r_identity")
ED_VERIFY_TRUE = ("r_identity",)  # the kinds whose verdict is true
# a point of order 8 (compressed): L·Q for the curve point Q of smallest y
ORDER8 = bytes.fromhex("c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a")
BYRON_LANES = 21_600  # the mainnet-shaped Byron segment's signatures (phase 3h)
WITNESS_LANES = 65_536  # 64k standalone tx-witness signatures, 32-byte messages


def sign_with_r(seed: bytes, pk: bytes, msg: bytes, r_enc: bytes) -> bytes:
    """A signature of `msg` under `seed` whose R bytes are `r_enc` and
    s = h·a mod L (h = SHA-512(R ‖ A ‖ M), a the clamped secret scalar), so
    s·B = h·A: true exactly where R decodes to the identity."""
    import hashlib

    from ouroboros_consensus_tpu_torch.ops.pk import field as fe

    a = int.from_bytes(hashlib.sha512(seed).digest()[:32], "little")
    a = (a & ((1 << 254) - 8)) | (1 << 254)
    h = int.from_bytes(hashlib.sha512(r_enc + pk + msg).digest(), "little") % fe.L
    return r_enc + (h * a % fe.L).to_bytes(32, "little")


def ed_verify_inputs(lanes: int, rng: np.random.Generator, msg_len, kinds=()):
    """`lanes` natively signed (pk, sig, msg) triples over 256 seeded keys,
    message lengths from `msg_len(rng, n)`, one lane of each of `kinds`
    (of ED_VERIFY_KINDS and ED_VERIFY_R_KINDS) corrupted or re-signed.
    -> (pks, sigs, msgs, {kind: lane})."""
    from ouroboros_consensus_tpu_torch import native
    from ouroboros_consensus_tpu_torch.ops.pk import field as fe

    seeds = [rng.bytes(32) for _ in range(min(lanes, 256))]
    keys = [native.ed25519_public(sd) for sd in seeds]
    lens = msg_len(rng, lanes)
    msgs = [rng.bytes(int(n)) for n in lens]
    pks = [keys[i % len(keys)] for i in range(lanes)]
    sigs = [native.ed25519_sign(seeds[i % len(seeds)], m) for i, m in enumerate(msgs)]
    enc = lambda y, sign=0: (y | sign << 255).to_bytes(32, "little")  # noqa: E731
    r_of = {"r_identity_p1": enc(fe.P + 1), "r_x0_sign": enc(1, 1), "r_order8": ORDER8,
            "r_identity": enc(1)}
    picked = rng.choice(lanes, size=len(kinds), replace=False).tolist() if kinds else []
    for kind, i in zip(kinds, picked):
        if kind == "r_byte":
            sigs[i] = bytes([sigs[i][0] ^ 0x10]) + sigs[i][1:]
        elif kind == "s_plus_l":
            s_big = int.from_bytes(sigs[i][32:], "little") + fe.L
            sigs[i] = sigs[i][:32] + s_big.to_bytes(32, "little")
        elif kind == "msg_byte":
            m = msgs[i] or b"\x00"
            msgs[i] = bytes([m[0] ^ 1]) + m[1:]
        elif kind == "offcurve_a":
            pks[i] = offcurve_y().to_bytes(32, "little")
        elif kind == "noncanon_a":
            pks[i] = fe.P.to_bytes(32, "little")  # y = p: not canonical
        elif kind == "x0_sign":  # y = 1, x = 0, sign bit set
            pks[i] = bytes([1]) + bytes(30) + bytes([0x80])
        elif kind == "r_y_p":  # y = p: a point of order 4, not canonical
            sigs[i] = enc(fe.P) + sigs[i][32:]
        else:
            sigs[i] = sign_with_r(seeds[i % len(seeds)], pks[i], msgs[i], r_of[kind])
    return pks, sigs, msgs, dict(zip(kinds, picked))


def phase_ed_verify(dev, reps: int = 5) -> dict:
    """Phase 3h-a: the batched Ed25519 verify kernel (`ed_verify`) against
    its plain version on the card, byte for byte, at 8, 128 and 8,192
    lanes of messages of 0 to 300 bytes (1 to 3 SHA-512 blocks side by side)
    with one lane of each kind: ED_VERIFY_KINDS (a flipped R byte, s + L, a
    flipped message byte, an off-curve A, a non-canonical A, x = 0 with the
    sign bit) and ED_VERIFY_R_KINDS (R the identity as y = p + 1, R with
    x = 0 and the sign bit, R with y = p, R of order 8, each false, and R
    the identity, true: all but R with y = p with s = h·a), whose verdict
    row must flag exactly the false ones (at 8 lanes the two sets in two
    batches); at the Byron
    segment's 21,600 lanes (messages of 100 to 120 bytes) also against the
    plain version, and there and at 65,536 lanes of 32-byte messages (the
    standalone witness batch) against the C++ verifier
    (native.ed25519_verify) lane by lane. Every size timed with CUDA events;
    the C++ verifier's host time beside it. -> the kernels line's record
    (the main path's 21,600 lanes)."""
    import torch

    from ouroboros_consensus_tpu_torch import native
    from ouroboros_consensus_tpu_torch.ops import ed25519_batch as eb
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K

    rng = np.random.default_rng(23)
    every = ED_VERIFY_KINDS + ED_VERIFY_R_KINDS
    sizes = ((8, ED_VERIFY_KINDS, True), (8, ED_VERIFY_R_KINDS, True), (128, every, True),
             (8192, every, True), (BYRON_LANES, (), True), (WITNESS_LANES, (), False))
    recs, native_ms, stamp_cols = {}, {}, {}
    for lanes, planted, twin in sizes:
        if lanes == WITNESS_LANES:
            msg_len = lambda r, n: np.full(n, 32)  # noqa: E731
        elif lanes == BYRON_LANES:
            msg_len = lambda r, n: r.integers(100, 121, n)  # noqa: E731
        else:
            # lengths 0, 150 and 300 first: one, two and three blocks in every batch
            msg_len = lambda r, n: np.concatenate([[0, 150, 300], r.integers(0, 301, n - 3)])  # noqa: E731
        pks, sigs, msgs, kinds = ed_verify_inputs(lanes, rng, msg_len, planted)
        staged = eb.stage_np(pks, sigs, msgs)
        cols = eb.limb_columns(staged, dev)
        stamp_cols.setdefault(lanes, cols)
        counts = sorted(set(staged.hnblocks.tolist()))
        if planted and counts != [1, 2, 3]:
            raise AssertionError(f"ed_verify at {lanes} lanes: block counts {counts}")
        kern = lambda c=cols: K.ed_verify(*c)  # noqa: E731
        if twin:
            rec = hold(f"ed_verify ({lanes} lanes)", kern, lambda c=cols: K.ed_verify_plain(*c),
                       cols, lanes, dev, reps)
        else:
            from ouroboros_consensus_tpu_torch.device import time_ms

            rec = {"lanes": lanes,
                   "bytes": sum(t.numel() * t.element_size() for t in cols) + 4 * lanes}
            if dev.type == "cuda":
                rec["ms"] = time_ms(kern, reps)
        if dev.type == "cuda":
            # the launch alone (the wrapper adds its block-count check,
            # which waits for the card): `ms`; the wrapper's: `wrapper_ms`
            from ouroboros_consensus_tpu_torch.device import time_ms
            from ouroboros_consensus_tpu_torch.ops.pk import build

            fn = build.kernel_lib("ed_verify")
            rec["wrapper_ms"] = rec["ms"]
            rec["ms"] = time_ms(lambda c=cols: K._ed_verify_launch(fn, K._stream(dev), *c), reps)
        got = kern()[0].cpu().numpy() != 0
        t0 = time.perf_counter()
        ref = np.array([native.ed25519_verify(p, sg, m) for p, sg, m in zip(pks, sigs, msgs)])
        native_ms.setdefault(lanes, (time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got, ref):
            bad = np.flatnonzero(got != ref)[:8].tolist()
            raise AssertionError(f"ed_verify at {lanes} lanes disagrees with the C++ "
                                 f"verifier on lanes {bad}")
        flagged = sorted(np.flatnonzero(~got).tolist())
        if flagged != sorted(i for k, i in kinds.items() if k not in ED_VERIFY_TRUE):
            raise AssertionError(f"ed_verify at {lanes} lanes flagged {flagged}, "
                                 f"planted {kinds} ({ED_VERIFY_TRUE} true)")
        recs.setdefault(lanes, rec)
        said = (f"; planted {json.dumps(kinds)}, flagged exactly those but "
                f"{[k for k in kinds if k in ED_VERIFY_TRUE]}") if kinds else ""
        log(f"ed_verify {lanes} lanes: blocks a lane {counts}, {rec.get('ms')} ms, "
            f"C++ verifier {native_ms[lanes]:.1f} ms (host, one thread){said}")
    rec = dict(recs[BYRON_LANES])
    if dev.type == "cuda":  # the stamped build at one block and at the two wide widths
        from ouroboros_consensus_tpu_torch.ops.pk import build

        fn = build.kernel_lib("ed_verify_stamps")
        rec["stamps_by_lanes"] = {n: ed_verify_stamps(fn, stamp_cols[n])
                                  for n in (8, BYRON_LANES, WITNESS_LANES)}
        rec["dependent_path"] = {n: tl["path"] for n, tl in rec["stamps_by_lanes"].items()}
        for n, path in rec["dependent_path"].items():
            log(f"ed_verify stamps {n} lanes: {json.dumps(path)}")
    rec["ms_by_lanes"] = {n: r.get("ms") for n, r in recs.items()}
    rec["wrapper_ms_by_lanes"] = {n: r.get("wrapper_ms") for n, r in recs.items()}
    rec["plain_ms_by_lanes"] = {n: r["plain_ms"] for n, r in recs.items() if "plain_ms" in r}
    rec["native_host_ms_by_lanes"] = native_ms
    one = [c[..., :1].cpu().clone() for c in eb.limb_columns(eb.stage_np(
        [bytes(range(32))], [bytes(64)], [bytes(110)]), "cpu")]
    rec["field_ops"] = count_field_ops(lambda: K.ed_verify_plain(*one))
    return rec


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def chain_format(proof_format: str, switch: int):
    """`proof_format`, or with `switch` > 0 draft-03 proofs below block
    `switch` and batch-compatible ones from there."""
    return (lambda k: 80 if k < switch else 128) if switch else proof_format


def forge_chain(db: str, headers: int, proof_format: str, switch: int) -> None:
    """Forge one main-path chain at `db` with bench.py's parameters (one
    pool, made from seed 0 as every phase makes it) through the per-slot
    loop (db_synthesizer's "loop" engine, testing/synth.synthesize's), in
    chain_format's proofs; its ForgeResult's times go to `<db>.forge.json`.
    Runs in a worker process."""
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_synthesizer

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    res = db_synthesizer.synthesize(db, params, pools, synth.make_ledger_view(pools),
                                    db_synthesizer.ForgeLimit(blocks=headers), engine="loop",
                                    proof_format=chain_format(proof_format, switch))
    with open(db + ".forge.json", "w") as f:
        json.dump({"wall_s": res.wall_s, "election_s": res.elect_s,
                   "assembly_s": res.assemble_s, "slots": res.n_slots}, f)
    log(f"forged {headers} headers at {os.path.basename(db)} in "
        f"{res.wall_s:.1f} s (worker process)")


# phase 3h: the mixed-era composite at mainnet's Byron shape (k = 2,160,
# 21,600-slot epochs, 7 genesis delegates, a 0.22 signing threshold,
# CompactSum7 KES), one epoch an era over 64,800 slots. Cuts against
# mainnet (PERF.md §4): f = 1 in Shelley and Babbage over 21,600-slot
# epochs (mainnet's 21,600 blocks an epoch), one pool, and the
# reference composite's fixed 100 slots a KES period
CARDANO = dict(byron_epochs=1, byron_epoch_length=21_600, shelley_epochs=1,
               epoch_length=21_600, n_delegs=7, shelley_d=(1, 2), k=2160, kes_depth=7,
               pbft_threshold=(22, 100))
CARDANO_SLOTS = 64_800


def cardano_config(**over):
    from fractions import Fraction

    from ouroboros_consensus_tpu_torch.hardfork import composite

    kw = {k: Fraction(*v) if isinstance(v, tuple) else v for k, v in {**CARDANO, **over}.items()}
    return composite.CardanoMockConfig(**kw)


def forge_cardano(db: str) -> None:
    """Forge phase 3h's composite at `db` through composite.synthesize;
    its wall goes to `<db>.forge.json`. Runs in a worker process."""
    from ouroboros_consensus_tpu_torch.hardfork import composite

    t0 = time.monotonic()
    n = composite.synthesize(db, cardano_config(), CARDANO_SLOTS)
    with open(db + ".forge.json", "w") as f:
        json.dump({"wall_s": time.monotonic() - t0, "blocks": n}, f)
    log(f"forged the composite: {n} blocks over {CARDANO_SLOTS} slots in "
        f"{time.monotonic() - t0:.1f} s (worker process)")


class Forges:
    """The main paths' four chains (bc and draft-03 of `headers` headers,
    the mixed chain and the stand-in-body chain of an eighth as many) and
    phase 3h's composite, each forged in a process of its own (spawned:
    the parent holds a CUDA context) while phase 2 runs; `get` waits for
    one, `close` stops any still running."""

    def __init__(self, workdir: str, headers: int):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        small = headers // 8
        self.jobs = {}
        self.formats = {}  # tag -> the chain's proof format (chain_format)
        for tag, n, fmt, switch in (("bc", headers, "bc", 0), ("draft03", headers, "draft03", 0),
                                    ("mixed", small, "bc", small // 2),
                                    ("generic", small, "bc", 0)):
            db = os.path.join(workdir, f"chain_{tag}")
            proc = ctx.Process(target=forge_chain, args=(db, n, fmt, switch), daemon=True)
            proc.start()
            self.jobs[tag] = (db, n, proc)
            self.formats[tag] = chain_format(fmt, switch)
        # phase 3h's mainnet-shaped composite
        db = os.path.join(workdir, "chain_cardano")
        proc = ctx.Process(target=forge_cardano, args=(db,), daemon=True)
        proc.start()
        self.jobs["cardano"] = (db, CARDANO_SLOTS, proc)

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
AGG_WRAPPERS = (("aggregate", "agg_prep"), ("aggregate", "window_tables"), ("msm", "msm"))


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
    ("pa", "agg_prep", "agg_prep"), ("pa", "window_tables", "dedupe"),
    ("pm", "msm", "msm"),
    ("batch", "verdict_reduce", "reduce"), ("batch", "dispatch_window", "device_step"),
    ("batch", "materialize", "redispatch"), ("batch", "epilogue", "epilogue"),
)
STEP_PARTS = ("stage_packed", "stage_packed_columns", "pin_alloc", "pad_packed_into", "h2d",
              "unpack", "stages", "agg_prep", "dedupe", "msm", "reduce")


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
                                     pipeline_depth=1, aggregate=aggregate,
                                     validate_all="stream")
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
    host to itself): the open's validation (`index_load`: every index
    parsed, the most recent chunk's CRCs), the file
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
        (immutable.ImmutableDB, "_validate", "index_load"),
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
                                     pipeline_depth=1, validate_all="stream")
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

    sides = {"overlap": {"validate_all": "stream"},
             "serial": {"prefetch": False, "pipeline_depth": 1, "validate_all": "stream"}}
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
        res = db_analyser.revalidate(db, params, lview, backend="device", device=dev,
                                     validate_all="stream")
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
        # the bench's read-only read: a writer's open would seal the
        # spoiled copy's two chunks again
        sidecar.reset_counters()
        r = db_analyser.revalidate(path, params, lview, backend=backend, max_batch=max_batch,
                                   device=dev if backend == "device" else None,
                                   validate_all="stream", **kw)
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


def phase_main(dev, forges: Forges, max_batch: int, natives: dict) -> dict:
    """The three main paths (bc, draft03, mixed) on the chains `forges`
    makes; -> {path: replay_path's dict, with the layer split for the two
    single-format chains}; each chain's native replay goes into
    `natives`."""
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
            # the aggregate on, off, on, off (the host's speed varies from
            # call to call, so the two sides are compared within one); each
            # side's best kept
            turns = {True: [], False: []}
            for agg in (True, False, True, False):
                r = port_bench.measure(db, device=dev, aggregate=agg, native=out["native"])
                print(("bench " if agg else "bench_lanes ") + json.dumps(r), flush=True)
                turns[agg].append(r)
            out["bench"], out["bench_lanes"] = (max(turns[agg], key=lambda r: r["value"])
                                                for agg in (True, False))
            if any(r["agg_redispatch"] or not r["aggregate"] for r in turns[True]):
                raise AssertionError("the bench's aggregated replays re-dispatched a window")
        elif tag == "draft03":
            corrupted_replay(tag, db, n, "vrf_proof", "VRFKeyBadProof",
                             params, lview, max_batch, dev, pool=pools[0])
        out.pop("result")
        natives[tag] = out.pop("native")
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


def same_files(a: str, b: str) -> int:
    """Every chunk, index and sidecar file of two chains byte-identical
    (AssertionError otherwise) -> the files compared."""
    import filecmp

    da, db = (os.path.join(p, "immutable") for p in (a, b))
    fa, fb = (sorted(f for f in os.listdir(d) if f.endswith((".chunk", ".index", ".cols")))
              for d in (da, db))
    if fa != fb or not fa:
        raise AssertionError(f"{a} and {b} hold different files")
    bad = [f for f in fa if not filecmp.cmp(os.path.join(da, f), os.path.join(db, f),
                                            shallow=False)]
    if bad:
        raise AssertionError(f"{b}: files differ from {a}: {bad[:5]}")
    return len(fa)


def phase_forge_chains(dev, forges: "Forges") -> dict:
    """The forge's main path (phase 3e): the bc chain and the mixed chain
    forged again through the device engine (tools/db_synthesizer.py:
    forge_sweep a window, ed_sign a window's OCert issues, the assembly on
    the host), in this process, with the launch counts zeroed just before
    each and read just after, once every worker has finished (nothing
    else uses the card or the host's cores meanwhile); every chunk, index
    and sidecar must equal the worker-forged chain's (the per-slot loop).
    Prints one `forge {...}` line a chain: election s, assembly s,
    headers/s, against the loop's. -> {launches: summed over the two,
    chains: the lines}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_synthesizer

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    launches = dict.fromkeys(K.LAUNCHES, 0)
    lines = {}
    for tag in ("bc", "mixed"):
        db, n = forges.get(tag)
        with open(db + ".forge.json") as f:
            loop = json.load(f)
        dst = db + "_device"
        torch.cuda.synchronize()
        K.reset_launches()
        res = db_synthesizer.synthesize(dst, params, pools, lview,
                                        db_synthesizer.ForgeLimit(blocks=n), engine="device",
                                        device=dev, proof_format=forges.formats[tag])
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        files = same_files(db, dst)
        if res.n_blocks != n or res.n_slots != loop["slots"]:
            raise AssertionError(f"{tag}: the device forge made {res.n_blocks} blocks over "
                                 f"{res.n_slots} slots, the loop {n} over {loop['slots']}")
        lines[tag] = {
            "chain": tag, "headers": n, "slots": res.n_slots, "files_identical": files,
            "election_s": res.elect_s, "assembly_s": res.assemble_s, "wall_s": res.wall_s,
            "headers_per_s": n / res.wall_s,
            "launches": {k: got[k] for k in PATH_KERNELS["forge"]},
            "loop": {**loop, "headers_per_s": n / loop["wall_s"]},
            "device_over_loop": loop["wall_s"] / res.wall_s,
        }
        print("forge " + json.dumps(lines[tag]), flush=True)
        shutil.rmtree(dst, ignore_errors=True)
    return {"launches": launches, "chains": lines}


_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import bench, db_analyser, db_synthesizer

job, db, arg, spec, resume, out, device, batch = sys.argv[2:10]
params = bench.bench_params()
pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
lview = synth.make_ledger_view(pools)
t0 = time.monotonic()
if job == "replay":
    r = db_analyser.revalidate(db, params, lview, max_batch=int(batch), checkpoint=arg,
                               resume=resume == "1", chaos=spec or None, device=device)
    doc = {"n_valid": r.n_valid, "error": repr(r.error) if r.error else None,
           "state": recovery.encode_state(r.final_state), "resumed_headers": r.resumed_headers,
           "opened_dirty": r.opened_dirty, "repairs": r.repairs, "wall_s": r.wall_s}
else:
    r = db_synthesizer.synthesize(db, params, pools, lview,
                                  db_synthesizer.ForgeLimit(blocks=int(arg)), engine="device",
                                  resume=resume == "1", chaos=spec or None, device=device)
    doc = {"n_blocks": r.n_blocks, "wall_s": r.wall_s}
doc["process_s"] = time.monotonic() - t0
with open(out, "w") as f:
    json.dump(doc, f)
"""


def child(job: str, db: str, arg, dev, batch: int = 0, spec: str = "", resume: bool = False,
          killed: bool = False) -> dict | None:
    """Run one replay ("replay": revalidate in windows of `batch` with
    the checkpoint `arg`) or forge ("forge": synthesize `arg` blocks on
    the device engine) on `dev` in a process of its own, under the chaos
    spec `spec`; a `killed` child must die of SIGKILL and report
    nothing. -> its report."""
    import signal

    out = db + f".{job}.{int(resume)}.json"
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", _CHILD, REPO, job, db, str(arg), spec,
                           "1" if resume else "0", out, str(dev), str(batch)],
                          capture_output=True, text=True, timeout=600)
    want = -signal.SIGKILL if killed else 0
    if proc.returncode != want:
        raise AssertionError(f"{job} child ({spec or 'no fault'}): exit {proc.returncode}, "
                             f"want {want}: {proc.stderr[-2000:]}")
    if killed:
        return {"child_s": time.monotonic() - t0}
    with open(out) as f:
        return {**json.load(f), "child_s": time.monotonic() - t0}


def phase_recovery(dev, forges: "Forges", native_bc, max_batch: int = 8192) -> dict:
    """The store's crash protocol and the self-healing replay on the card
    (phase 3f), its replays held to the C++ verifier as every path's:
    a. the bc chain (forged by the guarded synthesize) replayed with
       validate_all=True (the default: a writer's deep open) and "stream",
       in turns: the same verdicts and state, equal to the native replay
       of phase 3a; `open_s`, walls, `opened_dirty`, `repairs`;
    b. copies of the 4,096-header chain with a flipped byte under its
       index CRC, a torn tail and a torn index, each opened with True on
       the card and its twin by the native backend: the same verdicts,
       state, repairs and chunk, index and sidecar bytes;
    c. chaos on the bc chain's default replay (depth 3, the aggregate on):
       device-error@dispatch:2, device-error@stage:finish (aggregate off),
       staging-thread-death@window:3, chunk-corrupt@epoch:1; each fault
       must fire and the replay end in the clean replay's n_valid, error
       and state, by device rungs only; the rungs and the walls;
    d. a child process replays the 4,096-header chain in windows of an
       eighth of it with a checkpoint and sigkill@window:3 and dies; a
       new process resumes it: the clean replay's state, resumed_headers
       > 0, and the walls;
    e. a device-engine forge of that chain in a child killed by
       sigkill@append at five eighths of it and resumed in another: every
       chunk, index and sidecar equal to the uninterrupted forge's.
    The launch counts are zeroed before a-c (this process's device work)
    and read after. -> {launches, lines}."""
    import torch

    from ouroboros_consensus_tpu_torch import carry
    from ouroboros_consensus_tpu_torch.obs import recovery
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.storage import guard
    from ouroboros_consensus_tpu_torch.storage.immutable import ImmutableDB, index_name
    from ouroboros_consensus_tpu_torch.testing import chaos, synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    params = bench_params()
    pools = [synth.make_pool(0, kes_depth=params.kes_depth)]
    lview = synth.make_ledger_view(pools)
    bc, n_bc = forges.get("bc")
    small, n_small = forges.get("generic")
    lines: dict = {}

    def replay(db, backend="device", **kw):
        kw.setdefault("max_batch", max_batch)
        torch.cuda.synchronize()
        r = db_analyser.revalidate(db, params, lview, backend=backend,
                                   device=dev if backend == "device" else None, **kw)
        torch.cuda.synchronize()
        return r

    def key(r):
        return (r.n_valid, carry.error_to_plain(r.error), carry.state_to_plain(r.final_state))

    K.reset_launches()
    # a. the reference's default against the bench's read, in turns
    if not guard.was_clean_shutdown(bc):
        raise AssertionError("the guarded forge left its store dirty")
    turns = {True: [], "stream": []}
    for policy in (True, "stream", "stream", True):
        r = replay(bc, validate_all=policy)
        if key(r) != key(native_bc) or r.opened_dirty or r.repairs:
            raise AssertionError(f"validate_all={policy!r}: {r.n_valid} valid, {r.error!r}, "
                                 f"dirty {r.opened_dirty}, repairs {r.repairs}")
        turns[policy].append(r)
    lines["a"] = {"headers": n_bc, **{
        ("true" if p is True else p): {"open_s": [r.open_s for r in rs],
                                       "wall_s": [r.wall_s for r in rs],
                                       "opened_dirty": rs[0].opened_dirty,
                                       "repairs": rs[0].repairs}
        for p, rs in turns.items()}}
    log(f"recovery a: validate_all=True == 'stream' == native on {n_bc} headers: "
        f"{json.dumps(lines['a'])}")

    # b. three corruptions of the 4,096-header chain, opened with True
    imm = ImmutableDB(os.path.join(small, "immutable"))
    (last, entries), = list(imm.chunk_entries())[-1:]
    cpath = os.path.join(small, "immutable", f"{last:05d}.chunk")
    flip_at = entries[len(entries) * 3 // 4]

    def bitflip(db):  # a byte of a block's body, its index CRC kept
        p = os.path.join(db, "immutable", os.path.basename(cpath))
        raw = bytearray(open(p, "rb").read())
        raw[flip_at.offset + flip_at.size - 3] ^= 0x01
        open(p, "wb").write(bytes(raw))

    def torn_tail(db):  # half a block past the indexed end
        with open(os.path.join(db, "immutable", os.path.basename(cpath)), "ab") as f:
            f.write(open(cpath, "rb").read()[entries[-1].offset:][: entries[-1].size // 2])

    def torn_index(db):  # the last index entry cut mid-way
        p = os.path.join(db, "immutable", index_name(last))
        os.truncate(p, os.path.getsize(p) - 17)

    lines["b"] = {}
    for name, spoil in (("bitflip", bitflip), ("torn_tail", torn_tail),
                        ("torn_index", torn_index)):
        a, b = small + f"_{name}_dev", small + f"_{name}_native"
        try:
            for d in (a, b):
                shutil.copytree(small, d)
                spoil(d)
            dres = replay(a, validate_all=True)
            nres = replay(b, "native", validate_all=True)
            compare(f"recovery b, {name}", dres, nres)
            if dres.repairs != nres.repairs or dres.error is not None:
                raise AssertionError(f"{name}: repairs {dres.repairs} != {nres.repairs}")
            files = same_files(a, b)
            lines["b"][name] = {"n_valid": dres.n_valid, "repairs": dres.repairs,
                                "files_identical": files, "wall_s": dres.wall_s,
                                "open_s": dres.open_s}
        finally:
            for d in (a, b):
                shutil.rmtree(d, ignore_errors=True)
    if lines["b"]["bitflip"]["n_valid"] != n_small - len(entries) + entries.index(flip_at) \
            or lines["b"]["torn_tail"]["n_valid"] != n_small:
        raise AssertionError(f"recovery b: {lines['b']}")
    log(f"recovery b: {json.dumps(lines['b'])}")

    # c. chaos on the default pipeline
    clean = {True: turns[True][-1], False: replay(bc, aggregate=False)}
    lines["c"] = {"clean_wall_s": {"aggregate": clean[True].wall_s,
                                   "lanes": clean[False].wall_s}}
    for spec, aggregate in (("device-error@dispatch:2", True),
                            ("device-error@stage:finish", False),
                            ("staging-thread-death@window:3", True),
                            (f"chunk-corrupt@epoch:{min(1, chunk_count(bc) - 1)}", True)):
        plan = chaos.ChaosPlan(chaos.parse_spec(spec))
        r = replay(bc, aggregate=aggregate, chaos=plan)
        rungs = [e.action for e in r.recoveries]
        if len(plan.fired()) != 1 or key(r) != key(clean[aggregate]):
            raise AssertionError(f"chaos {spec}: fired {plan.fired()}, {r.n_valid} valid, "
                                 f"{r.error!r}, rungs {rungs}")
        if not rungs or rungs[-1] != "recovered" or set(rungs) - {
                "retry", "stage-split", "chunk-reread", "recovered"}:
            raise AssertionError(f"chaos {spec}: rungs {rungs}")
        lines["c"][spec] = {"rungs": rungs, "host_rung": "host-reference" in rungs,
                            "wall_s": r.wall_s,
                            "over_clean": r.wall_s / clean[aggregate].wall_s}
    log(f"recovery c: {json.dumps(lines['c'])}")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)

    # d. a replay killed in a child, resumed in another
    db = small + "_resume"
    ck = db + ".ck.json"
    batch = max(8, n_small // 8)
    shutil.copytree(small, db)
    try:
        want = replay(db, max_batch=batch)
        nres = replay(db, "native")
        compare("recovery d, the clean replay", want, nres)
        killed = child("replay", db, ck, dev, batch, "sigkill@window:3", killed=True)
        rec = recovery.read_checkpoint(ck)
        resumed = child("replay", db, ck, dev, batch, resume=True)
        if (resumed["n_valid"], resumed["error"], resumed["state"]) != (
                want.n_valid, None, recovery.encode_state(want.final_state)) \
                or not 0 < resumed["resumed_headers"] == rec["headers"]:
            raise AssertionError(f"recovery d: the resumed replay {resumed} differs")
        lines["d"] = {"headers": n_small, "record": {k: rec[k] for k in ("headers", "windows")},
                      "killed_child_s": killed["child_s"], "resumed": resumed,
                      "clean_wall_s": want.wall_s}
    finally:
        shutil.rmtree(db, ignore_errors=True)
    log(f"recovery d: {json.dumps(lines['d'])}")

    # e. a forge killed in a child, resumed in another
    db = small + "_forge"
    try:
        killed = child("forge", db, n_small, dev, spec=f"sigkill@append:{n_small * 5 // 8}",
                       killed=True)
        if guard.was_clean_shutdown(db):
            raise AssertionError("recovery e: the killed forge left a clean store")
        resumed = child("forge", db, n_small, dev, resume=True)
        files = same_files(small, db)
        lines["e"] = {"headers": n_small, "files_identical": files,
                      "killed_child_s": killed["child_s"], "resumed": resumed}
    finally:
        shutil.rmtree(db, ignore_errors=True)
    log(f"recovery e: {json.dumps(lines['e'])}")
    print("recovery " + json.dumps(lines), flush=True)
    return {"launches": launches, "lines": lines}



# ---------------------------------------------------------------------------
# Phase 3g: the serving plane
# ---------------------------------------------------------------------------

SERVE_64 = dict(n_tenants=64, rounds=4, suffix_len=8, n_pools=4, bc_every=2, fork_storm=8,
                equivocators=2, bad_lane_every=16, unknown_pool_every=32, kes_depth=7)
SERVE_1024 = dict(n_tenants=1024, rounds=2, suffix_len=8, n_pools=16, bc_every=1, kes_depth=7)

_SERVE_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from ouroboros_consensus_tpu_torch.testing import chaos, traffic
from ouroboros_consensus_tpu_torch.tools import bench, serve_bench

ck, spec, out, cfg, window = sys.argv[2:7]
t0 = time.monotonic()
tr = traffic.make_traffic(params=bench.bench_params(), device="cuda", **json.loads(cfg))
with chaos.arming(spec or None):
    line = serve_bench.run_batched(tr, device="cuda", max_window=int(window), checkpoint=ck)
line["process_s"] = time.monotonic() - t0
with open(out, "w") as f:
    json.dump(line, f)
"""


def serve_child(ck: str, spec: str, cfg: dict, window: int, killed: bool = False) -> dict:
    """Serve `cfg`'s traffic in a process of its own with the checkpoint
    `ck`, under the chaos spec `spec`; a `killed` child must die of
    SIGKILL and report nothing. -> its line."""
    import signal

    out = ck + f".{len(spec)}.{int(killed)}.json"
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD, REPO, ck, spec, out,
                           json.dumps(cfg), str(window)],
                          capture_output=True, text=True, timeout=600)
    want = -signal.SIGKILL if killed else 0
    if proc.returncode != want:
        raise AssertionError(f"serve child ({spec or 'no fault'}): exit {proc.returncode}, "
                             f"want {want}: {proc.stderr[-2000:]}")
    if killed:
        return {"child_s": time.monotonic() - t0}
    with open(out) as f:
        return {**json.load(f), "child_s": time.monotonic() - t0}


def serve_split(tr, dev, window: int) -> dict:
    """Where one more batched serving run's wall goes: each layer's wall
    by its own name, nested layers inside their callers, the card
    synchronised around the three that launch or wait for it (so this is
    not the timed run; the host layers run with the card idle, and take
    no synchronisation, which would cost more than a tenant's fold): `submit` (the
    door, every suffix), `prepare_window` (with `host_prechecks`,
    `stage_packed` and `pad_packed_into` inside it), `dispatch_prepared`
    (the upload, the kernels, the reduce, waited for), `materialize` (a
    dirty window's re-dispatch), `full` (the per-lane flags, eta and
    leader values copied back), `segment_epilogue` (a tenant's slice
    folded; `epilogue` the fold alone) and a solo window's `epilogue`;
    `rest` is the wall less the top-level layers (the scheduler's fill,
    the bookkeeping)."""
    import torch

    from ouroboros_consensus_tpu_torch.node import serve
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.tools import serve_bench as sb

    spent: dict = {}
    inside = [0]
    saved = []

    def wrap(owner, name, layer, nested=False, device=False):
        fn = getattr(owner, name)

        def timed(*args, **kw):
            if device:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if nested:
                inside[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                if nested:
                    inside[0] -= 1
                if device:
                    torch.cuda.synchronize()
                key = ("epilogue" if inside[0] else "solo_epilogue") if layer == "epilogue" \
                    else layer
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0

        saved.append((owner, name, fn))
        setattr(owner, name, timed)

    for name in ("prepare_window", "host_prechecks", "stage_packed", "pad_packed_into",
                 "epilogue"):
        wrap(pbatch, name, name)
    for name in ("dispatch_prepared", "materialize"):
        wrap(pbatch, name, name, device=True)
    wrap(pbatch.PackedVerdicts, "full", "full", device=True)
    wrap(serve.ValidationService, "_segment_epilogue", "segment_epilogue", nested=True)
    wrap(serve.ValidationService, "submit", "submit")
    try:
        line = sb.run_batched(tr, device=dev, max_window=window)
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)
    top = ("submit", "prepare_window", "dispatch_prepared", "materialize", "full",
           "segment_epilogue", "solo_epilogue")
    spent["rest"] = line["wall_s"] - sum(spent.get(k, 0.0) for k in top)
    return {"wall_s": line["wall_s"], "windows": line["windows"], "lanes": line["lanes"],
            "layers_s": spent}


def phase_serve(dev, card: str, workdir: str) -> dict:
    """The serving plane on the card (phase 3g; module doc): serve-64
    batched, per peer and on the host plane, under a dispatch fault, and
    killed and resumed in children; serve-1024 clean and with counter
    jumps, batched and per peer; each cell's batched wall split by layer
    (`serve_split`). Every batched run's verdicts and states must equal
    the per-peer discipline's. The launch counts are zeroed
    just before each batched run and read just after it. -> {launches,
    lines}."""
    import torch

    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.testing import chaos, traffic
    from ouroboros_consensus_tpu_torch.tools import serve_bench as sb

    params = bench_params()
    launches = {k: 0 for k in K.LAUNCHES}
    lines: dict = {}

    def batched(tr, window, **kw):
        torch.cuda.synchronize()
        K.reset_launches()
        line = sb.run_batched(tr, device=dev, max_window=window, **kw)
        torch.cuda.synchronize()
        for k, v in K.LAUNCHES.items():
            launches[k] += v
        return line

    def forged(cfg):
        t0 = time.monotonic()
        tr = traffic.make_traffic(params=params, device=dev, **cfg)
        n = sum(len(s.hvs) for s in tr.suffixes())
        tr.reset()
        return tr, {"headers": n, "forge_s": time.monotonic() - t0, "elect_s": tr.elect_s,
                    "assemble_s": tr.assemble_s}

    def same(tag, a, b):
        if not sb.same_verdicts(a, b):
            bad = sorted(t for t in a["rows"] if (a["rows"][t], a["states"][t])
                         != (b["rows"].get(t), b["states"].get(t)))
            raise AssertionError(f"{tag}: {a['mode']} and {b['mode']} differ on {bad[:8]}")

    def report(tag, forge, lines_, extra=None):
        doc = {"cell": tag, "card": card, **forge,
               **{ln["mode"]: sb.public(ln) for ln in lines_}, **(extra or {})}
        doc["batched_over_per_peer"] = (doc["batched"]["headers_per_s"]
                                        / doc["per-peer"]["headers_per_s"])
        lines[tag] = doc
        print("serve " + json.dumps(doc), flush=True)

    # serve-64: batched, per peer, the host plane
    tr, forge = forged(SERVE_64)
    sb.warm_up(tr, dev)
    b64 = batched(tr, 256, scrape=True)
    p64 = sb.run_per_peer(tr, device=dev)
    h64 = sb.run_batched(tr, plane="host", max_window=256)
    split64 = serve_split(tr, dev, 256)
    same("serve-64", b64, p64)
    same("serve-64", b64, h64)
    errors = [r[2].split(":")[0] for rs in b64["rows"].values() for r in rs if r[2]]
    if {"CounterOverIncrementedOCERT", "NoCounterForKeyHashOCERT"} - set(errors) \
            or not b64["agg_redispatch"]:
        raise AssertionError(f"serve-64: errors {sorted(set(errors))}, "
                             f"re-dispatched {b64['agg_redispatch']}")
    # a dispatch fault: shed to the ladder, healed, the same verdicts
    plan = chaos.ChaosPlan(chaos.parse_spec("device-error@serve-dispatch:1"))
    with chaos.arming(plan):
        c64 = sb.run_batched(tr, device=dev, max_window=256)
    same("serve-64 shed", b64, c64)
    (iv,) = c64["degraded_intervals"]
    if plan.fired() != ["device-error@serve-dispatch:1"] or iv[1] is None:
        raise AssertionError(f"serve-64 shed: fired {plan.fired()}, interval {iv}")
    # killed after a window's checkpoint in a child, resumed in another
    ck = os.path.join(workdir, "serve64.ck.json")
    killed = serve_child(ck, "sigkill@serve:4", SERVE_64, 256, killed=True)
    from ouroboros_consensus_tpu_torch.node import serve

    rec = serve.read_serve_checkpoint(ck)
    resumed = serve_child(ck, "", SERVE_64, 256)
    if not resumed["resumed"] or rec is None or rec["windows"] != 5:
        raise AssertionError(f"serve-64 resume: record {rec and rec['windows']}")
    same("serve-64 resumed", b64, resumed)
    report("serve-64", forge, [b64, p64, h64], {
        "split": split64,
        "shed": {"wall_s": c64["wall_s"], "interval": iv,
                 "over_clean": c64["wall_s"] / b64["wall_s"]},
        "resume": {"record_windows": rec["windows"],
                   "banked": sum(len(t["verdicts"]) for t in rec["tenants"].values()),
                   "killed_child_s": killed["child_s"], "resumed_child_s": resumed["child_s"],
                   "resumed_process_s": resumed["process_s"]}})
    # serve-1024, clean and with counter jumps
    for tag, cfg in (("serve-1024", SERVE_1024),
                     ("serve-1024-jumps", {**SERVE_1024, "bad_lane_every": 64})):
        tr, forge = forged(cfg)
        sb.warm_up(tr, dev)
        b = batched(tr, 8192, scrape=True)
        p = sb.run_per_peer(tr, device=dev)
        same(tag, b, p)
        report(tag, forge, [b, p], {"split": serve_split(tr, dev, 8192)})
    return {"launches": launches, "lines": lines}

# ---------------------------------------------------------------------------
# Phase 4: the tools
# ---------------------------------------------------------------------------


def cardano_outcome(res) -> dict:
    from ouroboros_consensus_tpu_torch import carry

    return {"n_blocks": res.n_blocks, "n_valid": res.n_valid, "per_era": res.per_era,
            "error": carry.error_to_plain(res.error),
            "state": carry.state_to_plain(res.final_state)}


def hold_composite_windows(dev, cm, captured: list, seed: int = 23, reps: int = 0) -> dict:
    """Phase 3h's kernels held to their plain versions at the composite's
    own width, on the windows that batch.dispatch_prepared got in the
    clean device replay (`captured`: its (StagedWindow, carry-in) pairs,
    each window padded to its bucket). The Shelley (TPraos) epoch's
    generic window: the five bc stages (hold_stages) on its staged
    columns with every corrupt_columns kind on four lanes each, the
    overlay lanes' leader row not asked (the host sets it). The Babbage
    (Praos) epoch's packed window: `unpack` on it with every WIRE_KINDS
    corruption on four lanes each (hold_unpack), `nonce_fold` over its
    real lanes from the replay's carry-in (hold_fold), and the five
    stages on its unpacked columns with every corrupt_columns kind. -> {era: {kernel: hold's record}}"""
    import torch

    from ouroboros_consensus_tpu_torch.ops import stage_np
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.protocol import nonces, tpraos
    from ouroboros_consensus_tpu_torch.testing.corrupt import corrupt_packed

    generic = [w for w in captured if w[0].layout is None]
    packed = [w for w in captured if w[0].layout is not None]
    if len(generic) != 1 or len(packed) != 1:
        raise AssertionError(f"cardano: {len(generic)} generic and {len(packed)} packed "
                             f"windows dispatched, expected one of each "
                             f"({[(w.b, w.hvs[0].slot) for w, _c in captured]})")
    rng = np.random.default_rng(seed)
    cpu = torch.device("cpu")
    out = {}
    (sw, _carry), = generic
    if not isinstance(sw.batch.vrf, stage_np.EcvrfBcBatch):
        raise AssertionError("cardano: the Shelley window is not batch-compatible")
    width, depth = sw.batch.beta.shape[0], sw.batch.kes.siblings.shape[1]
    cols = [c.contiguous().clone()
            for c in K.staged_to_limb_first_bc(*pbatch.batch_columns(sw.batch, cpu))]
    kinds = corrupt_columns(cols, rng, depth)
    overlay = [tpraos.overlay_position(cm.tpraos_params, hv.slot) is not None for hv in sw.hvs]
    overlay += overlay[:1] * (width - sw.b)  # the padding lanes copy lane 0
    out["shelley"], _ = hold_stages(f"shelley epoch, {sw.b} of {width} lanes",
                                    [c.to(dev).contiguous() for c in cols], kinds, dev,
                                    reps, depth, no_leader=overlay)
    (sw, carry), = packed
    layout = sw.layout
    if layout.vrf_proof_len != 128:
        raise AssertionError("cardano: the Babbage window is not batch-compatible")
    host = pbatch.Packed(*(a.copy() for a in sw.packed))  # off the staging buffer
    width, depth = host.body.shape[0], layout.kes_depth
    tag = f"babbage epoch, {sw.b} of {width} lanes"
    rec = {}
    rec["unpack"], _ = hold_unpack("babbage epoch", layout, corrupt_packed(layout, host, rng),
                                   width, dev, reps)
    cols = [c.contiguous().clone()
            for c in K.staged_to_limb_first_bc(*pbatch.unpack_packed(layout, host, cpu))]
    if carry is None:
        carry = nonces.pack_carry(None, None)
    cin = carry if isinstance(carry, torch.Tensor) else pbatch.to_device(carry, dev)
    within = torch.from_numpy(host.within).to(dev)
    rec["nonce_fold"] = hold_fold("babbage epoch", cols[K.UNPACK_BETA].to(dev), within, sw.b,
                                  cin.to(dev), dev, reps)
    kinds = corrupt_columns(cols, rng, depth)
    stages, _ = hold_stages(tag, [c.to(dev).contiguous() for c in cols], kinds, dev, reps,
                            depth)
    out["babbage"] = {**rec, **stages}
    return out


def phase_cardano(dev, forges: "Forges", workdir: str) -> dict:
    """Phase 3h: the hard-fork composite on the card.
    a. `phase_ed_verify` (the batched Ed25519 verify kernel, called by main).
    b. The mainnet-shaped composite (CARDANO, forged by `forge_cardano` in
       a worker): `composite.revalidate(backend="device")` with the launch
       counts zeroed just before and read just after (by era, from its
       trace), against `backend="native"`: n_blocks, n_valid, per_era and
       the final state equal. Each era's launches: Byron `ed_verify` once,
       Shelley (TPraos) the five stages once, Babbage (Praos) `unpack`,
       `nonce_fold` and the five stages once, nothing else. The windows
       that replay dispatched are kept, and each of those seven kernels is
       held to its plain version on them, at their bucket, with one
       corruption of each kind (hold_composite_windows). Then three
       tampered copies (testing/corrupt.flip_mixed_byte): a Byron signature
       byte mid-era, a Shelley KES-signature byte mid-era and a Babbage
       VRF-proof byte a third of the way in (the header KES-signed again),
       each stopping the device replay at its index with the reference's
       error class (PBftInvalidSignature, InvalidKesSignatureOCERT,
       VRFKeyBadProof).
    c. The CLIs: `db_synthesizer --cardano --slots 230` and `db_analyser
       --cardano` (the device backend) in child processes, exit 0, a JSON
       line with valid == blocks over three eras.
    -> {"launches": the clean device replay's counts, "line": the
    `cardano {...}` record}."""
    from ouroboros_consensus_tpu_torch.hardfork import composite
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.testing import corrupt

    db, _slots = forges.get("cardano")
    with open(db + ".forge.json") as f:
        forged = json.load(f)
    cfg = cardano_config()
    by_era, marks = {}, {}

    def trace(era, headers):
        now = dict(K.LAUNCHES)
        by_era[era] = {k: v - marks.get(k, 0) for k, v in now.items() if v - marks.get(k, 0)}
        marks.update(now)

    captured = []
    dispatch = pbatch.dispatch_prepared

    def spy(sw, device, carry=None):  # keeps each window's host half for the holds
        captured.append((sw, carry))
        return dispatch(sw, device, carry)

    K.reset_launches()
    marks.update(K.LAUNCHES)
    pbatch.dispatch_prepared = spy
    try:
        t0 = time.monotonic()
        dres = composite.revalidate(db, cfg, "device", device=dev, trace=trace)
        device_wall = time.monotonic() - t0
    finally:
        pbatch.dispatch_prepared = dispatch
    launches = dict(K.LAUNCHES)
    t0 = time.monotonic()
    nres = composite.revalidate(db, cfg, "native")
    native_wall = time.monotonic() - t0
    d, n = cardano_outcome(dres), cardano_outcome(nres)
    if d != n or d["error"] is not None or d["n_valid"] != forged["blocks"]:
        raise AssertionError(f"cardano: device {d['n_valid']} {d['per_era']} {d['error']} "
                             f"!= native {n['n_valid']} {n['per_era']} {n['error']} "
                             f"(forged {forged['blocks']})")
    want = {"byron": {"ed_verify": 1},
            "shelley": {k: 1 for k in BC_STAGES},
            "babbage": {**{k: 1 for k in BC_STAGES}, "unpack": 1, "nonce_fold": 1}}
    if dev.type == "cuda" and by_era != want:  # the CPU's twins launch nothing
        raise AssertionError(f"cardano: launches by era {by_era}, expected {want}")
    log(f"cardano: device == native over {d['n_valid']} headers {json.dumps(d['per_era'])}; "
        f"launches by era {json.dumps(by_era)}")
    held = hold_composite_windows(dev, composite.CardanoMock(cfg, device=dev), captured)
    captured.clear()
    # the tampered copies: (field, era, where in the era, the reference's error)
    cm = composite.CardanoMock(cfg, device=dev)
    per = d["per_era"]
    starts = {"byron": 0, "shelley": per["byron"], "babbage": per["byron"] + per["shelley"]}
    tampered = {}
    for field, era, frac, err in (("byron_sig", "byron", 1 / 2, "PBftInvalidSignature"),
                                  ("kes_sig", "shelley", 1 / 2, "InvalidKesSignatureOCERT"),
                                  ("vrf_proof", "babbage", 1 / 3, "VRFKeyBadProof")):
        idx = starts[era] + int(per[era] * frac)
        bad = os.path.join(workdir, f"cardano_{field}")
        shutil.copytree(db, bad)
        try:
            if field == "vrf_proof":
                corrupt.flip_mixed_byte(bad, idx, field, params=cm.praos_params,
                                        pool=cm.pools[0])
            else:
                corrupt.flip_mixed_byte(bad, idx, field)
            t0 = time.monotonic()
            r = composite.revalidate(bad, cfg, "device", device=dev)
            wall = time.monotonic() - t0
        finally:
            shutil.rmtree(bad, ignore_errors=True)
        got = type(r.error).__name__ if r.error is not None else None
        if r.n_valid != idx or got != err:
            raise AssertionError(f"cardano {field}: n_valid {r.n_valid} error {got}, "
                                 f"expected {idx} {err}")
        tampered[field] = {"index": idx, "error": got, "wall_s": wall}
        log(f"cardano {field} flipped at header {idx}: the device replay stops there "
            f"with {got} ({wall:.1f} s)")
    # the CLIs, as a user runs them
    cli_db = os.path.join(workdir, "cardano_cli")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    synth = subprocess.run([sys.executable, "-m", "ouroboros_consensus_tpu_torch.tools."
                            "db_synthesizer", "--out", cli_db, "--cardano", "--slots", "230"],
                           capture_output=True, text=True, env=env)
    ana = subprocess.run([sys.executable, "-m", "ouroboros_consensus_tpu_torch.tools."
                          "db_analyser", "--db", cli_db, "--cardano"]
                         + (["--device", "cpu"] if dev.type == "cpu" else []),
                         capture_output=True, text=True, env=env)
    if synth.returncode != 0 or ana.returncode != 0:
        print(synth.stdout[-2000:], synth.stderr[-2000:], ana.stdout[-2000:],
              ana.stderr[-2000:], file=sys.stderr)
        raise AssertionError(f"cardano CLIs: exit {synth.returncode}, {ana.returncode}")
    doc = json.loads(ana.stdout.strip().splitlines()[-1])
    if doc["valid"] != doc["blocks"] or len(doc["per_era"]) != 3 or doc["error"] is not None:
        raise AssertionError(f"cardano CLI line {doc}")
    log(f"cardano CLIs: {synth.stdout.strip()}; {json.dumps(doc)}")
    line = {"headers_by_era": per, "forge_s": forged["wall_s"],
            "device_headers_per_wall_s": d["n_valid"] / device_wall,
            "native_headers_per_wall_s": n["n_valid"] / native_wall,
            "device_wall_s": device_wall, "native_wall_s": native_wall,
            "device_era_s": dres.era_seconds, "native_era_s": nres.era_seconds,
            "launches_by_era": by_era, "tampered": tampered, "cli": doc,
            "held_at_width": {era: {k: {f: r[f] for f in ("lanes", "max_abs_err")}
                                    for k, r in recs.items()} for era, recs in held.items()}}
    print("cardano " + json.dumps(line), flush=True)
    return {"launches": launches, "line": line}


OBS_PAIRS = 12  # phase 3i's pairs of an untraced and a traced replay


def phase_obs(dev, forges: Forges, max_batch: int = 8192) -> dict:
    """Phase 3i: the observability plane on the card, on the bc chain of
    phase 3a at full width (the docstring's 3i). -> the traced replay's
    launches, the overhead pairs, the seam's cost and the warmup
    summary."""
    import statistics
    import threading
    import urllib.request

    import torch

    from ouroboros_consensus_tpu_torch import carry, obs
    from ouroboros_consensus_tpu_torch.obs import live, perfetto
    from ouroboros_consensus_tpu_torch.obs.warmup import WARMUP
    from ouroboros_consensus_tpu_torch.ops.pk import build
    from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
    from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser
    from ouroboros_consensus_tpu_torch.utils import trace as T

    params = bench_params()
    lview = synth.make_ledger_view([synth.make_pool(0, kes_depth=params.kes_depth)])
    db, n = forges.get("bc")

    def replay(**kw):
        torch.cuda.synchronize()
        r = db_analyser.revalidate(db, params, lview, device=dev, max_batch=max_batch,
                                   validate_all="stream", **kw)
        torch.cuda.synchronize()
        return r

    def outcome(r):
        return (r.n_blocks, r.n_valid, carry.error_to_plain(r.error),
                carry.state_to_plain(r.final_state))

    def totals(rec) -> dict:
        snap = rec.registry.snapshot()
        return {k: sum(s["value"] for s in snap[k]["samples"]) if k in snap else 0
                for k in ("oct_windows_total", "oct_headers_validated_total",
                          "oct_h2d_bytes_total", "oct_d2h_bytes_total")}

    # a. the untraced replay (no tracer on the seam), then the traced one
    #    with the plane armed
    if pbatch.BATCH_TRACER is not None:
        raise AssertionError(f"obs: a tracer before the untraced replay: {pbatch.BATCH_TRACER}")
    K.reset_launches()
    base = replay()
    base_launches = dict(K.LAUNCHES)
    if base.error is not None or base.n_valid != n:
        raise AssertionError(f"obs: the untraced replay {base.n_valid}/{n}, {base.error!r}")
    rec = obs.recorder()
    rec.clear()
    before = totals(rec)
    hb = os.path.join(build.BUILD_DIR, "obs_heartbeat.json")
    seen: dict = {}
    scraped = threading.Event()
    epilogue = pbatch.epilogue

    def scrape():
        """/healthz from a second thread while the first window waits at
        its epilogue."""
        try:
            port = live.armed().server.port
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as f:
                seen["healthz"] = json.loads(f.read())
        finally:
            scraped.set()

    def held(*a, **kw):
        if not scraped.is_set():
            threading.Thread(target=scrape, daemon=True).start()
            scraped.wait(30)
        return epilogue(*a, **kw)

    pbatch.epilogue = held
    K.reset_launches()
    try:
        traced = replay(collect_phases=True, flight_recorder=True, heartbeat=hb,
                        metrics_port=0, stall_budget_s=600)
    finally:
        pbatch.epilogue = epilogue
    launches = dict(K.LAUNCHES)
    after = totals(rec)
    if outcome(traced) != outcome(base):
        raise AssertionError("obs: the traced replay's verdicts or final state differ")
    if launches != base_launches:
        raise AssertionError(f"obs: launches traced {launches} != untraced {base_launches}")
    got = {k: after[k] - before[k] for k in after}
    want = {"oct_windows_total": traced.n_windows, "oct_headers_validated_total": traced.n_valid,
            "oct_h2d_bytes_total": traced.h2d_bytes, "oct_d2h_bytes_total": traced.d2h_bytes}
    if got != want:
        raise AssertionError(f"obs: recorder {got} != result {want}")
    events = [e for _t, e in rec.timed_events()]
    staged = [e.index for e in events if type(e).__name__ == "WindowStaged"]
    spans = [e.index for e in events if type(e).__name__ == "WindowSpan"]
    if not (len(staged) == len(spans) == traced.n_windows and staged == spans):
        raise AssertionError(f"obs: {len(staged)} WindowStaged, {len(spans)} WindowSpan, "
                             f"{traced.n_windows} windows")
    phase = (seen.get("healthz") or {}).get("phase")
    if phase in (None, "idle", "warmup"):
        raise AssertionError(f"obs: /healthz mid-replay answered {seen.get('healthz')!r}")
    final = live.classify(live.read_heartbeat(hb))
    if final != "done":
        raise AssertionError(f"obs: the heartbeat's last document classifies as {final!r}")
    trace_path = os.path.join(build.BUILD_DIR, "obs_trace.perfetto.json")
    doc = rec.write_chrome_trace(trace_path)
    problems = perfetto.validate_chrome_trace(doc)
    if problems:
        raise AssertionError(f"obs: the Perfetto document is invalid: {problems[:5]}")
    log(f"obs: traced replay == untraced (n_valid {traced.n_valid}, {traced.n_windows} "
        f"windows, launches {json.dumps({k: v for k, v in launches.items() if v})}); "
        f"recorder {json.dumps(got)}; /healthz mid-replay phase {phase!r}; heartbeat {final}; "
        f"Perfetto {trace_path} ({os.path.getsize(trace_path)} bytes, "
        f"{len(doc['traceEvents'])} events)")

    # b. the overhead: an untraced and a traced replay in each pair, the
    #    pair's order flipped each time, every replay launching what the
    #    untraced one of (a) launched
    turns: dict = {"untraced": [], "traced": []}
    per_window = []
    for k in range(OBS_PAIRS):
        for side in (("untraced", "traced") if k % 2 == 0 else ("traced", "untraced")):
            rec.clear()
            K.reset_launches()
            r = replay(flight_recorder=side == "traced")
            if outcome(r) != outcome(base):
                raise AssertionError(f"obs: a {side} turn's replay differs")
            if K.LAUNCHES != base_launches:
                raise AssertionError(f"obs: a {side} turn launched {dict(K.LAUNCHES)} != "
                                     f"untraced {base_launches}")
            turns[side].append({"validate_s": r.validate_s, "wall_s": r.wall_s})
            if side == "traced":
                per_window.append(len(rec.timed_events()) / max(
                    1, sum(type(e).__name__ == "WindowSpan" for _t, e in rec.timed_events())))

    def quartiles(xs) -> dict:
        q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
        return {"q1": q1, "median": med, "q3": q3}

    keys = ("validate_s", "wall_s")
    spread = {side: {k: quartiles([t[k] for t in ts]) for k in keys}
              for side, ts in turns.items()}
    overhead = {k: spread["traced"][k]["median"] / spread["untraced"][k]["median"] - 1
                for k in keys}
    # each pair's traced / untraced - 1: resolved only where its quartiles
    # keep one sign
    pair = {k: quartiles([t[k] / u[k] - 1 for t, u in zip(turns["traced"], turns["untraced"])])
            for k in keys}
    verdict = {k: ("traced slower" if pair[k]["q1"] > 0 else
                   "traced faster" if pair[k]["q3"] < 0 else "unresolved") for k in keys}
    # the seam's own cost, which the pairs' spread hides: the seconds inside
    # every call of it over a traced replay (the Enclose brackets, the
    # transfer and window events, the recorder's calls from any other site;
    # a call inside another is not counted twice; each timed call's clock
    # reads are in it). Pipelined, a call's wall also holds its waits for the
    # GIL while the staging and prefetch threads run; serial (one thread,
    # the same windows and events) it is the seam's own work. Each against
    # the untraced pairs' median validate_s and wall_s.
    lock, depth = threading.Lock(), threading.local()

    def seam_cost(**kw) -> dict:
        spent = {"s": 0.0, "calls": 0}

        def timed(fn):
            def call(*a, **kw):
                if getattr(depth, "n", 0):
                    return fn(*a, **kw)
                depth.n = 1
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    dt = time.perf_counter() - t0
                    depth.n = 0
                    with lock:
                        spent["s"] += dt
                        spent["calls"] += 1
            return call

        seam = [(pbatch, n)
                for n in ("_enclose", "_emit_transfer", "_win_meta", "_emit_window_span")]
        seam += [(T.Enclose, "__enter__"), (T.Enclose, "__exit__"), (type(rec), "__call__")]
        saved = [(o, n, o.__dict__[n]) for o, n in seam]
        for o, n, fn in saved:
            setattr(o, n, timed(fn))
        try:
            rec.clear()
            K.reset_launches()
            r = replay(flight_recorder=True, **kw)
        finally:
            for o, n, fn in saved:
                setattr(o, n, fn)
        if outcome(r) != outcome(base) or K.LAUNCHES != base_launches:
            raise AssertionError(f"obs: the timed traced replay {kw} differs: launches "
                                 f"{dict(K.LAUNCHES)}")
        spent.update(events=len(rec.timed_events()), validate_s=r.validate_s,
                     us_a_call=spent["s"] / max(1, spent["calls"]) * 1e6,
                     share_of_validate_s=spent["s"] / spread["untraced"]["validate_s"]["median"],
                     share_of_wall_s=spent["s"] / spread["untraced"]["wall_s"]["median"])
        return spent

    spent = {"pipelined": seam_cost(),
             "serial": seam_cost(pipeline_depth=1, prefetch=False)}
    log(f"obs overhead: {OBS_PAIRS} pairs {json.dumps(turns)}; quartiles {json.dumps(spread)}; "
        f"median traced/untraced - 1 {json.dumps(overhead)}; each pair's traced/untraced - 1 "
        f"{json.dumps(pair)} -> {json.dumps(verdict)}; recorder events a window "
        f"{per_window}; inside the seam over one traced replay: {json.dumps(spent)}")

    # d. the warmup report
    wu = WARMUP.report()
    if set(wu["builds"]) != set(build.KERNELS):
        raise AssertionError(f"obs: nvcc walls for {sorted(wu['builds'])}")
    top = {part: sorted(((v["wall_s"], k) for k, v in wu[part].items()), reverse=True)[:5]
           for part in ("builds", "stages")}
    log(f"obs warmup: nvcc walls, the five largest (s): {top['builds']}; first launch walls, "
        f"the five largest (s): {top['stages']}; {wu['n_stages']} kernels launched")
    out = {"launches": launches, "windows": traced.n_windows, "turns": turns,
           "quartiles": spread, "overhead": overhead, "pair_overhead": pair,
           "verdict": verdict, "events_per_window": per_window, "seam_cost": spent,
           "trace_bytes": os.path.getsize(trace_path), "healthz_phase": phase,
           "warmup_top": top}
    print("obs " + json.dumps(out), flush=True)
    return out


def check_resources(ptxas_file) -> dict:
    """The resources report after the run (phase 3i's (c), after the
    tools): a row for every kernel the run launched, none failed; its
    registers, local and static shared bytes equal to ptxas's for the
    kernel its attributes entry reads (`ptxas_file(source)`: that build's
    report), and its blocks per SM (the occupancy API's) equal to
    `sm90_blocks_per_sm` of ptxas's registers and shared bytes with the
    dynamic shared bytes, at the threads a block the entry asked it at.
    -> the rows."""
    from ouroboros_consensus_tpu_torch.obs import resources
    from ouroboros_consensus_tpu_torch.obs.warmup import WARMUP
    from ouroboros_consensus_tpu_torch.ops.pk import build

    report = resources.RESOURCES.report()
    launched = sorted(WARMUP.report()["stages"])
    missing = [k for k in launched if k not in report["kernels"]]
    if missing or report["failed"]:
        raise AssertionError(f"obs: no resources row for {missing}; failed {report['failed']}")
    for name in launched:
        row = report["kernels"][name]
        source, _stem = build.LAUNCH_SOURCE.get(name, (name, name))
        want = ptxas_record(ptxas_file(source), build.ATTRIBUTE_KERNEL[name])
        bps = sm90_blocks_per_sm(want["registers"],
                                 want["shared_bytes"] + row["dynamic_shared_bytes"],
                                 row["block_threads"])
        got = (row["registers"], row["local_bytes"], row["shared_bytes"], row["blocks_per_sm"])
        if got != (want["registers"], want["stack_bytes"], want["shared_bytes"], bps):
            raise AssertionError(f"obs: {name}'s resources {row} != ptxas {want}, sm_90's "
                                 f"blocks per SM {bps}")
    log(f"obs resources ({len(launched)} kernels, each held to ptxas and to sm_90's blocks "
        f"per SM): {json.dumps(report['kernels'])}")
    return report["kernels"]


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
rec["agg_ms"] = new.agg_times(dev, sys.argv[4], w)
rec["verify_forge"] = new.verify_forge_times(dev)
print("AB " + json.dumps(rec), flush=True)
"""


def agg_times(dev, db: str, workdir: str, reps: int = 20) -> dict:
    """`agg_prep`, `msm` and the dedupe with its mod-L reductions
    (`dedupe_tables`: a tree with `aggregate.agg_tables` times its pair,
    `window_tables` then `agg_tables`; else its one launch,
    `window_tables`) of the tree this process imports: on a full window
    of the forged chain at `db`, on the first 8 lanes of a tiled window
    and on all its 8,192 (agg_prep also on its first 128), on 20,000
    lanes (`dedupe_windows`' wide columns) and on four columns of 256 and
    of 300 distinct keys in 8,192 lanes: ms a call (CUDA events over
    `reps` calls). -> {"chain" | "8" | "128" | "8192" | "20000" |
    "keys256" | "keys300": {agg_prep[, msm][, dedupe_tables]}}."""
    from ouroboros_consensus_tpu_torch.device import time_ms
    from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
    from ouroboros_consensus_tpu_torch.ops.pk import msm as pm

    def dedupe_call(cols, pts, scal):
        if hasattr(pa, "agg_tables"):  # the dedupe and agg_tables, two launches
            return lambda: pa.agg_tables(pa.window_tables(cols, pts, scal)[0])
        return lambda: pa.window_tables(cols, pts, scal)

    depth = bench_params().kes_depth
    tiled, _ = tiled_window(8192, 256, 17, workdir, "bc")
    out = {}
    for tag, cols in (("chain", chain_window(db, 8192)), ("8", [c[..., :8] for c in tiled]),
                      ("128", [c[..., :128] for c in tiled]), ("8192", tiled)):
        cols = [c.contiguous().to(dev) for c in cols]
        out[tag] = {"agg_prep": time_ms(lambda: pa.agg_prep(*cols, kes_depth=depth), reps)}
        if tag != "128":
            pts, scal, _f, _e, _l = pa.agg_prep(*cols, kes_depth=depth)
            out[tag]["dedupe_tables"] = time_ms(dedupe_call(cols, pts, scal), reps)
        if tag in ("chain", "8"):
            args = msm_args(cols, depth)
            out[tag]["msm"] = time_ms(lambda: pm.msm(*args), reps)
    for tag, n, spec in (("20000", 20000, WIDE_SPEC), ("keys256", 8192, [(256, 0)] * 4),
                         ("keys300", 8192, [(300, 0)] * 4)):
        win = dedupe_inputs([spread_keys(n, d, share, 19 + c) for c, (d, share)
                             in enumerate(spec)], dev, 19)
        out[tag] = {"dedupe_tables": time_ms(dedupe_call(*win), reps)}
    return out


def ab_main(parent: str, lanes=(8, 128, 8192)) -> int:
    """This tree against `parent` (a checkout of another commit), in turns
    parent, this, this, parent; one process per turn, each building its
    own tree's kernels. Prints each turn's `AB {...}` line, the A/B lines
    (each side's minimum over its two turns) and the card."""
    this = os.path.abspath(__file__)
    recs = []
    work = tempfile.mkdtemp(prefix="chip_smoke_ab_")
    try:
        db = os.path.join(work, "chain_bc")
        forge_chain(db, 9000, "bc", 0)  # a full window in the first epoch
        for root in (parent, REPO, REPO, parent):
            p = subprocess.run([sys.executable, "-c", AB_CHILD, os.path.abspath(root), this,
                                ",".join(map(str, lanes)), db],
                               capture_output=True, text=True)
            line = [x for x in p.stdout.splitlines() if x.startswith("AB ")]
            if p.returncode != 0 or not line:
                print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"A/B turn for {root} failed (exit {p.returncode})")
            recs.append(json.loads(line[0][3:]))
            print(line[0], flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    digests = {json.dumps(r["verify_forge"]["digests"], sort_keys=True) for r in recs}
    if len(digests) != 1:
        raise AssertionError("the two trees' ed_verify, forge_sweep or ed_sign outputs differ")
    for key in ("ed_verify", "forge_sweep"):
        row = []
        for n in recs[0]["verify_forge"][key]:
            par = [r["verify_forge"][key][n] for r in (recs[0], recs[3])]
            cur = [r["verify_forge"][key][n] for r in (recs[1], recs[2])]
            row.append(f"{n}: parent {min(par):.4f} this {min(cur):.4f} "
                       f"({min(par) / min(cur):.2f}x)")
        log(f"A/B {key}: " + "; ".join(row) + " (outputs equal)")
    for part in ("launch_ms", "wrapper_ms", "read_ms"):
        row = []
        for n in recs[0]["verify_forge"]["ed_sign"]:
            par = [r["verify_forge"]["ed_sign"][n][part] for r in (recs[0], recs[3])]
            cur = [r["verify_forge"]["ed_sign"][n][part] for r in (recs[1], recs[2])]
            row.append(f"{n}: parent {min(par):.4f} this {min(cur):.4f} "
                       f"({min(par) / min(cur):.2f}x)")
        log(f"A/B ed_sign {part[:-3]}: " + "; ".join(row) + " (outputs equal)")
    pair = ("dedupe_tables",)
    for tag, keys in (("chain", ("agg_prep", "msm", *pair)), ("8", ("agg_prep", "msm", *pair)),
                      ("128", ("agg_prep",)), ("8192", ("agg_prep", *pair)), ("20000", pair),
                      ("keys256", pair), ("keys300", pair)):
        for key in keys:
            if not all(key in r["agg_ms"].get(tag, {}) for r in recs):
                continue
            par = [r["agg_ms"][tag][key] for r in (recs[0], recs[3])]
            cur = [r["agg_ms"][tag][key] for r in (recs[1], recs[2])]
            log(f"A/B {key} ({tag}): parent {min(par):.4f} this {min(cur):.4f} "
                f"({min(par) / min(cur):.2f}x)")
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
    r = db_analyser.revalidate(db, params, lview, backend="device", max_batch=8192, device=dev,
                               validate_all="stream")
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
    from ouroboros_consensus_tpu_torch.device import (int_op_rate, max_sm_clock_hz, resolve,
                                                      wide_product_rate)

    from ouroboros_consensus_tpu_torch.ops.pk import build

    dev = resolve(None)
    card = card_line()
    log(f"card: {card}")
    t_all = time.monotonic()
    ptxas = phase_build()

    def ptxas_file(source: str) -> str:
        with open(build.ptxas_report(source)) as f:
            return f.read()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    forges = Forges(work, a.headers)
    try:
        stages = phase_kernels(dev, workdir=work)
        stages["vrf_prep"] = phase_vrf_prep(dev, workdir=work)
        stages.update(phase_wire(dev, workdir=work))
        stages.update(phase_agg(dev, workdir=work))
        for key, by_lanes in stage_times(dev, workdir=work).items():
            stages[key]["ms_by_lanes"] = {**by_lanes, stages[key]["lanes"]: stages[key]["ms"]}
        stages.update(phase_forge(dev))
        phase_agg_chain(dev, forges.get("bc")[0], stages)
        natives: dict = {}
        paths = phase_main(dev, forges, 8192, natives)
        generic = phase_generic(dev, forges, 8192)
        forged = phase_forge_chains(dev, forges)
        recovered = phase_recovery(dev, forges, natives["bc"])
        served = phase_serve(dev, card, work)
        stages["ed_verify"] = phase_ed_verify(dev)
        cardano = phase_cardano(dev, forges, work)
        observed = phase_obs(dev, forges)
    finally:
        forges.close()
        shutil.rmtree(work, ignore_errors=True)
    tools = phase_tools(dev)
    stages.update(tools["records"])
    kernel_rows = check_resources(ptxas_file)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    # operation bound: the field work's 32x32->64 products (wide_products)
    # over device.wide_product_rate(); hashes, carries and adds are left
    # out, so this is a lower bound. Byte bound: the bytes moved over the
    # card's 3.35 TB/s.
    wide_rate = wide_product_rate()
    int_rate = int_op_rate()
    by_path = {p: out["launches"] for p, out in paths.items()}
    by_path["generic"] = generic["launches"]
    by_path["tools"] = tools["launches"]
    by_path["forge"] = forged["launches"]
    by_path["recovery"] = recovered["launches"]
    by_path["serve"] = served["launches"]
    by_path["cardano"] = cardano["launches"]
    by_path["obs"] = observed["launches"]
    for path, ks in PATH_KERNELS.items():
        missing = sorted(k for k in ks if by_path[path][k] <= 0)
        stray = sorted(k for k in PATH_ONLY - ks if by_path[path].get(k, 0))
        if missing or stray:
            raise AssertionError(f"{path} path: not launched {missing}, launched {stray}")
    kernels = []
    for name, src, rep in KERNEL_ROWS:
        st = stages[name]
        if "bound_ms" in st:  # the wire kernels: phase_wire's bound
            per_lane = None
            bound, bound_by = st["bound_ms"], st["bound_by"]
        elif name == "agg_prep":
            # agg_prep: field products (inversions batched) and hash instructions
            per_lane = None
            st["bound_parts"] = agg_prep_bound(st, wide_rate, int_rate)
            bytes_ms = st["bytes"] / 3.35e12 * 1e3
            bound = max(st["bound_parts"]["bound_ms"], bytes_ms)
            bound_by = "operations" if bound > bytes_ms else "bytes"
        elif name in ("msm", "dedupe"):
            # msm: this run's point operations (msm_work); the dedupe: its bytes
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
            "also_replaces": ALSO_REPLACES.get(name),
            "launches": sum(by_path[p][name] for p in used),
            "launches_by_path": {p: by_path[p][name] for p in used},
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "resources": kernel_rows.get(name),
            "field_ops_per_lane": st.get("field_ops"),
            "wide_products_per_lane": per_lane,
            "ms_by_lanes": st.get("ms_by_lanes"), "wrapper_ms": st.get("wrapper_ms"),
            "plain_ms_by_lanes": st.get("plain_ms_by_lanes"),
            "native_host_ms_by_lanes": st.get("native_host_ms_by_lanes"),
            "wrapper_ms_by_lanes": st.get("wrapper_ms_by_lanes"),
            "read_ms_by_lanes": st.get("read_ms_by_lanes"),
            "lanes": st["lanes"], "bytes": st["bytes"], "ptxas": ptxas.get(name),
            "msm_work": st.get("work"), "tiled": st.get("tiled"),
            "split_by_lanes": st.get("split_by_lanes"), "windows": st.get("windows"),
            "device_ms": st.get("device_ms"), "bound_parts": st.get("bound_parts"),
            "hash_ops_per_lane": st.get("hash_ops"),
            "dependent_path": st.get("dependent_path"),
            "stamps_by_lanes": st.get("stamps_by_lanes"),
            "launches_by_chain": ({t: {"headers": c["headers"], "launches": c["launches"][name]}
                                   for t, c in forged["chains"].items()}
                                  if name in PATH_KERNELS["forge"] else None),
        })
    for p, out in paths.items():
        fill = [{"kernel": k, "lanes": n, "blocks": -(-n // 32)}
                for k, n in out.get("lanes_per_launch", [])]
        log(f"{p}: grid fill per window (32 lanes a block in every stage kernel: ed, "
            f"kes 4 warps, agg_prep 10, vrf_prep, vrf_bc_prep, finish 3, vrf_ladders 8; "
            f"{sms} SMs): {json.dumps(fill)}")
        log(f"{p}: {json.dumps({k: v for k, v in out.items() if k not in ('launches', 'windows', 'list', 'lanes_per_launch')})}")
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
