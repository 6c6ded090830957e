"""End-to-end replay rate of the port on one CUDA card, as bench.py
measures the JAX package: revalidation of a synthetic Praos chain from
its on-disk ImmutableDB (the chunks read through their sealed sidecars,
the body-hash checks, staging, the CUDA kernels, the nonce fold and the
epilogue, the next segment read and the next windows staged while the
card works), against the same replay through the single-core C++
verifier on the same chain and the same read, in the same process.

    python -m ouroboros_consensus_tpu_torch.tools.bench               # 100,000 headers
    python -m ouroboros_consensus_tpu_torch.tools.bench --headers 32768
    python -m ouroboros_consensus_tpu_torch.tools.bench --db PATH     # an existing chain
    python -m ouroboros_consensus_tpu_torch.tools.bench --no-aggregate  # per-lane stages

The chain has bench.py's parameters (1 pool, KES depth 7, f = 1/2, 3600
slots per KES period, 43,200-slot epochs; batch-compatible proofs),
forged once by `testing/synth.py` (which seals a walked sidecar for every
chunk) and kept under `.bench_cache/` with a `COMPLETE` marker. The
native replay runs first; then one warm-up device replay and the best of
`--runs` timed ones, each of which must read every chunk through its
sidecar (a `hit`; anything else raises). The line before the last holds
the best replay's times and the sidecar counters; the last line is one
JSON object with bench.py's keys: `metric`, `value` (headers/s over the
best device replay's wall), `unit` and `vs_baseline` (against the
native replay's rate). The device replays take the window aggregate on
every batch-compatible window (revalidate's default); `--no-aggregate`
runs the five per-lane stage kernels instead. It needs a CUDA card and
raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from fractions import Fraction

from ..device import resolve
from ..protocol import batch as pbatch
from ..protocol.praos import PraosParams
from ..storage import sidecar
from ..storage.immutable import ImmutableDB
from ..testing import synth
from . import db_analyser

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(REPO, ".bench_cache")
KES_DEPTH = 7
MAX_BATCH = 8192


def bench_params() -> PraosParams:
    """bench.py's chain parameters (bench.py:129-136)."""
    return PraosParams(
        slots_per_kes_period=3600, max_kes_evolutions=62, security_param=2160,
        active_slot_coeff=Fraction(1, 2), epoch_length=43200, kes_depth=KES_DEPTH,
    )


def bench_ledger():
    """The chain's one pool and its ledger view."""
    pools = [synth.make_pool(0, kes_depth=KES_DEPTH)]
    return pools, synth.make_ledger_view(pools)


def build_or_load_chain(headers: int, cache_dir: str = CACHE_DIR) -> str:
    """The cached chain of `headers` headers, forged (and sealed) on
    first use."""
    path = os.path.join(cache_dir, f"torch_chain_cols_h{headers}_d{KES_DEPTH}")
    marker = os.path.join(path, "COMPLETE")
    if not os.path.exists(marker):
        shutil.rmtree(path, ignore_errors=True)
        pools, lview = bench_ledger()
        synth.synthesize(path, bench_params(), pools, lview, headers)
        with open(marker, "w") as f:
            f.write("ok")
    return path


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def measure(db: str, runs: int = 2, max_batch: int = MAX_BATCH, device=None,
            aggregate: bool = True, native=None) -> dict:
    """The native replay (`native`: its revalidate result, when the
    caller has run it on this chain already), then one warm-up and `runs`
    timed device replays of the chain at `db` on `device` (None: the
    CUDA card), each timed one reading every chunk through its sidecar
    (raises otherwise), with the window aggregate on or off
    (`aggregate`, revalidate's). -> bench.py's four keys, and beside them the best
    device replay's `wall_s`, `validate_s`, `read_s` (the reader's own
    time, overlapped) and `wait_s` (validation waiting for the reader),
    its sidecar counters, `aggregate`, `agg_redispatch` (the windows the
    timed replays re-dispatched lane by lane), and the native replay's
    times."""
    import torch

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures the CUDA card only")
    params = bench_params()
    _, lview = bench_ledger()
    nat = native or db_analyser.revalidate(db, params, lview, backend="native",
                                           max_batch=max_batch)
    if nat.error is not None or nat.n_valid != nat.n_blocks or nat.n_valid == 0:
        raise AssertionError(f"the bench chain must revalidate clean: {nat.n_valid}/"
                             f"{nat.n_blocks}, {nat.error!r}")
    baseline = nat.n_valid / nat.wall_s
    chunks = len(list(ImmutableDB(os.path.join(db, "immutable")).chunk_entries()))
    best = counts = None
    redispatch = 0
    for k in range(runs + 1):
        torch.cuda.synchronize()
        sidecar.reset_counters()
        before = pbatch.AGG_REDISPATCH
        r = db_analyser.revalidate(db, params, lview, backend="device",
                                   max_batch=max_batch, device=dev, aggregate=aggregate)
        torch.cuda.synchronize()
        if k:
            redispatch += pbatch.AGG_REDISPATCH - before
        c = sidecar.counters()
        same = (r.n_valid == nat.n_valid and r.error is None
                and r.final_state == nat.final_state)
        if not same:
            raise AssertionError(f"device replay {r.n_valid}, {r.error!r} differs "
                                 f"from the native one")
        if k and c != {**dict.fromkeys(c, 0), "hit": chunks}:
            raise AssertionError(f"timed replay {k}: not every one of the {chunks} "
                                 f"chunks read through its sidecar: {c}")
        if k and (best is None or r.wall_s < best.wall_s):  # k = 0 warms up
            best, counts = r, c
    rate = best.n_valid / best.wall_s
    return {
        "metric": (f"end-to-end db-analyser revalidation of a {best.n_valid}-header "
                   "synthetic Praos chain (disk->sidecar columns+body hash->"
                   "columnar staging->CUDA Ed25519+KES+VRF+leader kernels->nonce fold), "
                   f"{torch.cuda.get_device_name(0)} vs single-core C++ replay"),
        "value": rate,
        "unit": "headers/s",
        "vs_baseline": rate / baseline,
        "wall_s": best.wall_s, "validate_s": best.validate_s,
        "read_s": best.read_s, "wait_s": best.wait_s, "sidecar": counts,
        "aggregate": aggregate, "agg_redispatch": redispatch,
        "native_wall_s": nat.wall_s, "native_validate_s": nat.validate_s,
        "native_headers_per_s": baseline,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headers", type=int, default=100_000,
                    help="headers of the forged chain (bench.py's cold-cache default)")
    ap.add_argument("--db", help="replay this existing chain instead of forging one")
    ap.add_argument("--runs", type=int, default=2, help="timed device replays")
    ap.add_argument("--no-aggregate", dest="aggregate", action="store_false",
                    help="the per-lane stage kernels on every window")
    a = ap.parse_args(argv)
    resolve(None)  # no card: raise before forging
    db = a.db or build_or_load_chain(a.headers)
    out = measure(db, a.runs, aggregate=a.aggregate)
    print(f"card: {card_line()}", flush=True)
    print(f"validate_s {out['validate_s']!r} read_s {out['read_s']!r} "
          f"wait_s {out['wait_s']!r} wall_s {out['wall_s']!r}; native wall_s "
          f"{out['native_wall_s']!r} validate_s {out['native_validate_s']!r}", flush=True)
    print(f"sidecar {json.dumps(out['sidecar'])} aggregate {out['aggregate']} "
          f"agg_redispatch {out['agg_redispatch']}", flush=True)
    print(json.dumps({k: out[k] for k in ("metric", "value", "unit", "vs_baseline")}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
