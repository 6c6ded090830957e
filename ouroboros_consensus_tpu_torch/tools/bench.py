"""End-to-end replay rate of the port on one CUDA card, as bench.py
measures the JAX package: revalidation of a synthetic Praos chain from
its on-disk ImmutableDB (the chunks read through their sealed sidecars,
the body-hash checks, staging, the CUDA kernels, the nonce fold and the
epilogue, the next segment read and the next windows staged while the
card works), against the same replay through the single-core C++
verifier on the same chain and the same read, in the same process.

    python -m ouroboros_consensus_tpu_torch.tools.bench               # 1M headers if cached, else 100,000
    python -m ouroboros_consensus_tpu_torch.tools.bench --headers 32768
    python -m ouroboros_consensus_tpu_torch.tools.bench --db PATH     # an existing chain
    python -m ouroboros_consensus_tpu_torch.tools.bench --no-aggregate  # per-lane stages

The chain has bench.py's parameters (1 pool, KES depth 7, f = 1/2, 3600
slots per KES period, 43,200-slot epochs; batch-compatible proofs),
forged once on the card by tools/db_synthesizer.py's device engine
(which seals a walked sidecar for every chunk) and kept under
`.bench_cache/` with a `COMPLETE` marker; the default is the 1M-header
chain when its cache exists, else 100,000 headers (bench.py:40-52).
bench.py's sequence (:441-523) follows: the native replay (over a
200,000-header prefix of a longer chain: its rate is constant per
header; its baseline then leaves out the open, which loads the whole
chain's indexes, as bench.py does, and a device replay of the same
prefix must give the native's n_valid and final state), a two-window
prefix device replay (`max_headers` = 2 x 8,192),
one warm-up and the best of `--runs` timed device replays, every replay
`validate_all="stream"`; each timed one must read every chunk through
its sidecar (a `hit`; anything else raises) and collects its phases
(`collect_phases`). The lines before the last hold the forge's split
(when this run forged), the best replay's times and sidecar counters,
and its phase walls, windows and H2D/D2H bytes per window; the last line
is one JSON object with bench.py's keys: `metric`, `value` (headers/s
over the best device replay's wall), `unit` and `vs_baseline` (against
the native replay's rate). The device replays take the window aggregate
on every batch-compatible window (revalidate's default);
`--no-aggregate` runs the five per-lane stage kernels instead. It needs
a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
from fractions import Fraction

from ..device import resolve
from ..protocol import batch as pbatch
from ..protocol.praos import PraosParams
from ..storage import sidecar
from ..storage.immutable import ImmutableDB
from ..testing import synth
from . import db_analyser, db_synthesizer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(REPO, ".bench_cache")
KES_DEPTH = 7
MAX_BATCH = 8192
NATIVE_CAP = 200_000  # the native replay's prefix on a longer chain


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


def chain_path(headers: int, cache_dir: str = CACHE_DIR) -> str:
    return os.path.join(cache_dir, f"torch_chain_cols_h{headers}_d{KES_DEPTH}")


def default_headers(cache_dir: str = CACHE_DIR) -> int:
    """The 1M-header chain when its cache is complete, else 100,000."""
    done = os.path.exists(os.path.join(chain_path(1_000_000, cache_dir), "COMPLETE"))
    return 1_000_000 if done else 100_000


def build_or_load_chain(headers: int, cache_dir: str = CACHE_DIR, device=None):
    """The cached chain of `headers` headers, forged (and sealed) on
    first use by the device engine on `device` -> (its path, the forge's
    ForgeResult, or None when the cache held it)."""
    path = chain_path(headers, cache_dir)
    marker = os.path.join(path, "COMPLETE")
    if os.path.exists(marker):
        return path, None
    shutil.rmtree(path, ignore_errors=True)
    pools, lview = bench_ledger()
    res = db_synthesizer.synthesize(path, bench_params(), pools, lview,
                                    db_synthesizer.ForgeLimit(blocks=headers),
                                    engine="device", device=device)
    with open(marker, "w") as f:
        f.write("ok")
    return path, res


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def attribution(r) -> dict:
    """A replay's phase walls, windows and H2D/D2H bytes per window
    (bench.py's `attribution`, from revalidate(collect_phases=True))."""
    n = max(r.n_windows, 1)
    return {"phases_s": {k: round(v, 4) for k, v in sorted(r.phases.items())},
            "windows": r.n_windows, "packed_windows": r.packed_windows,
            "h2d_bytes_per_window": r.h2d_bytes // n, "d2h_bytes_per_window": r.d2h_bytes // n}


def measure(db: str, runs: int = 2, max_batch: int = MAX_BATCH, device=None,
            aggregate: bool = True, native=None) -> dict:
    """bench.py's sequence on the chain at `db`: the native replay
    (`native`: its revalidate result, when the caller has run it on this
    chain already; over a NATIVE_CAP-header prefix of a longer chain,
    its rate then over its wall less its open, and a device replay of
    that prefix held to its n_valid and final state), a two-window
    prefix device replay, one warm-up and `runs` timed
    device replays on `device` (None: the CUDA card), every one
    `validate_all="stream"`, each timed one reading every chunk through
    its sidecar (raises otherwise) and collecting its phases, with the
    window aggregate on or off (`aggregate`, revalidate's). -> bench.py's
    four keys, and beside them the best device replay's `wall_s`,
    `validate_s`, `read_s` (the reader's own time, overlapped) and
    `wait_s` (validation waiting for the reader), its attribution
    (phases, windows, bytes per window), its sidecar counters,
    `aggregate`, `agg_redispatch` (the windows the timed replays
    re-dispatched lane by lane), the prefix replay's headers and wall,
    and the native replay's times and the open it left out."""
    import torch

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures the CUDA card only")
    params = bench_params()
    _, lview = bench_ledger()
    imm = ImmutableDB(os.path.join(db, "immutable"))
    chunks, total = len(list(imm.chunk_entries())), imm.n_blocks()
    if native is None:
        native = db_analyser.revalidate(db, params, lview, backend="native",
                                        max_batch=max_batch, validate_all="stream",
                                        max_headers=NATIVE_CAP if total > NATIVE_CAP else None)
    if native.error is not None or native.n_valid != native.n_blocks or native.n_valid == 0:
        raise AssertionError(f"the bench chain must revalidate clean: {native.n_valid}/"
                             f"{native.n_blocks}, {native.error!r}")
    # over a prefix, the open (every index of the whole chain) is taken out
    # of the native wall, as bench.py does; the device replays keep theirs
    capped = native.n_blocks < total
    baseline = native.n_valid / (native.wall_s - (native.open_s if capped else 0.0))

    def replay(**kw):
        r = db_analyser.revalidate(db, params, lview, backend="device", max_batch=max_batch,
                                   device=dev, aggregate=aggregate, validate_all="stream", **kw)
        torch.cuda.synchronize()
        if r.error is not None or r.n_valid != r.n_blocks or r.n_valid == 0:
            raise AssertionError(f"device replay {r.n_valid}/{r.n_blocks}, {r.error!r}")
        return r

    def same_as_native(r, what):
        if (r.n_valid, r.final_state) != (native.n_valid, native.final_state):
            raise AssertionError(f"{what}: {r.n_valid} headers valid, final state "
                                 f"{'equal' if r.final_state == native.final_state else 'differs'}"
                                 f"; the native replay: {native.n_valid}")

    torch.cuda.synchronize()
    if capped:  # the reference check of a longer chain: the device over the native's prefix
        same_as_native(replay(max_headers=native.n_blocks),
                       f"device replay of the {native.n_blocks}-header prefix")
    prefix = replay(max_headers=2 * max_batch)
    best = counts = None
    redispatch = 0
    for k in range(runs + 1):
        torch.cuda.synchronize()
        sidecar.reset_counters()
        before = pbatch.AGG_REDISPATCH
        r = replay(collect_phases=k > 0)
        if k:
            redispatch += pbatch.AGG_REDISPATCH - before
        c = sidecar.counters()
        if not capped:
            same_as_native(r, f"device replay {k}")
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
        "read_s": best.read_s, "wait_s": best.wait_s, "attribution": attribution(best),
        "sidecar": counts, "aggregate": aggregate, "agg_redispatch": redispatch,
        "prefix_headers": prefix.n_valid, "prefix_wall_s": prefix.wall_s,
        "native_headers": native.n_valid, "native_wall_s": native.wall_s,
        "native_validate_s": native.validate_s, "native_headers_per_s": baseline,
        "native_open_excluded_s": native.open_s if capped else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headers", type=int, default=None,
                    help="headers of the forged chain (default: 1M when cached, else 100,000)")
    ap.add_argument("--db", help="replay this existing chain instead of forging one")
    ap.add_argument("--runs", type=int, default=2, help="timed device replays")
    ap.add_argument("--no-aggregate", dest="aggregate", action="store_false",
                    help="the per-lane stage kernels on every window")
    a = ap.parse_args(argv)
    resolve(None)  # no card: raise before forging
    db, forged = (a.db, None) if a.db else build_or_load_chain(a.headers or default_headers())
    if forged is not None:
        from ..ops.pk.kernels import LAUNCHES

        print(f"forge: {forged.n_blocks} headers over {forged.n_slots} slots in "
              f"{forged.wall_s!r} s (election {forged.elect_s!r} s, assembly "
              f"{forged.assemble_s!r} s), {forged.n_blocks / forged.wall_s!r} headers/s; "
              f"launches forge_sweep {LAUNCHES['forge_sweep']} ed_sign {LAUNCHES['ed_sign']}",
              flush=True)
    out = measure(db, a.runs, aggregate=a.aggregate)
    print(f"card: {card_line()}", flush=True)
    print(f"validate_s {out['validate_s']!r} read_s {out['read_s']!r} "
          f"wait_s {out['wait_s']!r} wall_s {out['wall_s']!r}; prefix replay "
          f"{out['prefix_headers']} headers in {out['prefix_wall_s']!r} s; native "
          f"{out['native_headers']} headers, wall_s {out['native_wall_s']!r} validate_s "
          f"{out['native_validate_s']!r}, baseline {out['native_headers_per_s']!r} "
          f"headers/s over the wall less the open "
          f"({out['native_open_excluded_s']!r} s excluded)", flush=True)
    print(f"attribution {json.dumps(out['attribution'])}", flush=True)
    print(f"sidecar {json.dumps(out['sidecar'])} aggregate {out['aggregate']} "
          f"agg_redispatch {out['agg_redispatch']}", flush=True)
    print(json.dumps({k: out[k] for k in ("metric", "value", "unit", "vs_baseline")}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
