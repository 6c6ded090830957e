"""Profiled device replay: where does a replay's wall go?

The device-replay half of the JAX package's scripts/profile_replay.py.
It replays a chain twice ("warm", then "hot"), each time with a tracer
on the batch seam that sums the Enclose brackets (stage / dispatch /
materialize / epilogue on the window loop, stream / stream-mmap /
stream-parse on the read) and the bytes across the card's boundary,
and prints a budget table: each phase's seconds, count and share of
the wall (the pipeline overlaps them: the staging thread and the
prefetch thread run beside the launching one, so the shares may sum
past 100 %), the windows and the H2D / D2H bytes a window. With the
flight recorder installed (`--trace`, or `--trace-out`), it prints the
dispatch -> materialize latency's p50 and p99 over the replays'
windows, and `--trace-out FILE` writes the recorder's events as a
Chrome trace (ui.perfetto.dev or chrome://tracing load it), checked by
`perfetto.validate_chrome_trace`. One run-ledger record per call
(obs/ledger.py).

    python -m ouroboros_consensus_tpu_torch.tools.profile_replay --headers 32768 \\
        --trace-out chiprun_out/replay.perfetto.json [--heartbeat F --metrics-port 0 ...]

It forges (and caches) the bench chain of tools/bench.py, or replays
`--db PATH` (a chain of bench.py's parameters). Its observability flags
are revalidate's keywords (obs.add_arguments). It runs on the CUDA card
unless `--device cpu`. The reference's `--host` (the host pipeline's
ceiling) and `--overlap-ab` (the staging thread's A/B on stubbed
crypto) modes are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .. import obs
from ..device import resolve
from ..obs import ledger, perfetto
from ..protocol import batch as pbatch
from . import bench, db_analyser

WINDOW_PHASES = ("stage", "dispatch", "materialize", "epilogue")
READ_PHASES = ("stream", "stream-mmap", "stream-parse")


def budget_table(coll: db_analyser._PhaseCollector, wall: float) -> list[str]:
    """The budget table of one replay's collector: each bracket's
    seconds, count and share of `wall`, then the windows and the bytes a
    window."""
    lines = []
    for label in (*WINDOW_PHASES, *READ_PHASES):
        if coll.count.get(label):
            lines.append(f"  {label:12s} {coll.wall[label]:9.4f} s  x{coll.count[label]:5d} "
                         f"({coll.wall[label] / wall * 100:5.1f}%)")
    if coll.windows:
        lines.append(f"  windows: {coll.windows} ({coll.packed} packed) | "
                     f"H2D {coll.h2d / coll.windows / 1e3:.1f} KB/window | "
                     f"D2H {coll.d2h / coll.windows / 1e3:.1f} KB/window")
    return lines


def profile(db: str, params, lview, runs: int = 2, device=None, max_batch: int = bench.MAX_BATCH,
            aggregate: bool = True, trace_out: str | None = None, ledger_dir: str | None = None,
            log=print, **obs_kw) -> dict:
    """Replay `db` `runs` times (the first "warm"), each under a phase
    collector (db_analyser._PhaseCollector), with the observability
    keywords `obs_kw` (revalidate's; the flight recorder installed when
    `trace_out` is given) -> the last replay's result, budget and
    latency summary (and the trace's path and problems)."""
    import torch

    dev = resolve(device)
    if trace_out is not None:
        obs_kw["flight_recorder"] = True
    coll = db_analyser._PhaseCollector()
    rec = None
    prev = pbatch.BATCH_TRACER
    pbatch.set_batch_tracer(coll)  # the recorder chains in behind it
    out: dict = {}
    try:
        with obs.observe(**obs_kw):
            rec = obs.recorder() if obs_kw.get("flight_recorder") else None
            for k in range(runs):
                coll.reset()
                if rec is not None:
                    rec.clear()
                t0 = time.monotonic()
                r = db_analyser.revalidate(db, params, lview, backend="device", device=dev,
                                           max_batch=max_batch, aggregate=aggregate,
                                           validate_all="stream")
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.monotonic() - t0
                if r.error is not None or r.n_valid != r.n_blocks:
                    raise AssertionError(f"replay {r.n_valid}/{r.n_blocks}: {r.error!r}")
                log(f"== {'warm' if k == 0 else 'hot'}: {r.n_valid} headers in {wall:.4f} s "
                    f"({r.n_valid / wall:.1f} headers/s) on {dev}")
                for line in budget_table(coll, wall):
                    log(line)
            out = {"headers": r.n_valid, "wall_s": wall, "rate_per_s": r.n_valid / wall,
                   "validate_s": r.validate_s, "read_s": r.read_s, "wait_s": r.wait_s,
                   "phases_s": {k: coll.wall[k] for k in sorted(coll.wall)},
                   "counts": dict(coll.count),
                   "bytes": {"h2d": coll.h2d, "d2h": coll.d2h, "packed": coll.packed,
                             "generic": coll.windows - coll.packed}}
            if rec is not None:
                s = rec.latency_summary()
                out["latency"] = s
                if s["windows"]:
                    log(f"dispatch->materialize latency over {s['windows']} windows: "
                        f"p50 {s['device_latency_p50_s'] * 1e3:.3f} ms | "
                        f"p99 {s['device_latency_p99_s'] * 1e3:.3f} ms")
                if trace_out is not None:
                    doc = rec.write_chrome_trace(trace_out)
                    out["trace_out"] = trace_out
                    out["trace_problems"] = perfetto.validate_chrome_trace(doc)
                    log(f"chrome trace: {trace_out} ({len(doc['traceEvents'])} events, "
                        f"{os.path.getsize(trace_out)} bytes"
                        + (f", INVALID: {out['trace_problems'][:3]}"
                           if out["trace_problems"] else "") + ")")
    finally:
        pbatch.set_batch_tracer(prev)
    ledger.record_replay(
        "profile_replay", recorder=rec, dir_=ledger_dir,
        config={"db": db, "runs": runs, "max_batch": max_batch, "aggregate": aggregate,
                "device": str(dev)},
        result={"headers": out["headers"], "wall_s": out["wall_s"],
                "rate_per_s": out["rate_per_s"], "windows": coll.windows,
                "packed_windows": coll.packed, "h2d_bytes": coll.h2d, "d2h_bytes": coll.d2h},
        wall_s=out["wall_s"], phases_s=out["phases_s"],
        env={**obs_kw, "trace_out": trace_out})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headers", type=int, default=None,
                    help="headers of the bench chain (default: tools/bench.py's)")
    ap.add_argument("--db", help="replay this chain (bench.py's parameters) instead")
    ap.add_argument("--runs", type=int, default=2, help="replays: a warm one, then hot ones")
    ap.add_argument("--max-batch", type=int, default=bench.MAX_BATCH)
    ap.add_argument("--device", default=None, help="default: the CUDA card; cpu: the twins")
    ap.add_argument("--no-aggregate", dest="aggregate", action="store_false")
    ap.add_argument("--trace-out", metavar="FILE",
                    help="write the hot replay's Chrome trace (installs the recorder)")
    obs.add_arguments(ap)
    a = ap.parse_args(argv)
    dev = resolve(a.device)
    db = a.db or bench.build_or_load_chain(a.headers or bench.default_headers(),
                                           device=dev)[0]
    _pools, lview = bench.bench_ledger()
    out = profile(db, bench.bench_params(), lview, a.runs, dev, a.max_batch, a.aggregate,
                  a.trace_out, a.ledger, **obs.keywords(a))
    print(json.dumps({k: out[k] for k in ("headers", "wall_s", "rate_per_s")}), flush=True)
    return 1 if out.get("trace_problems") else 0


if __name__ == "__main__":
    raise SystemExit(main())
