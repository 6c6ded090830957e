"""The serving plane measured: aggregate headers/s and verdict latency,
many peers' suffixes batched into shared windows against a window per
peer.

    python -m ouroboros_consensus_tpu_torch.tools.serve_bench
    python -m ouroboros_consensus_tpu_torch.tools.serve_bench --tenants 1024 --rounds 2 \\
        --pools 16 --bc-every 1 --max-window 8192
    python -m ouroboros_consensus_tpu_torch.tools.serve_bench --device cpu --tenants 4 \\
        --rounds 2 --suffix-len 3 --kes-depth 3 --max-window 8

The JAX package's scripts/profile_serve.py is the reference. The same
seeded real-crypto traffic (testing/traffic.py, forged once and replayed
to both) goes through two disciplines:

  * "batched": node/serve.ValidationService, the suffixes of all
    tenants batched into shared windows of up to `--max-window` lanes;
  * "per-peer": every suffix its own `batch.validate_batch` window,
    against its tenant's state.

Both run on the card (`--device`, None: the CUDA card; "cpu": the
kernels' plain twins) after an untimed warm-up window of each shape.
The two must give every tenant the same verdict rows and final state,
or the tool exits 2. It prints a JSON line a discipline (headers/s over
its wall, windows, lanes a window, `batch.AGG_REDISPATCH`'s count over
the run, the batched run's p50 and p99 verdict latency from its
`oct_serve_verdict_latency_seconds` histogram), then one with their
ratio, the forge's seconds and the `/slo` document scraped from an
ephemeral 127.0.0.1 port. Defaults: the reference profile's shape, 64
tenants, 4 rounds of 8-header suffixes, 4 pools, 256-lane windows,
bench.py's parameters (KES depth 7). It writes no file."""

from __future__ import annotations

import argparse
import json
import time
import urllib.request

from ..device import resolve
from ..node import serve
from ..obs import recovery
from ..obs import server as obs_server
from ..obs.registry import MetricsRegistry
from ..protocol import batch as pbatch
from ..protocol import praos
from ..testing import traffic


def run_batched(tr, *, plane: str = "device", device=None, max_window: int = 256,
                aggregate: bool = True, scrape: bool = False, checkpoint=None) -> dict:
    """The seeded traffic through a ValidationService: every suffix
    submitted in arrival order, then drained. -> the discipline's line,
    with its `rows` and `states` a tenant (and the scraped `/slo`)."""
    reg = MetricsRegistry()
    svc = serve.ValidationService(tr.params, tr.lview, tr.eta0, plane=plane, device=device,
                                  aggregate=aggregate, registry=reg, max_window=max_window,
                                  checkpoint=checkpoint)
    for spec in tr.tenants:
        svc.register(spec.tenant_id, tr.genesis_state())
    srv = obs_server.MetricsServer(registry=reg, slo_doc=svc.slo_snapshot) if scrape else None
    try:
        redispatched = pbatch.AGG_REDISPATCH
        tr.reset()
        t0 = time.perf_counter()
        for sfx in tr.suffixes():
            svc.submit(sfx.tenant_id, sfx.hvs)
        svc.run_until_drained()
        wall = time.perf_counter() - t0
        tr.reset()
        slo = (json.load(urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/slo"))
               if srv is not None else None)
    finally:
        if srv is not None:
            srv.close()
    headers = sum(t.headers_done for t in svc.tenants.values())
    lat = svc._m_latency
    return {
        "mode": "batched" if plane == "device" else "host", "headers": headers,
        "suffixes": sum(t.done for t in svc.tenants.values()), "windows": svc.windows,
        "lanes": svc.lanes, "lanes_per_window": svc.lanes / max(1, svc.windows),
        "wall_s": wall, "headers_per_s": headers / wall,
        "agg_redispatch": pbatch.AGG_REDISPATCH - redispatched,
        "latency_p50_s": lat.quantile(0.5), "latency_p99_s": lat.quantile(0.99),
        "degraded_intervals": svc.degraded_intervals, "resumed": svc.resumed, "slo": slo,
        "rows": {s.tenant_id: [v.row() for v in svc.verdicts(s.tenant_id)]
                 for s in tr.tenants},
        "states": {s.tenant_id: recovery.encode_state(svc.tenants[s.tenant_id].state)
                   for s in tr.tenants},
    }


def run_per_peer(tr, *, device=None, aggregate: bool = True) -> dict:
    """The baseline: every suffix its own window (`validate_batch`),
    folded against its tenant's state, in arrival order."""
    dev = resolve(device)
    st = {s.tenant_id: tr.genesis_state() for s in tr.tenants}
    rows: dict = {s.tenant_id: [] for s in tr.tenants}
    headers = windows = lanes = 0
    redispatched = pbatch.AGG_REDISPATCH
    tr.reset()
    t0 = time.perf_counter()
    for sfx in tr.suffixes():
        ticked = praos.tick(tr.params, tr.lview, sfx.hvs[0].slot, st[sfx.tenant_id])
        res = pbatch.validate_batch(tr.params, ticked, list(sfx.hvs), "device", dev, None,
                                    aggregate)
        st[sfx.tenant_id] = res.state
        headers += res.n_valid
        windows += 1
        lanes += len(sfx.hvs)
        rows[sfx.tenant_id].append([sfx.seq, res.n_valid, serve._canon_error(res.error)])
    wall = time.perf_counter() - t0
    tr.reset()
    return {
        "mode": "per-peer", "headers": headers, "suffixes": windows, "windows": windows,
        "lanes": lanes, "lanes_per_window": lanes / max(1, windows), "wall_s": wall,
        "headers_per_s": headers / wall,
        "agg_redispatch": pbatch.AGG_REDISPATCH - redispatched,
        "rows": rows, "states": {t: recovery.encode_state(s) for t, s in st.items()},
    }


def warm_up(tr, device=None, aggregate: bool = True) -> None:
    """One untimed window of each shape in the traffic, so that neither
    timed discipline pays the first launches."""
    dev = resolve(device)
    tr.reset()
    seen = set()
    for sfx in tr.suffixes():
        shape = (len(sfx.hvs[0].vrf_proof), len(sfx.hvs[0].signed_bytes))
        if shape in seen:
            continue
        seen.add(shape)
        ticked = praos.tick(tr.params, tr.lview, sfx.hvs[0].slot, tr.genesis_state())
        pbatch.validate_batch(tr.params, ticked, list(sfx.hvs), "device", dev, None, aggregate)
    tr.reset()


def same_verdicts(a: dict, b: dict) -> bool:
    return a["rows"] == b["rows"] and a["states"] == b["states"]


def public(line: dict) -> dict:
    """A discipline's line without its per-tenant rows and states."""
    return {k: v for k, v in line.items() if k not in ("rows", "states")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serve_bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--suffix-len", type=int, default=8)
    ap.add_argument("--pools", type=int, default=4)
    ap.add_argument("--max-window", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kes-depth", type=int, default=7)
    ap.add_argument("--bc-every", type=int, default=2)
    ap.add_argument("--fork-storm", type=int, default=8)
    ap.add_argument("--equivocators", type=int, default=2)
    ap.add_argument("--bad-lane-every", type=int, default=16)
    ap.add_argument("--unknown-pool-every", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--no-aggregate", action="store_true",
                    help="bc windows take the five per-lane stages")
    a = ap.parse_args(argv)
    dev = resolve(a.device)
    aggregate = not a.no_aggregate
    tr = traffic.make_traffic(
        device=dev, n_tenants=a.tenants, rounds=a.rounds, suffix_len=a.suffix_len,
        n_pools=a.pools, seed=a.seed, kes_depth=a.kes_depth, bc_every=a.bc_every,
        fork_storm=a.fork_storm, equivocators=a.equivocators,
        bad_lane_every=a.bad_lane_every, unknown_pool_every=a.unknown_pool_every)
    t0 = time.perf_counter()
    n = sum(len(s.hvs) for s in tr.suffixes())
    forge_s = time.perf_counter() - t0
    warm_up(tr, dev, aggregate)
    batched = run_batched(tr, device=dev, max_window=a.max_window, aggregate=aggregate,
                          scrape=True)
    per_peer = run_per_peer(tr, device=dev, aggregate=aggregate)
    for line in (per_peer, batched):
        print(json.dumps(public(line)), flush=True)
    same = same_verdicts(batched, per_peer)
    print(json.dumps({
        "tenants": a.tenants, "rounds": a.rounds, "suffix_len": a.suffix_len,
        "pools": a.pools, "max_window": a.max_window, "headers_forged": n,
        "forge_s": forge_s, "elect_s": tr.elect_s, "assemble_s": tr.assemble_s,
        "device": str(dev), "aggregate": aggregate, "same_verdicts": same,
        "batched_over_per_peer": batched["headers_per_s"] / per_peer["headers_per_s"],
    }), flush=True)
    if not same:
        print("serve_bench: the batched and per-peer verdicts differ", flush=True)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
