"""Shared fixture code of the serving plane's tests: the real-crypto
traffic mix, its conversion to the JAX package's objects, and the runs
of both packages' ValidationService and of the JAX sequential fold."""

import dataclasses

import torch

from ouroboros_consensus_tpu.node import serve as rserve
from ouroboros_consensus_tpu.obs import recovery as rrecovery
from ouroboros_consensus_tpu.obs.registry import MetricsRegistry as RRegistry
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu.protocol import views as rviews
from ouroboros_consensus_tpu_torch.node import serve
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.obs.registry import MetricsRegistry
from ouroboros_consensus_tpu_torch.testing import traffic

from torch_port_chain import ref_view

# 6 tenants, 2 rounds of 3-header suffixes at KES depth 3: one bc tenant
# (peer-005, whose odd rounds carry a foreign-pool lane: a dirty
# aggregated window), a fork-storm pair that equivocates (peer-000 and
# peer-001 on one pool and one slot grid) and a counter jump (peer-003)
MIX = dict(n_tenants=6, rounds=2, suffix_len=3, kes_depth=3, bc_every=6, fork_storm=2,
           equivocators=1, bad_lane_every=4, unknown_pool_every=6, seed=3)
MAX_WINDOW = 8


def make(**kw):
    torch.set_num_threads(1)
    return traffic.make_traffic(device="cpu", **{**MIX, **kw})


def ref_params(p):
    return rpraos.PraosParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


def ref_lview(lv):
    return rviews.LedgerView(pool_distr={
        k: rviews.IndividualPoolStake(e.stake, e.vrf_key_hash)
        for k, e in lv.pool_distr.items()})


def ref_state(st):
    return rpraos.PraosState(**{f.name: getattr(st, f.name) for f in dataclasses.fields(st)})


def port_service(tr, **kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("max_window", MAX_WINDOW)
    kw.setdefault("device", "cpu")
    svc = serve.ValidationService(tr.params, tr.lview, tr.eta0, **kw)
    for spec in tr.tenants:
        svc.register(spec.tenant_id, tr.genesis_state())
    return svc


def record_windows(svc):
    """Wrap the service's `_run_window` to log each window's segments
    (tenant, suffix seq, lo, hi), in order."""
    log = []
    run = svc._run_window

    def logged(whvs, segments, *rest):
        log.append([(t.tenant_id, j.seq, lo, hi) for t, j, lo, hi in segments])
        return run(whvs, segments, *rest)

    svc._run_window = logged
    return log


def drive(svc, tr):
    """Submit the seeded arrival order, then drain."""
    tr.reset()
    for sfx in tr.suffixes():
        svc.submit(sfx.tenant_id, sfx.hvs)
    tr.reset()
    svc.run_until_drained()


def rows(svc, tr):
    return {s.tenant_id: [v.row() for v in svc.verdicts(s.tenant_id)] for s in tr.tenants}


def states(svc, tr):
    return {s.tenant_id: recovery.encode_state(svc.tenants[s.tenant_id].state)
            for s in tr.tenants}


def run_port(tr, **kw):
    """-> (rows, states, window log, service) of the port's service."""
    svc = port_service(tr, **kw)
    log = record_windows(svc)
    drive(svc, tr)
    return rows(svc, tr), states(svc, tr), log, svc


def run_reference(tr, monkeypatch, max_window=MAX_WINDOW):
    """The JAX ValidationService under OCT_SERVE_DEVICE=0 (its host fold)
    over the same headers -> (rows, states, window log)."""
    monkeypatch.setenv("OCT_SERVE_DEVICE", "0")
    try:
        svc = rserve.ValidationService(ref_params(tr.params), ref_lview(tr.lview), tr.eta0,
                                       registry=RRegistry(), max_window=max_window)
        for spec in tr.tenants:
            svc.register(spec.tenant_id, ref_state(tr.genesis_state()))
        log = record_windows(svc)
        tr.reset()
        for sfx in tr.suffixes():
            svc.submit(sfx.tenant_id, [ref_view(h) for h in sfx.hvs])
        svc.run_until_drained()
    finally:
        monkeypatch.delenv("OCT_SERVE_DEVICE")
    tr.reset()
    return (rows(svc, tr),
            {s.tenant_id: rrecovery.encode_state(svc.tenants[s.tenant_id].state)
             for s in tr.tenants}, log)


def reference_fold(tr):
    """The JAX sequential praos.update fold, a suffix at a time against
    its tenant's state -> (rows, states)."""
    params, lview = ref_params(tr.params), ref_lview(tr.lview)
    st = {s.tenant_id: ref_state(tr.genesis_state()) for s in tr.tenants}
    out = {s.tenant_id: [] for s in tr.tenants}
    tr.reset()
    for sfx in tr.suffixes():
        state, n, err = st[sfx.tenant_id], 0, None
        for hv in sfx.hvs:
            try:
                state = rpraos.update(params, ref_view(hv), hv.slot,
                                      rpraos.tick(params, lview, hv.slot, state))
            except rpraos.PraosValidationError as e:
                err = e
                break
            n += 1
        st[sfx.tenant_id] = state
        out[sfx.tenant_id].append([sfx.seq, n, rserve._canon_error(err)])
    tr.reset()
    return out, {t: rrecovery.encode_state(s) for t, s in st.items()}

