"""The self-healing window loops of the port (protocol/batch.py's
validate_chain with an obs/recovery supervisor) on the CPU twins, against
the JAX package's sequential host fold: every chaos fault of the device
path (a dispatch that raises, a stage kernel that raises, the staging
thread's death), at the serial loop (depth 1) and the pipeline (depth 3),
with the window aggregate on and off, recovers to the same n_valid and
final state, nonces included, by device rungs only. And a fault that
shows only where its window retires (a kernel's error surfaces at the
next synchronisation) after the window's carry went on to the windows
behind it: their device nonces are dropped and they are dispatched again
from the recovered state, so a garbage carry never reaches the state."""

import pytest
import torch

from torch_port_chain import PARAMS, forge, ref_view

from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.obs import recovery
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol.praos import PraosState
from ouroboros_consensus_tpu_torch.testing import chaos
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)
PPARAMS = carry.params_from_reference(PARAMS)
N = 12  # three windows of four, all in the first epoch: two in flight behind the first
DEVICE_RUNGS = {"retry", "stage-split", "recovered"}


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("selfheal") / "db")
    lview = forge(path)
    hvs = pda.read_header_views(path)[:N]
    st = rpraos.PraosState()
    for hv in hvs:
        st = rpraos.update(PARAMS, ref_view(hv), hv.slot,
                           rpraos.tick(PARAMS, lview, hv.slot, st))
    return hvs, carry.lview_from_reference(lview), carry.state_to_plain(st)


def _run(views, depth, aggregate, spec=None):
    hvs, plview, _ = views
    sup = recovery.RecoverySupervisor(backoff_s=0)
    with chaos.arming(spec) as plan:
        res = pbatch.validate_chain(PPARAMS, lambda _e: plview, PraosState(), hvs,
                                    max_batch=4, device="cpu", pipeline_depth=depth,
                                    aggregate=aggregate, supervisor=sup)
        fired = plan.fired() if plan is not None else []
    return res, sup, fired


def _healed(views, res, sup):
    assert res.error is None and res.n_valid == N
    assert carry.state_to_plain(res.state) == views[2]
    actions = [e.action for e in sup.events]
    assert actions and set(actions) <= DEVICE_RUNGS and actions[-1] == "recovered"


@pytest.mark.parametrize("spec,depth,aggregate", [
    ("device-error@dispatch:1", 3, True),
    ("device-error@dispatch:1", 1, False),
    ("device-error@stage:finish", 3, False),
    ("staging-thread-death@window:1", 3, True),
])
def test_chaos_matrix_recovers_to_the_host_fold(views, spec, depth, aggregate):
    res, sup, fired = _run(views, depth, aggregate, spec)
    assert fired == [spec]
    _healed(views, res, sup)


@pytest.mark.parametrize("aggregate", [True, False])
def test_a_middle_window_failing_late_drops_the_carry_behind_it(views, monkeypatch, aggregate):
    """Window 1 dispatches with a garbage carry-out and raises only when
    it retires; window 2, in flight on that carry, must not keep its
    nonces."""
    dispatch, materialize = pbatch.dispatch_prepared, pbatch.materialize
    poisoned = []
    count = []

    def bad_dispatch(sw, device, carry_in=None):
        v = dispatch(sw, device, carry_in)
        count.append(1)
        if len(count) == 2:
            v.carry = torch.zeros_like(v.carry)  # what a faulted kernel left
            poisoned.append(v)
        return v

    def late_fault(v):
        if v in poisoned:
            poisoned.remove(v)
            raise RuntimeError("an illegal memory access was encountered")
        return materialize(v)

    monkeypatch.setattr(pbatch, "dispatch_prepared", bad_dispatch)
    monkeypatch.setattr(pbatch, "materialize", late_fault)
    res, sup, _ = _run(views, 3, aggregate)
    _healed(views, res, sup)
    assert len(count) > 3  # window 2 went out twice: on the garbage carry, then again
