"""The port's replay on its two read paths, on the CPU: `revalidate` on
the columnar path (ViewColumns from the native chunk scan, the default)
and on the list path (`columnar=False`: HeaderView lists from the same
scan), with backend="device" (device="cpu": the plain versions) and
backend="native", on the bc and draft-03 48-block chains forged by the
JAX package and on a mixed-format chain forged by the port. Each is held
to the JAX package's sequential host fold: storage prefix, n_valid,
first error and final PraosState all equal (so the two read paths equal
each other). And `validate_chain` over a HeaderView list whose body
width steps inside an epoch: the window is not cut at the step (it is
staged generically, as the reference stages it) and the result is the
reference's `validate_chain` and host fold, valid and corrupted."""

import dataclasses

import pytest
import torch

from torch_port_chain import (CHUNK, MID, N_BLOCKS, PARAMS, assert_same_replay, forge,
                              ref_view, reference, replay)

from ouroboros_consensus_tpu.protocol import batch as rbatch
from ouroboros_consensus_tpu.protocol import praos as rpraos
from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.protocol import batch as pbatch
from ouroboros_consensus_tpu_torch.protocol.praos import PraosState
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)

PPARAMS = carry.params_from_reference(PARAMS)
SWITCH = 24  # the mixed chain's first batch-compatible block


@pytest.fixture(scope="module", params=["bc", "draft03", "mixed"])
def chain(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    if request.param == "mixed":
        _, lview = jds.make_credentials(1, kes_depth=PARAMS.kes_depth)
        synth.synthesize(path, PPARAMS, [synth.make_pool(0, kes_depth=PARAMS.kes_depth)],
                         carry.lview_from_reference(lview), N_BLOCKS, chunk_size=CHUNK,
                         proof_format=lambda n: 80 if n < SWITCH else 128)
    else:
        lview = forge(path, draft03=request.param == "draft03")
    ref = reference(path, lview)
    assert ref.n_valid == N_BLOCKS and ref.error is None
    return path, lview, ref


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "list"])
@pytest.mark.parametrize("backend", ["device", "native"])
def test_replay_matches_host_fold(chain, backend, columnar, monkeypatch):
    path, lview, ref = chain
    forms = []
    host_prechecks = pbatch.host_prechecks  # once a window, on every backend and loop

    def spy(params, lview_, hvs):
        forms.append(isinstance(hvs, pbatch.ViewColumns))
        return host_prechecks(params, lview_, hvs)

    monkeypatch.setattr(pbatch, "host_prechecks", spy)
    assert_same_replay(ref, replay(path, lview, backend, columnar))
    assert forms and all(f == columnar for f in forms)


def _host_fold(hvs, lview):
    """The reference's sequential fold from genesis: tick, update, stop at
    the first error."""
    st = rpraos.PraosState()
    for i, hv in enumerate(hvs):
        ticked = rpraos.tick(PARAMS, lview, hv.slot, st)
        try:
            st = rpraos.update(PARAMS, hv, hv.slot, ticked)
        except rpraos.PraosValidationError as e:
            return i, e, st
    return len(hvs), None, st


@pytest.mark.parametrize("corrupted", [False, True], ids=["valid", "kes_sig"])
def test_list_with_width_steps_is_not_cut(tmp_path, monkeypatch, corrupted):
    path = str(tmp_path / "db")
    lview = forge(path)
    hvs = pda.read_header_views(path)
    if corrupted:
        sig = bytearray(hvs[MID].kes_sig)
        sig[-1] ^= 0x01
        hvs[MID] = dataclasses.replace(hvs[MID], kes_sig=bytes(sig))
    widths = []
    host_prechecks = pbatch.host_prechecks  # once a window

    def spy(params, lview_, win):
        widths.append({len(hv.signed_bytes) for hv in win})
        return host_prechecks(params, lview_, win)

    monkeypatch.setattr(pbatch, "host_prechecks", spy)
    before = pbatch.DECLINES.get("body-width-mixed", 0)
    got = pbatch.validate_chain(PPARAMS, lambda _e: carry.lview_from_reference(lview),
                                PraosState(), hvs, max_batch=16, device="cpu")
    assert any(len(w) > 1 for w in widths)  # a window holds a width step
    assert pbatch.DECLINES["body-width-mixed"] > before
    rhvs = [ref_view(hv) for hv in hvs]
    ref = rbatch.validate_chain(PARAMS, lambda _e: lview, rpraos.PraosState(), rhvs,
                                max_batch=16, backend="native")
    n, err, st = _host_fold(rhvs, lview)
    assert got.n_valid == ref.n_valid == n == (MID if corrupted else N_BLOCKS)
    assert carry.error_to_plain(got.error) == carry.error_to_plain(ref.error) \
        == carry.error_to_plain(err)
    assert carry.state_to_plain(got.state) == carry.state_to_plain(ref.state) \
        == carry.state_to_plain(st)
