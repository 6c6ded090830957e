"""carry.py: the JAX package's fixed-base table and protocol objects
cross into the port without the port importing the JAX package."""

from fractions import Fraction

import pytest
import torch

from ouroboros_consensus_tpu.ops.pk import curve as jcurve
from ouroboros_consensus_tpu.protocol import praos as jpraos
from ouroboros_consensus_tpu.testing import fixtures
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.ops.pk import curve as pc
from ouroboros_consensus_tpu_torch.protocol import praos as ppraos


def test_base8_from_reference_equals_port_table():
    got = carry.base8_from_reference(jcurve.BASE8_NP)
    assert got.shape == (32, 256, 40)
    assert torch.equal(got, pc.base8())


def test_params_lview_roundtrip():
    jp = jpraos.PraosParams(slots_per_kes_period=20, max_kes_evolutions=62,
                            security_param=2, active_slot_coeff=Fraction(1, 2),
                            epoch_length=32, kes_depth=3)
    pp = carry.params_from_reference(jp)
    assert isinstance(pp, ppraos.PraosParams)
    assert pp.stability_window == jp.stability_window
    assert carry.params_from_reference(pp) == pp
    pools = [fixtures.make_pool(i, kes_depth=3) for i in range(2)]
    lv = carry.lview_from_reference(fixtures.make_ledger_view(pools))
    assert carry.lview_from_reference(lv) == lv
    assert all(e.stake == Fraction(1, 2) for e in lv.pool_distr.values())


@pytest.mark.parametrize("empty", [True, False])
def test_state_roundtrip(empty):
    st = jpraos.PraosState() if empty else jpraos.PraosState(
        last_slot=7, ocert_counters={b"k" * 28: 3}, evolving_nonce=b"e" * 32,
        candidate_nonce=b"c" * 32, epoch_nonce=b"n" * 32, lab_nonce=b"l" * 32,
        last_epoch_block_nonce=None)
    ps = carry.state_from_reference(st)
    assert isinstance(ps, ppraos.PraosState)
    assert carry.state_to_plain(ps) == carry.state_to_plain(st)


def test_errors_compare_across_packages():
    a = jpraos.InvalidKesSignatureOCERT(3, 1, 2)
    b = ppraos.InvalidKesSignatureOCERT(3, 1, 2)
    assert carry.error_to_plain(a) == carry.error_to_plain(b)
    assert carry.error_to_plain(a) != carry.error_to_plain(ppraos.InvalidKesSignatureOCERT(3, 1, 1))
    assert carry.error_to_plain(None) is None
