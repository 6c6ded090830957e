"""Shared fixture code of the port's replay tests: a small chain forged
by the JAX package's synthesizer (bc proofs by default, draft-03 under
OCT_VRF_BATCH=0), byte corruptions that keep the storage layer's CRCs
consistent, the port's replay on either read path, and the comparison
of the port's replay with the JAX package's sequential host fold."""

import shutil
from fractions import Fraction

import pytest

from ouroboros_consensus_tpu.protocol import views as rviews
from ouroboros_consensus_tpu.protocol.praos import PraosParams
from ouroboros_consensus_tpu.tools import db_analyser as jda
from ouroboros_consensus_tpu.tools import db_synthesizer as jds
from ouroboros_consensus_tpu_torch import carry
from ouroboros_consensus_tpu_torch.testing import corrupt, synth
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

# 1 pool, KES depth 3, 32-slot epochs (~16 blocks each: the 48-block chain
# crosses two epoch boundaries), 24-slot chunks
PARAMS = PraosParams(
    slots_per_kes_period=20, max_kes_evolutions=62, security_param=2,
    active_slot_coeff=Fraction(1, 2), epoch_length=32, kes_depth=3,
)
N_BLOCKS = 48
CHUNK = 24
MID = 24  # the corrupted header's chain index


def forge(path: str, draft03: bool = False):
    """Forge the test chain with the JAX synthesizer: bc proofs, or
    draft-03 ones (the reference's OCT_VRF_BATCH=0)."""
    pools, lview = jds.make_credentials(1, kes_depth=PARAMS.kes_depth)
    with pytest.MonkeyPatch.context() as mp:
        if draft03:
            mp.setenv("OCT_VRF_BATCH", "0")
        jds.synthesize(path, PARAMS, pools, lview, jds.ForgeLimit(blocks=N_BLOCKS),
                       chunk_size=CHUNK, vrf_backend="host")
    return lview


def corrupt_copy(src: str, dst: str, field: str, index: int = MID,
                 resign: bool = False) -> None:
    """Copy the chain and flip one byte of header `index`'s `field`
    ("kes_sig", "vrf_proof" or "ocert_sigma"), re-sealing that block's
    index CRC so only the protocol check can catch the change. With
    `resign`, the header body is KES-signed again by the forging pool, so
    a flipped VRF proof reaches the VRF check."""
    shutil.copytree(src, dst)
    extra = {}
    if resign:
        extra = dict(params=carry.params_from_reference(PARAMS),
                     pool=synth.make_pool(0, kes_depth=PARAMS.kes_depth))
    corrupt.flip_header_byte(dst, index, field, **extra)


def reference(path: str, lview):
    return jda.revalidate(path, PARAMS, lview, backend="host")


def port(path: str, lview, backend: str = "device"):
    return pda.revalidate(path, carry.params_from_reference(PARAMS),
                          carry.lview_from_reference(lview), backend=backend,
                          max_batch=16, device="cpu" if backend == "device" else None)


def replay(path: str, lview, backend: str, columnar: bool):
    """The port's replay on the columnar or the list read path."""
    return pda.revalidate(path, carry.params_from_reference(PARAMS),
                          carry.lview_from_reference(lview), backend=backend,
                          max_batch=16, columnar=columnar,
                          device="cpu" if backend == "device" else None)


def ref_view(hv) -> rviews.HeaderView:
    """A port HeaderView as the JAX package's."""
    oc = hv.ocert
    return rviews.HeaderView(
        prev_hash=hv.prev_hash, vk_cold=hv.vk_cold, vrf_vk=hv.vrf_vk,
        vrf_output=hv.vrf_output, vrf_proof=hv.vrf_proof,
        ocert=rviews.OCert(oc.vk_hot, oc.counter, oc.kes_period, oc.sigma),
        slot=hv.slot, signed_bytes=hv.signed_bytes, kes_sig=hv.kes_sig)


def assert_same(ref, got) -> None:
    assert got.n_valid == ref.n_valid
    assert carry.error_to_plain(got.error) == carry.error_to_plain(ref.error)
    assert carry.state_to_plain(got.final_state) == carry.state_to_plain(ref.final_state)


def assert_same_replay(ref, got) -> None:
    """assert_same, and the same storage prefix (blocks read)."""
    assert got.n_blocks == ref.n_blocks
    assert_same(ref, got)


def forge_faulted(path: str, fault: str | None):
    """Forge the test chain with the JAX synthesizer under the chaos
    spec `fault` (its OCT_CHAOS) -> the ChaosError the writer died of,
    or None (it survived: a silent fault such as a bitflip)."""
    from ouroboros_consensus_tpu.testing import chaos as rchaos

    with pytest.MonkeyPatch.context() as mp:
        if fault:
            mp.setenv("OCT_CHAOS", fault)
        rchaos.reset()
        try:
            forge(path)
        except rchaos.ChaosError as e:
            return e
        finally:
            mp.delenv("OCT_CHAOS", raising=False)
            rchaos.reset()
    return None


def lview_of_chain():
    """The test chain's ledger view (the JAX package's)."""
    return jds.make_credentials(1, kes_depth=PARAMS.kes_depth)[1]


def tree(path: str) -> dict:
    """Every file under `path` (relative name) with its bytes."""
    import os

    out = {}
    for root, _dirs, names in os.walk(path):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def port_native(path: str, lview, **kw):
    """The port's replay on the native backend (keywords revalidate's)."""
    kw.setdefault("max_batch", 16)
    return pda.revalidate(path, carry.params_from_reference(PARAMS),
                          carry.lview_from_reference(lview), backend="native", **kw)


def assert_same_store(ref, got, ref_path: str, got_path: str) -> None:
    """Two replays of twin stores agree: verdicts, state, the repairs and
    the dirty flag, and the directories byte for byte afterwards
    (chunks, indexes, sidecars, quarantine, markers)."""
    assert_same(ref, got)
    assert (got.repairs, got.opened_dirty) == (ref.repairs, ref.opened_dirty)
    assert tree(got_path) == tree(ref_path)


_FORGE_CHILD = r"""
import os, sys
from fractions import Fraction
sys.path.insert(0, sys.argv[1])
from ouroboros_consensus_tpu_torch.protocol.praos import PraosParams
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_synthesizer as ds

params = PraosParams(slots_per_kes_period=20, max_kes_evolutions=62, security_param=2,
                     active_slot_coeff=Fraction(1, 2), epoch_length=32, kes_depth=3)
pool = synth.make_pool(0, kes_depth=3)
ds.synthesize(sys.argv[2], params, [pool], synth.make_ledger_view([pool]),
              ds.ForgeLimit(blocks=48), chunk_size=24, engine="host",
              chaos=sys.argv[3] or None, resume=sys.argv[4] == "1")
"""


def port_forge_child(path: str, fault: str | None = None, resume: bool = False):
    """Forge the test chain with the port's synthesizer (the host engine)
    in a child process, under the chaos spec `fault`; a sigkill fault
    must kill it. -> the finished process."""
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _FORGE_CHILD, repo, path, fault or "", "1" if resume else "0"],
        capture_output=True, timeout=300)
    want = -signal.SIGKILL if fault and fault.startswith("sigkill") else 0
    assert proc.returncode == want, proc.stderr.decode()[-2000:]
    return proc
