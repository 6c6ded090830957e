"""The port's two read paths on corrupted copies of the 48-block chain
forged by the JAX package, on the CPU: one byte flipped in a mid-chain
header's KES signature, OCert signature, VRF proof (the header KES-signed
again, so that the VRF check fails) or declared body hash, each with the
block's CRC re-sealed. `revalidate` on the columnar and on the list path,
with backend="device" (device="cpu") and backend="native", must give the
JAX package's host fold's storage prefix, n_valid, first error and final
state. A wrong body hash under an intact CRC ends the chain at that block
on both read paths, as in the per-block walk (`read_header_views`)."""

import shutil

import pytest
import torch

from torch_port_chain import (MID, N_BLOCKS, assert_same_replay, corrupt_copy, forge,
                              reference, replay)

from ouroboros_consensus_tpu_torch.testing import corrupt
from ouroboros_consensus_tpu_torch.tools import db_analyser as pda

torch.set_num_threads(1)

# field -> (the error the replay stops with, whether the header is KES-signed again)
CASES = {
    "kes_sig": ("InvalidKesSignatureOCERT", False),
    "ocert_sigma": ("InvalidSignatureOCERT", False),
    "vrf_proof": ("VRFKeyBadProof", True),
    "body_hash": (None, False),
}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "db")
    return path, forge(path)


@pytest.fixture(scope="module", params=sorted(CASES))
def bad(request, chain, tmp_path_factory):
    path, lview = chain
    dst = str(tmp_path_factory.mktemp("bad") / "db")
    field = request.param
    if field == "body_hash":
        shutil.copytree(path, dst)
        corrupt.flip_header_byte(dst, MID, field, offset=5)
    else:
        corrupt_copy(path, dst, field, resign=CASES[field][1])
    # the port reads first: the reference's reader may repair the copy
    got = {(b, c): replay(dst, lview, b, c)
           for b in ("device", "native") for c in (True, False)}
    return field, reference(dst, lview), len(pda.read_header_views(dst)), got


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "list"])
@pytest.mark.parametrize("backend", ["device", "native"])
def test_corrupted_copy_matches_host_fold(bad, backend, columnar):
    field, ref, per_block, got = bad
    expect, _ = CASES[field]
    assert ref.n_valid == MID
    assert (type(ref.error).__name__ if ref.error else None) == expect
    # the storage prefix: the whole chain, or the blocks before the one
    # whose body hash fails (a replay that stops at a protocol error
    # reads no chunk past the one it needs, so n_blocks may stop short)
    assert per_block == (MID if field == "body_hash" else N_BLOCKS)
    if field == "body_hash":
        assert ref.n_blocks == MID
    assert_same_replay(ref, got[(backend, columnar)])
