"""db-analyser's revalidation: stream a stored chain and validate it.

Reference: `Cardano.Tools.DBAnalyser` only-validation (Analysis.hs:75-88,
Run.hs:42-151): every chunk is validated as it is read (index tiling,
CRC and body hash per block — ValidateAllChunks, the chain ends at the
first block that fails), then the headers are revalidated from genesis,
segmented at epoch boundaries and `max_batch`:

  backend="device": the stage kernels on `device` (None -> the CUDA
                    card, raising when it is absent; "cpu" runs the plain
                    PyTorch versions and is what the tests pass). A window
                    of draft-03 (80-byte) proofs runs ed, kes, vrf_prep,
                    vrf_ladders and finish; a window of batch-compatible
                    (128-byte) proofs runs vrf_bc_prep in vrf_prep's place.
                    A chain that switches format is cut into windows at
                    the switch;
  backend="native": the C++ verifier (native/hostcrypto.cpp).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..block.praos_block import Block
from ..protocol import batch as pbatch
from ..protocol.praos import PraosParams, PraosState
from ..protocol.views import LedgerView
from ..storage.immutable import ImmutableDB


@dataclass
class ValidationResult:
    n_blocks: int = 0  # blocks that passed storage validation
    n_valid: int = 0  # headers that passed protocol validation
    error: Exception | None = None
    final_state: PraosState | None = None
    wall_s: float = 0.0
    validate_s: float = 0.0  # protocol validation (staging + kernels + epilogue)


def read_header_views(db_path: str) -> list:
    """Every header view of the chain, in slot order, up to the first
    block that fails storage validation."""
    imm = ImmutableDB(os.path.join(db_path, "immutable"))
    blocks = imm.stream_validated(Block.from_bytes, Block.check_integrity)
    return [b.header.to_view() for b in blocks]


def revalidate(db_path: str, params: PraosParams, lview: LedgerView,
               backend: str = "device", max_batch: int = 8192,
               device=None) -> ValidationResult:
    """Full-chain revalidation from genesis against a constant ledger
    view; -> n_valid, the first error (or None) and the final state."""
    if backend not in ("device", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "device":
        from ..device import resolve

        device = resolve(device)
    res = ValidationResult()
    t0 = time.monotonic()
    hvs = read_header_views(db_path)
    res.n_blocks = len(hvs)
    ts = time.monotonic()
    out = pbatch.validate_chain(params, lambda _e: lview, PraosState(), hvs,
                                max_batch=max_batch, backend=backend,
                                device=device)
    res.validate_s = time.monotonic() - ts
    res.n_valid = out.n_valid
    res.error = out.error
    res.final_state = out.state
    res.wall_s = time.monotonic() - t0
    return res
