"""db-synthesizer: forge a synthetic Praos chain into an ImmutableDB.

    python -m ouroboros_consensus_tpu_torch.tools.db_synthesizer --out DB --blocks 100000
    python -m ouroboros_consensus_tpu_torch.tools.db_synthesizer --out DB --slots 20000 \\
        --pools 3 --engine host --proof-format draft03

Reference: `Cardano.Tools.DBSynthesizer`'s `runForge` loop
(Tools/DBSynthesizer/Forging.hs:54-57) without clock or network: per
slot, check leadership for every credential, forge the first winner's
block and append it to the ImmutableDB, threading the protocol state with
the crypto-free `reupdate`; then seal every chunk's walked sidecar
(storage/sidecar.py). The JAX package's tools/db_synthesizer.py
(:31-366, :571) is the port's reference. `ForgeLimit` stops it after a
number of slots, blocks or epochs.

Engines (a keyword, `engine`):

* "device" (the default): each election window (protocol/forge.py:
  window_slots pairs, cut at epoch ends and near a blocks limit) in one
  launch of the `forge_sweep` kernel on the card, the window's OCert
  signatures in one `ed_sign` launch, then the sequential assembly of the
  won slots (forge.BlockAssembler). It runs on the CUDA card (raising
  without one) unless the caller passes device="cpu", where the kernels'
  plain twins run;
* "host": the same windows with a native prove per pair and one
  vectorised leader bracket;
* "loop": the per-slot loop above, a native prove per slot and pool.

The three give the same chunk, index and sidecar bytes, `n_slots`,
`n_blocks` and final state for the same seeds, parameters and limit, and
they are the JAX package's `synthesize(..., vrf_backend="host")` bytes
(tests/test_torch_forge.py). `proof_format` picks each block's VRF proof:
"bc" (128-byte batch-compatible), "draft03" (80 bytes), or a callable
block_no -> 80 | 128.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from fractions import Fraction

from .. import native
from ..device import resolve
from ..protocol import forge as pforge
from ..protocol import nonces, praos
from ..protocol.leader import is_leader
from ..protocol.praos import PraosParams, PraosState
from ..protocol.views import LedgerView
from ..block.praos_block import Block
from ..storage import guard as guard_mod
from ..storage import sidecar
from ..storage.immutable import ImmutableDB
from ..storage.open import open_repair_store
from ..testing import chaos as chaos_mod
from ..testing import synth

ENGINES = ("device", "host", "loop")


@dataclass(frozen=True)
class ForgeLimit:
    """The stop condition, one of the three set (Types.hs ForgeLimit)."""

    slots: int | None = None
    blocks: int | None = None
    epochs: int | None = None

    def reached(self, params: PraosParams, slot: int, block_no: int) -> bool:
        return ((self.slots is not None and slot >= self.slots)
                or (self.blocks is not None and block_no >= self.blocks)
                or (self.epochs is not None and params.epoch_of(slot) >= self.epochs))


@dataclass
class ForgeResult:
    """The run's counts, its wall and final state; `elect_s` and
    `assemble_s` split the wall's forging between the election (proves,
    leader checks, the OCert batch) and the sequential assembly (blocks,
    KES signatures, appends, reupdate)."""

    n_slots: int = 0
    n_blocks: int = 0
    wall_s: float = 0.0
    final_state: PraosState | None = None
    elect_s: float = 0.0
    assemble_s: float = 0.0


def default_params(kes_depth: int = 7) -> PraosParams:
    """The reference CLI's chain parameters (mainnet-shaped ratios scaled
    down so that a synthetic chain crosses epochs)."""
    return PraosParams(slots_per_kes_period=3600, max_kes_evolutions=62, security_param=108,
                       active_slot_coeff=Fraction(1, 2), epoch_length=4320, kes_depth=kes_depth)


def make_credentials(n_pools: int, kes_depth: int = 7):
    """-> (pools made from seeds 0 .. n_pools - 1, their equal-stake view)."""
    pools = [synth.make_pool(i, kes_depth=kes_depth) for i in range(n_pools)]
    return pools, synth.make_ledger_view(pools)


def proof_formats(proof_format) -> frozenset:
    """The proof lengths `proof_format` may give a block: {128} for "bc",
    {80} for "draft03", both for a callable."""
    if callable(proof_format):
        return frozenset({80, 128})
    return frozenset({synth.proof_length(proof_format, 0)})


class _Chain:
    """The state the forge threads from block to block."""

    def __init__(self):
        self.state = PraosState()
        self.prev_hash: bytes | None = None
        self.block_no = 0
        self.slot = 0
        self.counters: dict[bytes, int] = {}


def _txs(slot: int, txs_per_block: int) -> tuple:
    return tuple(b"tx-%d-%d" % (slot, i) for i in range(txs_per_block))


def _append(imm, params, ch: _Chain, ticked, block, res: ForgeResult, trace) -> None:
    imm.append_block(block.slot, ch.block_no, block.hash_, block.bytes_)
    ch.state = praos.reupdate(params, block.header.to_view(), block.slot, ticked)
    ch.prev_hash = block.hash_
    ch.block_no += 1
    res.n_blocks += 1
    if res.n_blocks % 1000 == 0:
        trace(f"forged {res.n_blocks} blocks to slot {block.slot}")


_PROVERS = {80: native.ecvrf_prove, 128: native.ecvrf_prove_bc}


def _forge_loop(imm, params, pools, lview, limit, res, ch: _Chain, txs_per_block,
                proof_format, trace) -> None:
    """The per-slot loop: tick, then each credential in list order proves
    the slot in the next block's format; the first winner forges (one
    block a slot), assembled as the windowed engines assemble."""
    asm = pforge.BlockAssembler(params, pools)
    f = params.active_slot_coeff
    while not limit.reached(params, ch.slot, ch.block_no):
        t0 = time.perf_counter()
        ticked = praos.tick(params, lview, ch.slot, ch.state)
        alpha = nonces.mk_input_vrf(ch.slot, ticked.state.epoch_nonce)
        won = None
        for i, pool in enumerate(pools):
            entry = lview.pool_distr.get(pool.pool_id)
            if entry is None:
                continue
            proof = _PROVERS[synth.proof_length(proof_format, ch.block_no)](pool.vrf_seed, alpha)
            beta = native.proof_to_hash(proof)
            if is_leader(nonces.vrf_leader_value(beta), entry.stake, f):
                won = (i, beta, proof)
                break
        t1 = time.perf_counter()
        res.elect_s += t1 - t0
        if won is not None:
            i, beta, proof = won
            pool = pools[i]
            n = ch.counters.get(pool.pool_id, 0)
            block = asm.forge(i, slot=ch.slot, block_no=ch.block_no, prev_hash=ch.prev_hash,
                              txs=_txs(ch.slot, txs_per_block), ocert_counter=n,
                              vrf_output=beta, vrf_proof=proof)
            _append(imm, params, ch, ticked, block, res, trace)
            ch.counters[pool.pool_id] = n
            res.assemble_s += time.perf_counter() - t1
        ch.slot += 1
        res.n_slots += 1


def _forge_pipeline(imm, params, pools, lview, limit, res, ch: _Chain, txs_per_block,
                    proof_format, engine, dev, trace) -> None:
    """The windowed forge: elect a window of slots at once (protocol/
    forge.elect_window), then assemble its won slots in order. A window
    ends at its epoch's end (η0 is epoch-constant), at the slots limit,
    and near a blocks limit (about 2/f slots a block still owed, plus
    64); under a blocks limit the slots counted end at the block that
    reaches it, as the loop's do."""
    asm = pforge.BlockAssembler(params, pools)
    formats = proof_formats(proof_format)
    thr = pforge.pool_thresholds(params, lview, pools)
    table = (pforge.device_table(pforge.stage_pools(pools), thr, dev)
             if engine == "device" else None)
    while not limit.reached(params, ch.slot, ch.block_no):
        t0 = time.perf_counter()
        slot = ch.slot
        eta0 = praos.tick(params, lview, slot, ch.state).state.epoch_nonce
        wend = min((params.epoch_of(slot) + 1) * params.epoch_length,
                   slot + pforge.window_slots(len(pools)))
        if limit.slots is not None:
            wend = min(wend, limit.slots)
        if limit.blocks is not None:
            need = limit.blocks - ch.block_no
            wend = min(wend, slot + int(2 * need / float(params.active_slot_coeff)) + 64)
        wend = max(wend, slot + 1)
        elected = pforge.elect_window(params, pools, thr, range(slot, wend), eta0, engine,
                                      table, formats)
        if engine == "device":
            triples = {(el.pool, ch.counters.get(pools[el.pool].pool_id, 0),
                        asm.ocert_window(el.slot)) for el in elected}
            asm.ocerts.update(pforge.sign_ocerts_batch(pools, triples - asm.ocerts.keys(), dev))
        t1 = time.perf_counter()
        res.elect_s += t1 - t0
        last = slot
        for el in elected:
            if limit.blocks is not None and ch.block_no >= limit.blocks:
                break
            pool = pools[el.pool]
            ticked = praos.tick(params, lview, el.slot, ch.state)
            n = ch.counters.get(pool.pool_id, 0)
            block = asm.forge(el.pool, slot=el.slot, block_no=ch.block_no,
                              prev_hash=ch.prev_hash, txs=_txs(el.slot, txs_per_block),
                              ocert_counter=n, vrf_output=el.beta,
                              vrf_proof=el.proofs[synth.proof_length(proof_format, ch.block_no)])
            _append(imm, params, ch, ticked, block, res, trace)
            ch.counters[pool.pool_id] = n
            last = el.slot
        res.assemble_s += time.perf_counter() - t1
        if limit.blocks is not None and ch.block_no >= limit.blocks:
            wend = last + 1
        res.n_slots += wend - slot
        ch.slot = wend


def synthesize(db_path: str, params: PraosParams, pools: list, lview: LedgerView,
               limit: ForgeLimit, txs_per_block: int = 0, chunk_size: int = 21600,
               engine: str = "device", device=None, proof_format="bc",
               trace=lambda s: None, resume: bool = False,
               network_magic: int | None = None, chaos=None) -> ForgeResult:
    """Forge into `<db_path>/immutable` until `limit`, with `engine`
    (module doc) on `device` (the device engine's: None is the CUDA
    card); `trace` gets a line every 1,000 blocks. -> ForgeResult.
    Flushes the store and seals every chunk's walked sidecar at the end.

    The forge speaks the store's crash protocol (storage/guard.py, the
    reference's synthesize): the lock is held throughout, a virgin
    store's chain-magic marker is written (`network_magic`, None: the
    default magic, or whatever marker exists), and the clean-shutdown
    marker is absent while it forges and written back after the last
    flush, so a killed forge leaves a dirty store. The store must be
    empty (checked read-only first, so a refusal touches nothing)
    unless `resume`: then a dirty store is opened with the deep repair
    (torn tails cut and quarantined, lagging indexes rebuilt), the
    forging state is rebuilt by folding `reupdate` over the surviving
    chain, and the forge goes on from its tip; forging is
    deterministic, so a killed forge resumed gives the bytes of one
    that ran through. `chaos`: a fault plan (testing/chaos.py) armed
    for the call; the store writer's seams are its append and sidecar
    build."""
    if engine not in ENGINES:
        raise ValueError(f"unknown forge engine {engine!r}")
    if limit.slots is None and limit.blocks is None and limit.epochs is None:
        raise ValueError("the forge limit sets none of slots, blocks, epochs")
    proof_formats(proof_format)  # refuse an unknown format before forging
    dev = resolve(device) if engine == "device" else None
    os.makedirs(db_path, exist_ok=True)
    with chaos_mod.arming(chaos):
        # a reader first: a refusal below must leave the store untouched
        guard = guard_mod.StoreGuard(db_path, network_magic=network_magic, writer=False)
        guard.open()
        try:
            if resume:
                guard.promote_writer()
                if guard.opened_dirty:
                    imm = open_repair_store(db_path, chunk_size=chunk_size)
                else:
                    imm = ImmutableDB(os.path.join(db_path, "immutable"),
                                      chunk_size=chunk_size, repair=True)
            else:
                imm = ImmutableDB(os.path.join(db_path, "immutable"), chunk_size=chunk_size)
                if not imm.is_empty:
                    raise RuntimeError(f"refusing to forge into non-empty DB at {db_path} "
                                       "(pass resume=True to continue a killed forge)")
                if imm.repairs:
                    raise RuntimeError(f"refusing to forge into corrupted store at {db_path} "
                                       "(pass resume=True to repair and continue)")
                guard.promote_writer()
                imm.prepare_write()
            res = _forge(imm, params, pools, lview, limit, txs_per_block, proof_format,
                         engine, dev, trace)
        except BaseException:
            guard.close(clean=False)
            raise
        guard.close(clean=True)
    return res


def _resumed_chain(params: PraosParams, lview: LedgerView, imm) -> _Chain:
    """The forging state at the surviving chain's tip: the crypto-free
    `reupdate` folded over its blocks (the forge signed them itself)."""
    ch = _Chain()
    for _e, raw in imm.stream_all():
        b = Block.from_bytes(raw)
        ticked = praos.tick(params, lview, b.slot, ch.state)
        ch.state = praos.reupdate(params, b.header.to_view(), b.slot, ticked)
        ch.prev_hash, ch.block_no, ch.slot = b.hash_, b.block_no + 1, b.slot + 1
    ch.counters = dict(ch.state.ocert_counters)
    return ch


def _forge(imm, params, pools, lview, limit, txs_per_block, proof_format, engine, dev,
           trace) -> ForgeResult:
    res = ForgeResult()
    t0 = time.monotonic()
    ch = _Chain()
    if not imm.is_empty:
        ch = _resumed_chain(params, lview, imm)
        trace(f"resuming the forge at slot {ch.slot} ({ch.block_no} blocks survive)")
    if engine == "loop":
        _forge_loop(imm, params, pools, lview, limit, res, ch, txs_per_block, proof_format,
                    trace)
    else:
        _forge_pipeline(imm, params, pools, lview, limit, res, ch, txs_per_block,
                        proof_format, engine, dev, trace)
    imm.flush()
    sidecar.backfill_store(imm, walked=True)
    res.wall_s = time.monotonic() - t0
    res.final_state = ch.state
    return res


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="db_synthesizer", description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="chain DB directory to create")
    p.add_argument("--pools", type=int, default=2)
    p.add_argument("--kes-depth", type=int, default=7)
    lim = p.add_mutually_exclusive_group(required=True)
    lim.add_argument("--slots", type=int)
    lim.add_argument("--blocks", type=int)
    lim.add_argument("--epochs", type=int)
    p.add_argument("--txs-per-block", type=int, default=0)
    p.add_argument("--engine", choices=ENGINES, default="device")
    p.add_argument("--proof-format", choices=("bc", "draft03"), default="bc")
    p.add_argument("--resume", action="store_true",
                   help="continue a killed forge into its store (deep repair first)")
    p.add_argument("--network-magic", type=int, default=None,
                   help="the chain magic the store's marker binds it to")
    p.add_argument("--cardano", action="store_true",
                   help="forge the mixed-era composite (era-tagged blocks crossing the "
                        "Byron/Shelley/Babbage boundaries); pairs with db_analyser --cardano")
    p.add_argument("--with-ledgers", action="store_true",
                   help="with --cardano: the era ledgers in the loop (not ported yet)")
    a = p.parse_args(argv)
    if a.with_ledgers and not a.cardano:
        p.error("--with-ledgers requires --cardano")
    if a.cardano:
        from ..hardfork import composite as cardano

        if not a.slots:
            p.error("--cardano forges by --slots")
        try:
            n = cardano.synthesize(a.out, cardano.CardanoMockConfig(with_ledgers=a.with_ledgers),
                                   a.slots)
        except ValueError as e:
            p.error(str(e))
        print(f"forged {n} blocks over {a.slots} slots at {a.out}")
        return 0
    params = default_params(kes_depth=a.kes_depth)
    pools, lview = make_credentials(a.pools, kes_depth=a.kes_depth)
    res = synthesize(a.out, params, pools, lview,
                     ForgeLimit(slots=a.slots, blocks=a.blocks, epochs=a.epochs),
                     txs_per_block=a.txs_per_block, engine=a.engine,
                     proof_format=a.proof_format, trace=print, resume=a.resume,
                     network_magic=a.network_magic)
    print(f"forged {res.n_blocks} blocks over {res.n_slots} slots in {res.wall_s:.1f}s "
          f"(election {res.elect_s:.1f}s, assembly {res.assemble_s:.1f}s; engine {a.engine})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
