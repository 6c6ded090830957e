"""The mixed-era composite: ByronMock (PBFT) → Shelley (TPraos) → Babbage
(Praos) [→ Conway (Praos) → Leios (Praos)] through the hard-fork
combinator; the port's copy of the reference's hardfork/composite.py,
its consensus half.

Reference: `CardanoBlock` (Cardano/Block.hs:96), the `CanHardFork`
translations (Cardano/CanHardFork.hs:273) and `protocolInfoCardano`
(Cardano/Node.hs), collapsed to the three protocol classes that matter
for consensus. Era boundaries are config-driven (TriggerHardForkAtEpoch).

`synthesize` forges a chain crossing the transitions into an ImmutableDB
of era-tagged blocks, byte for byte the reference's. `revalidate` reads
it back and validates each era segment with its protocol: a Byron
segment as one batch of Ed25519 verifies (the `ed_verify` kernel on the
card, ops/ed25519_batch.py) and the PBFT window rules folded on the host;
each epoch of a Shelley-family era as one TPraos batch (the generic
staging and the five stage kernels, protocol/tpraos.py) and each epoch of
a Praos era as one Praos batch (the packed staging: unpack, the five
stage kernels and the nonce fold beside them, protocol/batch.py); or all
of them through the C++ verifier (backend "native").

The reference's ledger-backed composite (`with_ledgers`: the era ledgers
folded beside the protocols) waits for the port's ledger eras.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from fractions import Fraction

from .. import native
from ..block import forge as praos_forge
from ..block.praos_block import Block as PraosBlock
from ..device import resolve
from ..ops import ed25519_batch
from ..protocol import praos, tpraos
from ..protocol.forge import BlockAssembler
from ..protocol.instances import (PBFT_BOUNDARY_VIEW, PBftParams, PBftProtocol,
                                  PraosCanBeLeader, PraosProtocol)
from ..protocol.views import hash_vrf_vk
from ..storage.immutable import ImmutableDB
from ..testing import synth
from . import byron_mock
from .byron_mock import ByronMockBlock
from .combinator import Era, HardForkBlock, HardForkProtocol, decode_block
from .history import EraParams, summarize

BACKENDS = ("device", "native")


@dataclass(frozen=True)
class CardanoMockConfig:
    """Genesis-file analog for the composite (the reference's fields)."""

    byron_epochs: int = 2
    byron_epoch_length: int = 40
    shelley_epochs: int = 2
    n_delegs: int = 2  # genesis delegates (Byron signers = the TPraos overlay's)
    shelley_d: Fraction = Fraction(1, 2)
    shelley_f: Fraction = Fraction(1)
    babbage_f: Fraction = Fraction(1)
    epoch_length: int = 60  # shelley + babbage
    # 4th/5th eras (None = the 3-era composite): Conway doubles the epoch
    # length and changes f; Leios changes both again
    conway_epochs: int | None = None  # babbage epochs before conway
    conway_f: Fraction = Fraction(1, 2)
    conway_epoch_length: int = 120
    leios_epochs: int | None = None  # conway epochs before leios
    leios_f: Fraction = Fraction(1)
    leios_epoch_length: int = 30
    k: int = 5
    kes_depth: int = 3
    # with n_delegs round-robin and window k, each delegate signs about
    # k/n_delegs of any window: the threshold must clear that
    pbft_threshold: Fraction = Fraction(4, 5)
    shelley_initial_nonce: bytes = b"\x0b" * 32
    # the reference's ledger-backed composite: not ported (ROADMAP A.11)
    with_ledgers: bool = False
    # the 7-era chain (Cardano/Block.hs:96): byron → shelley → allegra →
    # mary → alonzo → babbage → conway, TPraos through alonzo, Praos from
    # babbage; each bounded era lasts `era_epochs`
    seven_era: bool = False
    era_epochs: int = 2


class CardanoMock:
    """The assembled composite (protocolInfoCardano analog). `device`: where
    the protocols' device batches run (None: the card; "cpu": the plain
    twins)."""

    def __init__(self, cfg: CardanoMockConfig, device=None):
        if cfg.with_ledgers:
            raise ValueError("with_ledgers: the era ledgers are not ported yet (ROADMAP A.11)")
        self.cfg = cfg
        self.device = device
        self.delegs = [synth.make_pool(100 + i, kes_depth=cfg.kes_depth)
                       for i in range(cfg.n_delegs)]
        self.pools = [synth.make_pool(0, kes_depth=cfg.kes_depth)]
        base_view = synth.make_ledger_view(self.pools)
        self.praos_view = base_view
        self.tpraos_view = tpraos.TPraosLedgerView(
            pool_distr=base_view.pool_distr,
            gen_delegs=[tpraos.GenDeleg(d.vk_cold, hash_vrf_vk(d.vrf_vk)) for d in self.delegs],
        )
        common = dict(slots_per_kes_period=100, max_kes_evolutions=62, security_param=cfg.k,
                      epoch_length=cfg.epoch_length, kes_depth=cfg.kes_depth)
        self.tpraos_params = tpraos.TPraosParams(
            praos=praos.PraosParams(active_slot_coeff=cfg.shelley_f, **common),
            decentralization=cfg.shelley_d)
        self.praos_params = praos.PraosParams(active_slot_coeff=cfg.babbage_f, **common)
        self.conway_params = praos.PraosParams(
            active_slot_coeff=cfg.conway_f, **{**common, "epoch_length": cfg.conway_epoch_length})
        self.leios_params = praos.PraosParams(
            active_slot_coeff=cfg.leios_f, **{**common, "epoch_length": cfg.leios_epoch_length})
        self.pbft = PBftProtocol(
            PBftParams(num_genesis_keys=cfg.n_delegs, threshold=cfg.pbft_threshold,
                       window=cfg.k, security_param=cfg.k),
            [d.vk_cold for d in self.delegs])
        self.tpraos_proto = tpraos.TPraosProtocol(self.tpraos_params, device=device)
        self.praos_proto = PraosProtocol(self.praos_params, device=device)
        nonce = cfg.shelley_initial_nonce

        def into_shelley(_byron_state):
            # Byron's PBftState carries nothing Praos-shaped: Shelley starts
            # from the genesis nonce (CanHardFork.hs translation + init)
            return replace(tpraos.TPraosState(), epoch_nonce=nonce)

        byron = Era("byron", self.pbft)
        shelley = Era("shelley", self.tpraos_proto, translate_chain_dep=into_shelley)
        if cfg.seven_era:
            era_params = ([EraParams(cfg.byron_epoch_length, Fraction(1))]
                          + [EraParams(cfg.epoch_length, Fraction(1))] * 6)
            bounds: list = [cfg.byron_epochs]
            for _ in range(5):
                bounds.append(bounds[-1] + cfg.era_epochs)
            bounds.append(None)
            self.eras = [byron, shelley] + [
                Era(n, self.tpraos_proto) for n in ("allegra", "mary", "alonzo")] + [
                # the protocol CLASS changes here (TPraos -> Praos)
                Era("babbage", self.praos_proto, translate_chain_dep=tpraos.translate_state),
                Era("conway", self.praos_proto)]
            self.inner_params = [None] + [self.tpraos_params] * 4 + [self.praos_params] * 2
        else:
            era_params = [EraParams(cfg.byron_epoch_length, Fraction(1)),
                          EraParams(cfg.epoch_length, Fraction(1)),
                          EraParams(cfg.epoch_length, Fraction(1))]
            bounds = [cfg.byron_epochs, cfg.byron_epochs + cfg.shelley_epochs, None]
            self.eras = [byron, shelley,
                         Era("babbage", self.praos_proto,
                             translate_chain_dep=tpraos.translate_state)]
            self.inner_params = [None, self.tpraos_params, self.praos_params]
            if cfg.conway_epochs is not None:
                # Praos -> Praos: the chain-dep state carries over; the
                # era's params (epoch length, f) change
                era_params.append(EraParams(cfg.conway_epoch_length, Fraction(1)))
                bounds[-1] = bounds[-2] + cfg.conway_epochs
                bounds.append(None)
                self.eras.append(Era("conway", PraosProtocol(self.conway_params, device=device)))
                self.inner_params.append(self.conway_params)
                if cfg.leios_epochs is not None:
                    era_params.append(EraParams(cfg.leios_epoch_length, Fraction(1)))
                    bounds[-1] = bounds[-2] + cfg.leios_epochs
                    bounds.append(None)
                    self.eras.append(Era("leios", PraosProtocol(self.leios_params,
                                                                device=device)))
                    self.inner_params.append(self.leios_params)
        self.summary = summarize(Fraction(0), era_params, bounds)
        self.decoders = [ByronMockBlock.from_bytes] + [PraosBlock.from_bytes] * (len(self.eras) - 1)
        self.hf = HardForkProtocol(self.eras, self.summary)
        self._assemblers: dict = {}

    def is_tpraos_era(self, era: int) -> bool:
        return isinstance(self.eras[era].protocol, tpraos.TPraosProtocol)

    def view_for_era(self, era: int):
        if era == 0:
            return None
        return self.tpraos_view if self.is_tpraos_era(era) else self.praos_view

    def assembler(self, params: praos.PraosParams) -> BlockAssembler:
        """One block assembler (its OCert cache) a parameter set, over the
        delegates' and the pool's credentials."""
        if params not in self._assemblers:
            self._assemblers[params] = BlockAssembler(params, self.delegs + self.pools)
        return self._assemblers[params]


# ---------------------------------------------------------------------------
# Synthesis (db-synthesizer over the composite)
# ---------------------------------------------------------------------------


def synthesize(path: str, cfg: CardanoMockConfig, n_slots: int, chunk_size: int = 500) -> int:
    """Forge a chain over slots 0 .. n_slots - 1 crossing the era
    boundaries into `<path>/immutable`; -> the block count."""
    cm = CardanoMock(cfg, device="cpu")  # the forge runs on the host
    os.makedirs(path, exist_ok=True)
    imm = ImmutableDB(os.path.join(path, "immutable"), chunk_size=chunk_size, repair=True)
    if not imm.is_empty:
        raise RuntimeError(f"refusing to forge into non-empty DB at {path}")
    st = cm.hf.initial_state()
    prev: bytes | None = None
    block_no = 0
    n_blocks = 0
    for slot in range(n_slots):
        era = cm.hf.era_of_slot(slot)
        ticked = cm.hf.tick(cm.view_for_era(era), slot, st)
        if era == 0:
            if slot % cfg.byron_epoch_length == 0:
                # each Byron epoch opens with an EBB (Byron/EBBs.hs):
                # unsigned, empty, block number NOT advanced
                ebb = byron_mock.forge_ebb(slot=slot, block_no=max(0, block_no - 1),
                                           prev_hash=prev)
                hfb = HardForkBlock(era, ebb)
                imm.append_block(slot, ebb.block_no, hfb.hash_, hfb.bytes_)
                st = cm.hf.reupdate(ebb.header.to_view(), slot, ticked)
                prev = hfb.hash_
                n_blocks += 1
                continue  # the EBB owns the epoch's first slot
            blk = byron_mock.forge_block(cm.delegs[slot % cfg.n_delegs].cold_seed, slot=slot,
                                         block_no=block_no, prev_hash=prev,
                                         txs=(b"byron-tx-%d" % slot,))
        else:
            params = cm.inner_params[era]
            eta0 = ticked.inner.state.epoch_nonce
            if cm.is_tpraos_era(era):
                a = tpraos.overlay_slot_assignment(cm.tpraos_params, cfg.n_delegs, slot)
                if a is not None:
                    active, j = a
                    if not active:
                        continue  # an inactive overlay slot stays empty
                    creds = cm.delegs[j]
                else:
                    creds = cm.pools[0]
                inner_params = cm.tpraos_params.praos
            else:
                creds = cm.pools[0]
                inner_params = params
                if inner_params.active_slot_coeff != 1:
                    # an f < 1 era: the real leader lottery
                    win = cm.eras[era].protocol.check_is_leader(
                        PraosCanBeLeader(None, creds.vk_cold, creds.vrf_seed), slot,
                        praos.TickedPraosState(replace(praos.PraosState(), epoch_nonce=eta0),
                                               cm.praos_view))
                    if win is None:
                        continue
            blk = praos_forge.forge_block(inner_params, creds, slot=slot, block_no=block_no,
                                          prev_hash=prev, epoch_nonce=eta0,
                                          txs=(b"tx-%d" % slot,),
                                          assembler=cm.assembler(inner_params))
        hfb = HardForkBlock(era, blk)
        imm.append_block(slot, block_no, hfb.hash_, hfb.bytes_)
        st = cm.hf.reupdate(blk.header.to_view(), slot, ticked)
        prev = hfb.hash_
        block_no += 1
        n_blocks += 1
    imm.flush()
    return n_blocks


# ---------------------------------------------------------------------------
# Revalidation (db-analyser --only-validation over the composite)
# ---------------------------------------------------------------------------


@dataclass
class MixedResult:
    n_blocks: int = 0
    n_valid: int = 0
    error: Exception | None = None
    final_state: object | None = None
    per_era: dict | None = None  # era name -> valid headers
    era_seconds: dict | None = None  # era name -> wall seconds of its validation


def validate_pbft_segment(proto: PBftProtocol, headers, st, backend: str, device=None):
    """A Byron segment: the signatures as one batch (the `ed_verify`
    kernel, backend "device"; the C++ verifier a header, "native"), then
    the PBFT rules folded on the host in the reference's order
    (apply_checked_sig). The boundary views (EBBs) carry no signature:
    they stay out of the batch and change no state. -> (state, n_valid,
    error)."""
    views = [h.to_view() for h in headers]
    regular = [v for v in views if v is not PBFT_BOUNDARY_VIEW]
    if backend == "native":
        reg_ok = [native.ed25519_verify(v.issuer_vk, v.signature, v.signed_bytes)
                  for v in regular]
    elif regular:
        reg_ok = ed25519_batch.verify_batch([v.issuer_vk for v in regular],
                                            [v.signature for v in regular],
                                            [v.signed_bytes for v in regular],
                                            device=device).tolist()
    else:
        reg_ok = []
    it = iter(reg_ok)
    for i, (h, view) in enumerate(zip(headers, views)):
        if view is PBFT_BOUNDARY_VIEW:
            continue  # boundary: no state change (PBFT.hs:326)
        try:
            st = proto.apply_checked_sig(st, h.slot, view.issuer_vk, next(it))
        except Exception as e:  # noqa: BLE001 — the PBFT rule errors end the segment
            return st, i, e
    return st, len(views), None


def revalidate(path: str, cfg: CardanoMockConfig, backend: str = "device", device=None,
               trace=None) -> MixedResult:
    """Full mixed-era revalidation (Cardano/CanHardFork.hs:273 semantics):
    decode the era-tagged blocks, walk the telescope, validate each era
    segment with its protocol — a Byron segment as one signature batch,
    each epoch of a Praos-class era as one batch. `backend` "device" runs
    the batches on `device` (None: the card, raising without CUDA; "cpu":
    the plain twins), "native" through the C++ verifier. `trace(era,
    headers)` is called after each era segment (its seconds are in
    `era_seconds`). The store opens read-only."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "device":
        device = resolve(device)
    cm = CardanoMock(cfg, device=device)
    imm = ImmutableDB(os.path.join(path, "immutable"))
    res = MixedResult(per_era={}, era_seconds={})
    blocks = [decode_block(raw, cm.decoders) for _e, raw in imm.stream_all()]
    res.n_blocks = len(blocks)
    st = cm.hf.initial_state()
    i = 0
    while i < len(blocks):
        era = blocks[i].era
        j = i
        while j < len(blocks) and blocks[j].era == era:
            j += 1
        seg = blocks[i:j]
        t0 = time.perf_counter()
        st = cm.hf.cross_eras(st, era)  # the telescope walked into this era
        proto = cm.eras[era].protocol
        if era == 0:
            inner, n_ok, err = validate_pbft_segment(proto, [b.header for b in seg], st.inner,
                                                     backend, device)
        else:
            params = cm.inner_params[era]
            lview = cm.view_for_era(era)
            inner, n_ok, err = st.inner, 0, None
            hvs = [b.header.to_view() for b in seg]
            s0 = 0
            while s0 < len(hvs):  # one batch an epoch
                ep = params.epoch_of(hvs[s0].slot)
                s1 = s0
                while s1 < len(hvs) and params.epoch_of(hvs[s1].slot) == ep:
                    s1 += 1
                b = proto.validate_batch(proto.tick(lview, hvs[s0].slot, inner), hvs[s0:s1],
                                         backend=backend)
                inner = b.state
                n_ok += b.n_valid
                if b.error is not None:
                    err = b.error
                    break
                s0 = s1
        st = replace(st, inner=inner)
        name = cm.eras[era].name
        dt = time.perf_counter() - t0
        res.n_valid += n_ok
        res.per_era[name] = res.per_era.get(name, 0) + n_ok
        res.era_seconds[name] = res.era_seconds.get(name, 0.0) + dt
        if trace is not None:
            trace(name, j - i)
        if err is not None:
            res.error = err
            break
        i = j
    res.final_state = st
    return res
