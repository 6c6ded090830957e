"""Seeded multi-peer candidate-suffix traffic for the serving plane, with
real crypto.

A node that follows the tip validates the short candidate suffixes that
many ChainSync peers push at once. This module forges that shape from
one integer seed: N tenants (peers), each emitting rounds of suffixes
from its own fork of a shared tip, so that the serving plane
(node/serve.py), its tests, tools/serve_bench.py and chip_smoke.py drive
the same byte-reproducible traffic. The JAX package's testing/traffic.py
is the reference for the configuration and the shapes; its crypto is
stubbed (Blake2b expansions), which every lane on the card would fail.
Here every header is a real one:

  * leader slots come from the port's election, protocol/forge.py's
    `elect_window` (engine "device", the `forge_sweep` kernel, on the
    card), or from the per-slot loop of tools/db_synthesizer.py (a
    native prove a slot, on the CPU): a tenant forges only in slots its
    pool leads;
  * the OCert issues come from `sign_ocerts_batch` (the `ed_sign` kernel)
    on the card, from the native signer on the CPU, and the headers from
    `BlockAssembler` (a CBOR body, the KES signature), as header views;
    no store is written.

Failures ride the real error paths:

  * a counter jump   -> an OCert issued at n+2:
                        CounterOverIncrementedOCERT at that lane
  * an unknown pool  -> a header forged by a pool missing from the
                        ledger view: NoCounterForKeyHashOCERT (the
                        counter check precedes the VRF pool lookup)

Traffic shapes (all seeded), as the reference's:

  * follow        — one peer extending the tip, one suffix a round
  * fork storm    — the first `fork_storm` peers start on one slot grid
  * equivocators  — storm pairs sharing their pool: the same pool
                    forging two different headers a slot, on two peers
  * mixed formats — every `bc_every`-th tenant carries 128-byte
                    batch-compatible proofs, the rest 80-byte draft-03
  * counter jump and unknown pool, as above

The geometry is a tip of bench.py's chain (its parameters,
tools/bench.bench_params, at any KES depth): the tip at slot
`base_slot - 1`, block `base_slot // 2`, and every suffix inside the
tip's epoch (the service holds one epoch nonce) and its KES evolution
window. At the default `base_slot` (892,800: epoch 20 of 43,200-slot
epochs, the OCert window starting at KES period 248) a header's signed
bytes have the width of the bench chain's headers there. Each block's
body is one `body_len`-byte transaction naming its tenant, so two peers'
headers of one slot differ. The same seed gives the same bytes on either
engine. Real networking (mux, delta-Q, peer churn) is not simulated."""

from __future__ import annotations

import bisect
import hashlib
import time
from dataclasses import dataclass
from fractions import Fraction

from .. import native
from ..device import resolve
from ..protocol import forge as pforge
from ..protocol import nonces
from ..protocol.leader import is_leader
from ..protocol.praos import PraosParams, PraosState
from . import synth

__all__ = [
    "TrafficConfig", "TenantSpec", "Suffix", "Traffic", "make_traffic", "traffic_params",
]

# draft-03 / batch-compatible ECVRF proof lengths (protocol/views.py)
PROOF_LEN_DRAFT03 = 80
PROOF_LEN_BC = 128

_PROVERS = {PROOF_LEN_DRAFT03: native.ecvrf_prove, PROOF_LEN_BC: native.ecvrf_prove_bc}


def _expand(tag: bytes, data: bytes, n: int) -> bytes:
    """Counter-mode Blake2b expansion: the seeded byte source of the
    epoch nonce, the tip and the transactions."""
    out = b""
    i = 0
    while len(out) < n:
        out += hashlib.blake2b(
            tag + i.to_bytes(2, "big") + data, digest_size=32
        ).digest()
        i += 1
    return out[:n]


def traffic_params(kes_depth: int = 7) -> PraosParams:
    """bench.py's chain parameters at `kes_depth` (tools/bench.bench_params
    is kes_depth 7): 3,600-slot KES periods, 62 evolutions, k = 2,160,
    f = 1/2, 43,200-slot epochs."""
    return PraosParams(slots_per_kes_period=3600, max_kes_evolutions=62, security_param=2160,
                       active_slot_coeff=Fraction(1, 2), epoch_length=43200,
                       kes_depth=kes_depth)


@dataclass(frozen=True)
class TrafficConfig:
    """One seeded traffic mix: the reference's fields. Defaults are
    tier-1 sized; chip_smoke.py and tools/serve_bench.py scale them."""

    n_tenants: int = 8
    seed: int = 0
    suffix_len: int = 12  # headers per suffix
    rounds: int = 2  # suffixes per tenant
    n_pools: int = 4
    body_len: int = 16  # bytes of each block's one transaction
    kes_depth: int = 3  # a small tree: a leaf path is 2^depth leaf derives
    bc_every: int = 0  # every k-th tenant uses 128-byte bc proofs (0: off)
    fork_storm: int = 0  # the first `fork_storm` tenants share one slot grid
    equivocators: int = 0  # pairs inside the storm sharing their pool
    bad_lane_every: int = 0  # every k-th tenant: a counter jump, even rounds
    unknown_pool_every: int = 0  # every k-th tenant: a foreign-pool lane, odd rounds
    base_slot: int = 892_800  # the first slot after the tip (module doc)
    slot_stride: int = 3  # at least this many slots between a tenant's headers


@dataclass(frozen=True)
class TenantSpec:
    """One simulated peer: identity, forging pool, proof format and
    which failure (if any) its suffixes carry."""

    tenant_id: str
    pool_idx: int
    proof_len: int = PROOF_LEN_DRAFT03
    storm_group: int | None = None  # shared-grid fork-storm member
    equivocal_with: str | None = None  # the peer sharing pool and slots
    bad_lane: int | None = None  # in-suffix index of the counter jump
    unknown_pool_lane: int | None = None  # in-suffix index of the foreign pool


@dataclass(frozen=True)
class Suffix:
    """One candidate suffix as a peer offers it: tenant, per-tenant
    sequence number, and the forged header views in chain order."""

    tenant_id: str
    seq: int
    hvs: tuple


@dataclass
class _TenantForgeState:
    """The forge's chain cursor of a tenant (not validation state)."""

    next_slot: int
    block_no: int
    prev_hash: bytes
    suffixes: int = 0


class Traffic:
    """Deterministic traffic source: `suffixes()` yields the seeded
    arrival order (round-robin across tenants, the interleaving the
    scheduler must be fair under); `genesis_state()` is the shared tip's
    state every tenant's candidate chain extends. `params`: the
    protocol parameters (None: `traffic_params(cfg.kes_depth)`);
    `device`: None is the CUDA card, where the election and the OCert
    issues run as kernels; "cpu" forges by the native loop. `elect_s`
    and `assemble_s` accumulate the forge's time."""

    def __init__(self, cfg: TrafficConfig, params: PraosParams | None = None, device=None):
        if cfg.n_tenants < 1 or cfg.n_pools < 1:
            raise ValueError("traffic needs >= 1 tenant and >= 1 pool")
        self.cfg = cfg
        self.params = params if params is not None else traffic_params(cfg.kes_depth)
        if self.params.kes_depth != cfg.kes_depth:
            raise ValueError(f"params of KES depth {self.params.kes_depth}, "
                             f"traffic of {cfg.kes_depth}")
        self.device = resolve(device)
        self.engine = "device" if self.device.type == "cuda" else "loop"
        self.pools = [synth.make_pool(1000 + i, kes_depth=cfg.kes_depth)
                      for i in range(cfg.n_pools)]
        # one pool deliberately outside the ledger view: the unknown-pool
        # lanes forge from it
        self.foreign_pool = synth.make_pool(9999, kes_depth=cfg.kes_depth)
        self.lview = synth.make_ledger_view(self.pools)
        seed = cfg.seed.to_bytes(8, "big")
        self.eta0 = _expand(b"eta0", seed, 32)
        self.tip_hash = _expand(b"tip", seed, 32)
        self.tip_slot = cfg.base_slot - 1
        p = self.params
        self.slot_end = p.first_slot_of(p.epoch_of(cfg.base_slot) + 1)  # exclusive
        kp0 = cfg.base_slot // p.slots_per_kes_period
        kp0 -= kp0 % p.max_kes_evolutions
        self.slot_end = min(self.slot_end, (kp0 + min(p.max_kes_evolutions,
                                                      1 << cfg.kes_depth))
                            * p.slots_per_kes_period)
        self.tenants = self._make_tenants()
        self._asm = pforge.BlockAssembler(self.params, self.pools + [self.foreign_pool])
        self._wins: dict[int, list] = {}  # pool index -> [(slot, beta, proofs)]
        self._win_slots: dict[int, list] = {}
        self._elected_to = cfg.base_slot  # slots elected: [base_slot, _elected_to)
        self._forge: dict[str, _TenantForgeState] = {}
        self._forged: dict[tuple, tuple] = {}  # (tenant, k) -> (Suffix, cursor after)
        self.elect_s = 0.0
        self.assemble_s = 0.0

    # -- tenant mix ---------------------------------------------------------

    def _make_tenants(self) -> list[TenantSpec]:
        cfg = self.cfg
        out: list[TenantSpec] = []
        for i in range(cfg.n_tenants):
            tid = f"peer-{i:03d}"
            storm = i if i < cfg.fork_storm else None
            # equivocator pairs live inside the storm: peers 2j / 2j+1
            # forge from the same pool over the same slots
            eq_with = None
            if storm is not None and i < 2 * cfg.equivocators:
                eq_with = f"peer-{(i ^ 1):03d}"
            pool_idx = (i // 2 if eq_with is not None else i) % cfg.n_pools
            plen = (PROOF_LEN_BC if cfg.bc_every and (i % cfg.bc_every == cfg.bc_every - 1)
                    else PROOF_LEN_DRAFT03)
            bad = (cfg.suffix_len // 2
                   if cfg.bad_lane_every and (i % cfg.bad_lane_every == cfg.bad_lane_every - 1)
                   else None)
            unk = (cfg.suffix_len // 3
                   if cfg.unknown_pool_every
                   and (i % cfg.unknown_pool_every == cfg.unknown_pool_every - 1)
                   else None)
            out.append(TenantSpec(tenant_id=tid, pool_idx=pool_idx, proof_len=plen,
                                  storm_group=storm, equivocal_with=eq_with,
                                  bad_lane=bad, unknown_pool_lane=unk))
        return out

    def genesis_state(self) -> PraosState:
        """The shared tip's fold state: its slot, the epoch nonce and the
        seeded evolving and candidate nonces; no OCert seen yet."""
        eta_v = _expand(b"evolving", self.cfg.seed.to_bytes(8, "big"), 32)
        return PraosState(last_slot=self.tip_slot, epoch_nonce=self.eta0,
                          evolving_nonce=eta_v, candidate_nonce=eta_v)

    # -- the election -------------------------------------------------------

    def _formats(self, pool_i: int) -> frozenset:
        return frozenset(s.proof_len for s in self.tenants if s.pool_idx == pool_i) or \
            frozenset({PROOF_LEN_BC})

    def _elect(self, upto: int) -> None:
        """Elect every pool over [_elected_to, upto): the won slots of
        each pool alone, with their β and proofs."""
        lo, hi = self._elected_to, min(upto, self.slot_end)
        if hi <= lo:
            return
        t0 = time.perf_counter()
        slots = range(lo, hi)
        for i, pool in enumerate(self.pools):
            if self.engine == "device":
                thr = pforge.pool_thresholds(self.params, self.lview, [pool])
                table = pforge.device_table(pforge.stage_pools([pool]), thr, self.device)
                won = [(el.slot, el.beta, el.proofs) for el in pforge.elect_window(
                    self.params, [pool], thr, slots, self.eta0, "device", table,
                    self._formats(i))]
            else:
                won = self._elect_loop(pool, slots)
            self._wins.setdefault(i, []).extend(won)
            self._win_slots.setdefault(i, []).extend(w[0] for w in won)
        self._elected_to = hi
        if self.engine == "device":
            self._sign_ocerts(lo, hi)
        self.elect_s += time.perf_counter() - t0

    def _elect_loop(self, pool, slots) -> list:
        """db_synthesizer's per-slot loop for one pool: a native prove a
        slot and the leader check."""
        f = self.params.active_slot_coeff
        stake = self.lview.pool_distr[pool.pool_id].stake
        won = []
        for s in slots:
            alpha = nonces.mk_input_vrf(s, self.eta0)
            proof = native.ecvrf_prove_bc(pool.vrf_seed, alpha)
            beta = native.proof_to_hash(proof)
            if is_leader(nonces.vrf_leader_value(beta), stake, f):
                won.append((s, beta, {PROOF_LEN_BC: proof}))
        return won

    def _sign_ocerts(self, lo: int, hi: int) -> None:
        """The OCert issues the slots [lo, hi) may need, in one `ed_sign`
        launch: counter 0 and the jump's 2, every pool and the foreign
        one, each evolution window of the span."""
        p = self.params
        windows = {self._asm.ocert_window(s)
                   for s in range(lo, hi, p.slots_per_kes_period)} | {
            self._asm.ocert_window(hi - 1)}
        triples = {(i, c, w) for i in range(len(self.pools) + 1) for c in (0, 2)
                   for w in windows}
        self._asm.ocerts.update(pforge.sign_ocerts_batch(
            self._asm.pools, triples - self._asm.ocerts.keys(), self.device))

    def _next_win(self, pool_i: int, from_slot: int) -> tuple:
        """The pool's first won slot at or after `from_slot` -> (slot, β,
        proofs), electing further slots as needed."""
        while True:
            ws = self._win_slots.get(pool_i, [])
            k = bisect.bisect_left(ws, from_slot)
            if k < len(ws):
                return self._wins[pool_i][k]
            if self._elected_to >= self.slot_end:
                raise ValueError(
                    f"traffic overruns the tip's epoch or KES window at slot "
                    f"{self.slot_end}: fewer rounds, shorter suffixes or more stake")
            p_win = 1 - (1 - float(self.params.active_slot_coeff)) ** (1 / len(self.pools))
            need = self.cfg.rounds * self.cfg.suffix_len + 8
            self._elect(max(self._elected_to, from_slot)
                        + int(need * (self.cfg.slot_stride + 1 / p_win) * 1.5) + 64)

    # -- forging ------------------------------------------------------------

    def _cursor(self, spec: TenantSpec) -> _TenantForgeState:
        st = self._forge.get(spec.tenant_id)
        if st is None:
            # storm members (and so the equivocator pairs) start on one
            # slot grid, so their headers collide slot for slot; plain
            # followers are offset a tenant, so that shared windows carry
            # interleaved slot ranges
            base = self.cfg.base_slot
            if spec.storm_group is None:
                base += int(spec.tenant_id[-3:]) % 7
            st = _TenantForgeState(next_slot=base, block_no=self.cfg.base_slot // 2 + 1,
                                   prev_hash=self.tip_hash)
            self._forge[spec.tenant_id] = st
        return st

    def _proof(self, pool_i: int, slot: int, proofs: dict, plen: int) -> bytes:
        if plen not in proofs:
            pool = self._asm.pools[pool_i]
            proofs[plen] = _PROVERS[plen](pool.vrf_seed, nonces.mk_input_vrf(slot, self.eta0))
        return proofs[plen]

    def next_suffix(self, spec: TenantSpec) -> Suffix:
        """The tenant's next candidate suffix, extending its own fork.
        Failure lanes sit at the spec's in-suffix index, the counter jump
        on even rounds and the foreign pool on odd ones: the valid prefix
        before them still advances the tenant's chain, as for a peer
        whose candidate is cut at its first invalid header."""
        cfg = self.cfg
        st = self._cursor(spec)
        key = (spec.tenant_id, st.suffixes)
        if key in self._forged:
            sfx, after = self._forged[key]
            self._forge[spec.tenant_id] = _TenantForgeState(**after.__dict__)
            return sfx
        hvs = []
        for j in range(cfg.suffix_len):
            slot, beta, proofs = self._next_win(spec.pool_idx, st.next_slot)
            t0 = time.perf_counter()
            st.next_slot = slot + max(1, cfg.slot_stride)
            pool_i, counter = spec.pool_idx, 0
            if j == spec.bad_lane and st.suffixes % 2 == 0:
                counter = 2  # m <= n <= m + 1 broken at this lane
            elif j == spec.unknown_pool_lane and st.suffixes % 2 == 1:
                pool_i = len(self.pools)  # the foreign pool
                proofs = {}
                beta = native.proof_to_hash(self._proof(pool_i, slot, proofs, PROOF_LEN_BC))
            tx = _expand(b"tx", spec.tenant_id.encode() + slot.to_bytes(8, "big"),
                         cfg.body_len)
            block = self._asm.forge(pool_i, slot=slot, block_no=st.block_no,
                                    prev_hash=st.prev_hash, txs=(tx,), ocert_counter=counter,
                                    vrf_output=beta,
                                    vrf_proof=self._proof(pool_i, slot, proofs, spec.proof_len))
            hvs.append(block.header.to_view())
            st.prev_hash = block.header.hash_
            st.block_no += 1
            self.assemble_s += time.perf_counter() - t0
        st.suffixes += 1
        sfx = Suffix(spec.tenant_id, st.suffixes - 1, tuple(hvs))
        self._forged[key] = (sfx, _TenantForgeState(**st.__dict__))
        return sfx

    def suffixes(self):
        """The seeded arrival order: `rounds` passes, round-robin across
        tenants."""
        for _ in range(self.cfg.rounds):
            for spec in self.tenants:
                yield self.next_suffix(spec)

    def reset(self) -> None:
        """Forget the forge cursors: the next `suffixes()` pass gives the
        same stream again (its suffixes are kept, not forged anew)."""
        self._forge.clear()


def make_traffic(params: PraosParams | None = None, device=None, **kw) -> Traffic:
    """Traffic(TrafficConfig(**kw), params, device)."""
    return Traffic(TrafficConfig(**kw), params=params, device=device)
