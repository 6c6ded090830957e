"""Disk codecs for ledger and protocol state: the snapshot payloads.

The port's copy of the JAX package's storage/serialize.py, byte for byte
for the states the port has (after `Storage/Serialisation.hs` and the
EncodeDisk/DecodeDisk instances for `ExtLedgerState`,
Ledger/Extended.hs:178-199: a snapshot holds the ledger state and the
header state, which embeds the protocol's ChainDepState).

Two formats, as in the reference:

* the untagged 2-list ``[mock_state, header_state(praos)]``, pinned by
  ``tests/golden/ext_ledger_state.hex``;
* ``["v2", tagged_ledger, tagged_header]`` for every other pairing: the
  ledger tags ``mock`` and ``hf``, the chain-dep tags ``praos``,
  ``tpraos``, ``pbft`` and ``hf``.

The era ledgers' tags (``shelley``, ``byron``, ``dual_byron``, ``dual``)
come with those ledgers; until then their states have no codec here
(TypeError) and their tags do not decode (ValueError), as the reference
treats a type or a tag it does not know.
"""

from __future__ import annotations

import dataclasses

from ..hardfork.combinator import HFState
from ..ledger.extended import ExtLedgerState
from ..ledger.header_validation import AnnTip, HeaderState
from ..ledger.mock import MockState
from ..protocol.instances import PBftState
from ..protocol.praos import PraosState
from ..protocol.tpraos import TPraosState
from ..utils import cbor


def encode_praos_state(st: PraosState):
    return [
        st.last_slot,
        sorted((k, v) for k, v in st.ocert_counters.items()),
        st.evolving_nonce,
        st.candidate_nonce,
        st.epoch_nonce,
        st.lab_nonce,
        st.last_epoch_block_nonce,
    ]


def _nonce(x):
    return bytes(x) if x is not None else None


def decode_praos_state(o) -> PraosState:
    return PraosState(
        last_slot=o[0],
        ocert_counters={bytes(k): v for k, v in o[1]},
        evolving_nonce=_nonce(o[2]),
        candidate_nonce=_nonce(o[3]),
        epoch_nonce=_nonce(o[4]),
        lab_nonce=_nonce(o[5]),
        last_epoch_block_nonce=_nonce(o[6]),
    )


def _encode_tip(tip: AnnTip | None):
    return None if tip is None else [tip.slot, tip.block_no, tip.hash_]


def _decode_tip(o) -> AnnTip | None:
    return None if o is None else AnnTip(o[0], o[1], bytes(o[2]))


def encode_header_state(hs: HeaderState):
    return [_encode_tip(hs.tip), encode_praos_state(hs.chain_dep_state)]


def decode_header_state(o) -> HeaderState:
    return HeaderState(_decode_tip(o[0]), decode_praos_state(o[1]))


def encode_mock_state(st: MockState):
    utxo = sorted(
        ([txid, ix, addr, amt] for (txid, ix), (addr, amt) in st.utxo.items()),
        key=lambda e: (e[0], e[1]),
    )
    return [utxo, st.tip_slot_]


def decode_mock_state(o) -> MockState:
    utxo = {(bytes(e[0]), e[1]): (bytes(e[2]), e[3]) for e in o[0]}
    return MockState(utxo, o[1])


def _tag(o) -> str:
    return o[0].decode() if isinstance(o[0], bytes) else o[0]


def encode_ledger_state_tagged(st) -> list:
    """Type-dispatched ledger-state codec (v2 payloads)."""
    if isinstance(st, MockState):
        return ["mock", encode_mock_state(st)]
    if isinstance(st, HFState):
        return ["hf", st.era, encode_ledger_state_tagged(st.inner)]
    raise TypeError(f"no snapshot codec for ledger state {type(st).__name__}")


def decode_ledger_state_tagged(o):
    tag = _tag(o)
    if tag == "mock":
        return decode_mock_state(o[1])
    if tag == "hf":
        return HFState(int(o[1]), decode_ledger_state_tagged(o[2]))
    raise ValueError(f"unknown ledger-state tag {tag!r}")


def encode_chain_dep_tagged(st) -> list:
    if isinstance(st, TPraosState):  # a subclass of PraosState: first
        return ["tpraos", encode_praos_state(st)]
    if isinstance(st, PraosState):
        return ["praos", encode_praos_state(st)]
    if isinstance(st, PBftState):
        return ["pbft", [list(s) for s in st.signers]]
    if isinstance(st, HFState):
        return ["hf", st.era, encode_chain_dep_tagged(st.inner)]
    raise TypeError(f"no snapshot codec for chain-dep state {type(st).__name__}")


def decode_chain_dep_tagged(o):
    tag = _tag(o)
    if tag == "praos":
        return decode_praos_state(o[1])
    if tag == "tpraos":
        return TPraosState(**dataclasses.asdict(decode_praos_state(o[1])))
    if tag == "pbft":
        return PBftState(tuple((int(s), int(g)) for s, g in o[1]))
    if tag == "hf":
        return HFState(int(o[1]), decode_chain_dep_tagged(o[2]))
    raise ValueError(f"unknown chain-dep tag {tag!r}")


def encode_ext_state(st: ExtLedgerState) -> bytes:
    if isinstance(st.ledger_state, MockState) and type(
            st.header_state.chain_dep_state) is PraosState:
        # the original (golden-pinned) untagged format
        return cbor.encode([encode_mock_state(st.ledger_state),
                            encode_header_state(st.header_state)])
    hs = st.header_state
    return cbor.encode([
        "v2",
        encode_ledger_state_tagged(st.ledger_state),
        [_encode_tip(hs.tip), encode_chain_dep_tagged(hs.chain_dep_state)],
    ])


def decode_ext_state(data: bytes) -> ExtLedgerState:
    o = cbor.decode(data)
    if _tag(o) == "v2":
        return ExtLedgerState(
            decode_ledger_state_tagged(o[1]),
            HeaderState(_decode_tip(o[2][0]), decode_chain_dep_tagged(o[2][1])))
    return ExtLedgerState(decode_mock_state(o[0]), decode_header_state(o[1]))
