"""Praos chain-order: the SelectView and its comparison.

Reference: `PraosChainSelectView` (Praos/Common.hs:53-81) — candidates are
ordered by (1) chain length; (2) when the tips have the SAME issuer, the
higher OCert issue number; (3) the LOWER tie-break VRF value (the "L"
range extension of the certified output, pTieBreakVRFValue). ChainSel
(storage/chaindb) sorts candidate fragments by the select view of their
tip header.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import nonces


@dataclass(frozen=True)
class PraosSelectView:
    block_no: int
    slot: int
    issuer_vk: bytes
    issue_no: int  # ocert counter
    tiebreak_vrf: int  # vrfLeaderValue of the tip's certified output

    @classmethod
    def from_header(cls, header) -> "PraosSelectView":
        b = header.body
        return cls(
            block_no=b.block_no,
            slot=b.slot,
            issuer_vk=b.issuer_vk,
            issue_no=b.ocert.counter,
            tiebreak_vrf=nonces.vrf_leader_value(b.vrf_output),
        )


def compare_select_views(ours: PraosSelectView | None, theirs: PraosSelectView | None) -> int:
    """> 0 iff `theirs` is strictly preferred (preferCandidate).

    None = empty chain (genesis-only): any non-empty candidate wins.
    """
    if theirs is None:
        return -1 if ours is not None else 0
    if ours is None:
        return 1
    if theirs.block_no != ours.block_no:
        return 1 if theirs.block_no > ours.block_no else -1
    if theirs.issuer_vk == ours.issuer_vk and theirs.issue_no != ours.issue_no:
        return 1 if theirs.issue_no > ours.issue_no else -1
    if theirs.tiebreak_vrf != ours.tiebreak_vrf:
        return 1 if theirs.tiebreak_vrf < ours.tiebreak_vrf else -1
    return 0
