"""Praos leader-threshold check (exact interval arithmetic).

The rule (cardano-ledger `checkLeaderNatValue`, Praos.hs:551): a pool with
relative stake sigma leads the slot iff p < 1 - (1 - f)^sigma with
p = leaderValue / 2^256, evaluated as 1/(1-p) < exp(-sigma * ln(1-f)).
ln(1-f) and exp are bracketed by partial sums with rigorous remainder
bounds, tightened until the comparison is decided.

`threshold_bracket` gives integers [T_lo, T_hi] around
2^256 * (1 - (1-f)^sigma): the device compares against both, and only a
value between them (the ambiguous band, empty in practice) takes the
exact `check_leader_value`.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

LEADER_VALUE_MAX = 1 << 256


@lru_cache(maxsize=64)
def _neg_log1m_interval(f: Fraction, terms: int) -> tuple[Fraction, Fraction]:
    """[lo, hi] bracketing -ln(1 - f) for 0 < f < 1 (Mercator series,
    remainder < f^(N+1)/((N+1)(1-f)))."""
    acc = Fraction(0)
    fp = Fraction(1)
    for n in range(1, terms + 1):
        fp *= f
        acc += fp / n
    rem = fp * f / ((terms + 1) * (1 - f))
    return acc, acc + rem


def _exp_interval(lo: Fraction, hi: Fraction, terms: int) -> tuple[Fraction, Fraction]:
    """[exp_lo, exp_hi] for x in [lo, hi], 0 <= x < 1."""
    def partial(x: Fraction) -> tuple[Fraction, Fraction]:
        acc = Fraction(1)
        term = Fraction(1)
        for n in range(1, terms + 1):
            term = term * x / n
            acc += term
        rem = term * x / (terms + 1) / (1 - x)
        return acc, rem

    lo_sum, _ = partial(lo)
    hi_sum, hi_rem = partial(hi)
    return lo_sum, hi_sum + hi_rem


def check_leader_value(leader_value: int, sigma: Fraction, active_slot_coeff: Fraction) -> bool:
    """True iff `leader_value` wins the slot for relative stake `sigma`."""
    f = Fraction(active_slot_coeff)
    sigma = Fraction(sigma)
    if f == 1:
        return True
    if sigma == 0:
        return False
    lhs = Fraction(LEADER_VALUE_MAX, LEADER_VALUE_MAX - leader_value)
    for terms in (8, 16, 32, 64, 128):
        llo, lhi = _neg_log1m_interval(f, terms)
        xlo, xhi = sigma * llo, sigma * lhi
        elo, ehi = _exp_interval(xlo, xhi, terms)
        if lhs < elo:
            return True
        if lhs >= ehi:
            return False
    # still undecided after 128 terms: deterministic midpoint tie-break
    return lhs < (elo + ehi) / 2


@lru_cache(maxsize=4096)
def threshold_bracket(sigma: Fraction, f: Fraction) -> tuple[int, int]:
    """[T_lo, T_hi] integers bracketing 2^256 * (1 - (1-f)^sigma):
    lv < T_lo => certainly a leader; lv >= T_hi => certainly not."""
    if f == 1:
        return (LEADER_VALUE_MAX, LEADER_VALUE_MAX)
    if sigma == 0:
        return (0, 0)
    llo, lhi = _neg_log1m_interval(f, 64)
    elo, ehi = _exp_interval(sigma * llo, sigma * lhi, 64)
    t_lo = LEADER_VALUE_MAX * (1 - Fraction(1) / elo)
    t_hi = LEADER_VALUE_MAX * (1 - Fraction(1) / ehi)
    return (int(t_lo), -int(-t_hi))


def is_leader(leader_value: int, sigma: Fraction, f: Fraction) -> bool:
    """check_leader_value through the bracket first: identical answers,
    the exact series only inside the (empty in practice) ambiguous band."""
    lo, hi = threshold_bracket(Fraction(sigma), Fraction(f))
    if leader_value < lo:
        return True
    if leader_value >= hi:
        return False
    return check_leader_value(leader_value, sigma, f)
