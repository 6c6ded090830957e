"""The window aggregate's key dedupe: the `dedupe` kernel's body
(csrc/agg.cuh, built as host C++ through csrc/host_emu.cpp, its blocks
one after another in a seeded shuffled order, in reverse or in the
grid's) byte for byte against its plain twin, the reference's slot sums
and B coefficient reduced mod L (ouroboros_consensus_tpu_torch/ops/pk/
aggregate.py: agg_tables_plain of dedupe_columns_plain and
window_tables_plain), and the JAX package's `_dedupe_column` (seeded
numpy inputs into all three): keys that share their first 8, 16 or 24
bytes, equal keys at lanes far apart, one key in every lane, the cap
exactly full and overflowing, at cap 256 and small caps, windows of one
tile and of several merge levels up to 70,000 lanes, warps of a few
keys that share long prefixes (the card's warp-at-a-time ranking), the
launch's one form at every width and the scratch it keeps."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from ouroboros_consensus_tpu.ops.pk import aggregate as jagg
from ouroboros_consensus_tpu.ops.pk import curve as jpc
from ouroboros_consensus_tpu_torch.ops.pk import aggregate as pa
from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import field as fe
from ouroboros_consensus_tpu_torch.ops.pk import scalar as sc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host():
    return build.build_host_emu()


def _keys(kind: str, b: int, distinct: int, rng: np.random.Generator) -> np.ndarray:
    """[32, b] key bytes of `distinct` keys spread over the lanes."""
    pool = rng.integers(0, 256, (distinct, 32))
    if kind.startswith("prefix"):
        pool[:, :int(kind[6:])] = pool[0, :int(kind[6:])]
        pool[1::3, 31] = pool[0::3, 31][:len(pool[1::3])]  # some differ in one byte only
        pool[2::3, :31] = pool[1::3, :31][:len(pool[2::3])]
    lanes = rng.integers(0, distinct, b)
    if kind == "far":
        lanes[0] = lanes[-1] = distinct - 1  # one key at the two ends, nowhere else
        lanes[1:-1] = rng.integers(0, distinct - 1, b - 2)
    return np.ascontiguousarray(pool[lanes].T, dtype=np.int32)


CASES = [  # (kind, lanes, distinct keys, cap)
    ("one", 64, 1, 256), ("random", 100, 7, 256), ("prefix8", 96, 9, 256),
    ("prefix16", 96, 9, 4), ("prefix24", 200, 30, 256), ("far", 77, 5, 256),
    ("random", 300, 256, 256), ("random", 600, 300, 256), ("random", 50, 20, 5),
    ("random", 33, 33, 2), ("prefix8", 8192, 300, 256),
]


def _column(kind, b, distinct, seed):
    rng = np.random.default_rng(seed)
    keys = _keys(kind, b, distinct, rng)
    coeff = rng.integers(0, 256, (b, 32)).astype(np.uint8)
    pts = rng.integers(-2**31, 2**31, (b, 40)).astype(np.int32)
    return keys, coeff, pts


def _brows(b, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (3, b, 32)).astype(np.uint8))


def _host(host, keys, coeffs, pts, cap, brows, order=None):
    """The kernel's one entry through the host build: four key columns and
    the window's B rows (`order`: the blocks' order, pk_dedupe_order's;
    None: pk_dedupe's own, a seeded shuffle) -> (red, slot points, ok)."""
    fn = host.pk_dedupe if order is None else functools.partial(host.pk_dedupe_order, order)
    red, tpts, ok, rc = pa._dedupe_launch(fn, None, list(keys), coeffs.data_ptr(),
                                          pts.data_ptr(), brows.data_ptr(), cap)
    assert rc == 0
    return red, tpts, ok


def _twin(keys, coeffs, pts, cap, brows):
    """The reference's outputs: the slot sums and the B row's lane sums
    (the twin's un-carried rows) reduced mod L, the slot points, ok_cap."""
    raw, tpts, ok = pa.dedupe_columns_plain(keys, coeffs, pts, cap)
    raw = torch.cat([raw, brows.to(torch.int64).sum((0, 1))[None]])
    return pa.agg_tables_plain(raw), tpts, ok


def _stacked(cols, seed):
    keys = torch.from_numpy(np.stack([c[0] for c in cols]))
    coeffs = torch.from_numpy(np.stack([c[1] for c in cols]))
    pts = torch.from_numpy(np.stack([c[2] for c in cols]))
    return keys, coeffs, pts, _brows(keys.shape[-1], seed)


def _check_columns(host, cols, cap, seed, order=None):
    keys, coeffs, pts, brows = _stacked(cols, seed)
    got = _host(host, keys, coeffs, pts, cap, brows, order)
    want = _twin(keys, coeffs, pts, cap, brows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    groups = [len({bytes(r) for r in c[0].T.astype(np.uint8)}) for c in cols]
    assert got[2].tolist() == [n <= cap for n in groups]
    return got


@pytest.mark.parametrize("kind,b,distinct,cap", CASES)
def test_host_dedupe_matches_twin(host, kind, b, distinct, cap):
    _check_columns(host, [_column(kind, b, distinct, 40 + c) for c in range(4)], cap, 45)


@pytest.mark.parametrize("b,distinct", [(8193, 300), (20000, 3000), (70000, 70000)])
def test_host_dedupe_wide_windows(host, b, distinct):
    """Windows past 8,192 lanes (the same path: more tiles, one merge
    level more) and past 65,536 lanes (positions wider than 16 bits): keys
    tying on their first 8 bytes, more groups than the cap (the last
    slot's start summed over many groups, its lane found by rank), and one
    key in every lane."""
    kinds = ("prefix8", "random", "prefix16", "one")
    cols = [_column(kind, b, 1 if kind == "one" else distinct, 80 + c)
            for c, kind in enumerate(kinds)]
    _check_columns(host, cols, pa._DEDUPE_CAP, 85)


ORDER_CASES = [("prefix8", 8192, 300, 256), ("random", 3000, 256, 256),
               ("far", 2000, 5, 3), ("random", 600, 600, 2)]


@pytest.mark.parametrize("order", [0, -1, 5, 11])
@pytest.mark.parametrize("kind,b,distinct,cap", ORDER_CASES)
def test_host_dedupe_any_block_order(host, kind, b, distinct, cap, order):
    """The outputs do not depend on the order the blocks run in (the grid's,
    reversed, two seeded shuffles): which tile finishes a merge node last,
    and which column finishes the B row, changes; the bytes do not."""
    cols = [_column(kind, b, distinct, 50 + c) for c in range(4)]
    _check_columns(host, cols, cap, 55, order)


WARP_CASES = [  # (kind, lanes, distinct keys): at most 8 keys a warp, then 9
    ("prefix8", 512, 3), ("prefix16", 700, 8), ("prefix24", 1000, 9), ("prefix31", 300, 6),
    ("far", 2000, 2),
]


@pytest.mark.parametrize("kind,b,distinct", WARP_CASES)
def test_host_dedupe_few_keys_a_warp(host, kind, b, distinct):
    """Warps of a few keys each, the card's warp-at-a-time ranking (a
    warp's distinct keys in turn, each against the tile; more than 8 keys:
    a lane's own comparisons), with keys that share their first 8, 16, 24
    or 31 bytes, differ in one byte only, or sit at the two ends of the
    column alone."""
    cols = [_column(kind, b, distinct, 90 + c) for c in range(4)]
    _check_columns(host, cols, pa._DEDUPE_CAP, 95, 3)


@pytest.mark.parametrize("b", [8192, 8193, 70000])
def test_launch_has_one_form(host, b):
    """One path for every width: the grid is a block a tile of each column,
    the scratch and the tickets grow with the tiles by one formula (the
    wrapper's, the kernel's own), and nothing else changes with the width;
    each launch leaves its tickets zero for the next."""
    blocks, scratch, tickets = pa._dedupe_shape(b)
    tiles = -(-b // pa.DEDUPE_TILE)
    assert blocks == 4 * tiles
    assert scratch == tiles * (pa.DEDUPE_TILE * 1104 + 512)
    assert tickets == 32 * tiles + 1
    got = np.zeros(3, dtype=np.int64)
    assert host.pk_dedupe_shape(b, got.ctypes.data) == 0
    assert got.tolist() == [blocks, scratch, tickets]
    seen = []

    def fn(*args):
        seen.append(args)
        return host.pk_dedupe(*args)

    cols = [_column("random", b, 5, c) for c in range(4)]
    keys, coeffs, pts, brows = _stacked(cols, 1)
    pa._WORKSPACE.clear()
    red, _tpts, _ok, rc = pa._dedupe_launch(fn, None, list(keys), coeffs.data_ptr(),
                                            pts.data_ptr(), brows.data_ptr(), 256)
    assert rc == 0 and len(seen) == 1
    assert seen[0][:2] == (b, 256) and seen[0][10] == scratch
    assert red.shape == (4 * 256 + 1, 32)
    ((buf, t),) = pa._WORKSPACE.values()
    assert t.numel() == tickets and not t.any()
    assert (buf is None) == (scratch > pa._SCRATCH_KEEP)
    assert buf is None or buf.numel() == scratch


def test_wide_scratch_is_its_calls_own():
    """The scratch kept between calls stays at most _SCRATCH_KEEP bytes: a
    window wider than that gets one of its own for its call, and the
    narrower window's kept scratch is used again after it."""
    seen = []

    def fn(*args):
        seen.append(args[10])
        return 0

    widths = (8192, 70000, 8192, 4000)
    pa._WORKSPACE.clear()
    for b in widths:
        keys = [torch.zeros((32, b), dtype=torch.int32)] * 4
        assert pa._dedupe_launch(fn, None, keys, 0, 0, 0, 256)[3] == 0
        ((buf, _t),) = pa._WORKSPACE.values()
        assert buf.numel() == pa._dedupe_shape(8192)[1] <= pa._SCRATCH_KEEP
    assert seen == [pa._dedupe_shape(b)[1] for b in widths]
    assert pa._dedupe_shape(70000)[1] > pa._SCRATCH_KEEP
    assert _t.numel() == pa._dedupe_shape(70000)[2]  # the tickets grow and stay


def _limbs13(vals) -> np.ndarray:
    return np.array([[(v >> (13 * i)) & 8191 for v in vals] for i in range(20)], np.int32)


def _int13(col) -> list[int]:
    a = np.asarray(col)
    return [sum(int(a[i, j]) << (13 * i) for i in range(a.shape[0])) for j in range(a.shape[1])]


@pytest.mark.parametrize("kind,b,distinct,cap", [("prefix24", 40, 9, 256), ("far", 40, 6, 3),
                                                 ("random", 40, 12, 8)])
def test_host_dedupe_matches_jax(host, kind, b, distinct, cap):
    """The body against the JAX package's `_dedupe_column` (mod-L
    coefficients, field points) as values: the slots mod L (the kernel's
    own reduction), each slot's point, ok_cap."""
    rng = np.random.default_rng(60)
    keys = _keys(kind, b, distinct, rng)
    coeff = [int.from_bytes(rng.bytes(32), "little") % sc.L for _ in range(b)]
    xs = [[int.from_bytes(rng.bytes(32), "little") % fe.P for _ in range(b)] for _ in range(4)]
    jt, jp, jok = jax.jit(jagg._dedupe_column, static_argnums=3)(
        jnp.asarray(keys), jnp.asarray(_limbs13(coeff)),
        jpc.Point(*(jnp.asarray(_limbs13(c)) for c in xs)), cap)
    pts = torch.tensor([[limb for c in xs for limb in fe.int_to_limbs(c[j])] for j in range(b)],
                       dtype=torch.int32)
    cbytes = torch.tensor([list(c.to_bytes(32, "little")) for c in coeff], dtype=torch.uint8)
    four = torch.from_numpy(keys)[None].expand(4, 32, b)  # the column in all four places
    red, tp, ok = _host(host, four, cbytes[None].expand(4, b, 32).contiguous(),
                        pts[None].expand(4, b, 40).contiguous(), cap, _brows(b, 62))
    assert bool(ok[0]) == bool(jok)
    red, tp = red[:cap], tp[:cap]
    assert sc.to_int(red.T) == _int13(jt)
    got = tp.to(torch.int64)
    for k, c in enumerate(jp):
        have = [sum(int(got[j, 10 * k + i]) << fe.OFF[i] for i in range(10)) for j in range(cap)]
        assert have == _int13(c)


@pytest.mark.parametrize("b,distinct", [(96, 3), (900, 400)])
def test_host_window_tables_match_twin(host, b, distinct, monkeypatch):
    """The window's launch: the four columns at their places among the
    22 inputs and the B row, against window_tables on the CPU (the
    reference's rows reduced mod L: agg_tables_plain of
    window_tables_plain)."""
    rng = np.random.default_rng(61)
    cols = [torch.zeros((32, b), dtype=torch.int32) for _ in range(22)]
    for k in pa.DEDUPE_KEYS:
        cols[k] = torch.from_numpy(_keys("prefix8", b, distinct, rng))
    pts = torch.from_numpy(rng.integers(-2**31, 2**31, (pa.N_PTS, b, 40)).astype(np.int32))
    scal = torch.from_numpy(rng.integers(0, 256, (pa.N_SC, b, 32)).astype(np.uint8))
    got = _host(host, [cols[k] for k in pa.DEDUPE_KEYS], scal[pa.SC_Z1:pa.SC_Z3C + 1],
                pts[pa.PT_RE:pa.PT_Y + 1], pa._DEDUPE_CAP, scal[pa.SC_B1:pa.SC_B3 + 1])
    want = pa.window_tables(cols, pts, scal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    groups = [len({bytes(r) for r in cols[k].T.to(torch.uint8).numpy()}) for k in pa.DEDUPE_KEYS]
    assert got[2].tolist() == [n <= pa._DEDUPE_CAP for n in groups]
    assert max(groups) > pa._DEDUPE_CAP or distinct < pa._DEDUPE_CAP


def test_twin_columns_are_each_column_alone():
    """Several columns in one call group each column by its own 32 bytes
    only: equal to the columns one at a time (the reference dedupes each
    column alone)."""
    cols = [_column("prefix16", 120, 11, 70 + c) for c in range(4)]
    keys = torch.from_numpy(np.stack([c[0] for c in cols]))
    coeffs = torch.from_numpy(np.stack([c[1] for c in cols]))
    pts = torch.from_numpy(np.stack([c[2] for c in cols]))
    raw, tpts, ok = pa.dedupe_columns_plain(keys, coeffs, pts, 8)
    for c in range(4):
        one = pa.dedupe_column(keys[c], coeffs[c], pts[c], 8)
        assert torch.equal(raw[8 * c: 8 * c + 8], one[0])
        assert torch.equal(tpts[8 * c: 8 * c + 8], one[1])
        assert bool(ok[c]) == bool(one[2])
