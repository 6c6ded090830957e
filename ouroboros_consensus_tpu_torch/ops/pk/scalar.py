"""Scalars mod L over lanes, plain PyTorch: the scalar half of the JAX
package's ops/pk/limbs.py, in the port's own radix.

A scalar is 32 little-endian bytes, [32, B] int64 rows with lanes last
(the byte rows the stage kernels already read and write). The CUDA
side's `sc_reduce512` (csrc/pk.cuh: ref10's sc_reduce over signed 21-bit
limbs in registers), which `sc_mul` and `sc_add` reuse, takes the same
64 bytes. Every function here normalises its input to 64 bytes with one
sequential carry and then reduces it with field.reduce512: both give the
value mod L, so the twin and the device code agree byte for byte (the
reference's
`reduce512` and `is_canonical_scalar` are field.reduce512 and
field.scalar_lt_l; its `windows8_from_limbs` is the byte rows
themselves):

* `mul_mod_l`: the 32 x 32 byte convolution (each column below
  32 * 255^2 < 2^21), carried to 64 bytes, reduced;
* `reduce_raw_sums`: byte rows summed over lanes without a carry (the
  aggregate's scatter-added coefficient tables: 8,192 lanes x 255 <
  2^21 a row, far inside int64), carried, reduced;
* `sum_mod_l`: the sum over a list of terms and over the lanes, each
  row summed in int64 (40 terms x 8,192 lanes x 255 < 2^27: no
  overflow at any size the replay reaches), carried, reduced.
"""

from __future__ import annotations

import torch

from . import field as fe

L = fe.L
_I64 = torch.int64


def bytes_to_limbs(b: torch.Tensor, n: int = 32) -> torch.Tensor:
    """[k, B] little-endian bytes -> [n, B] int64 byte rows (the port's
    scalar radix is the byte), zero-extended or cut to n rows."""
    b = b.to(_I64)
    if b.shape[0] >= n:
        return b[:n]
    pad = torch.zeros(n - b.shape[0], b.shape[-1], dtype=_I64, device=b.device)
    return torch.cat([b, pad])


def carry_bytes(rows: torch.Tensor, n: int = 64) -> torch.Tensor:
    """[k, B] non-negative int64 column sums -> [n, B] bytes of the same
    integer (one sequential carry; the value must fit n bytes)."""
    rows = rows.to(_I64)
    out = []
    c = torch.zeros_like(rows[0])
    for i in range(n):
        v = c + (rows[i] if i < rows.shape[0] else 0)
        out.append(v & 0xFF)
        c = v >> 8
    return torch.stack(out)


def mul_mod_l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[na, B] x [nb, B] byte scalars (na, nb <= 32) -> [32, B] bytes of
    a·b mod L."""
    a, b = a.to(_I64), b.to(_I64)
    cols = torch.zeros(a.shape[0] + b.shape[0], a.shape[-1], dtype=_I64, device=a.device)
    for j in range(b.shape[0]):
        cols[j: j + a.shape[0]] += a * b[j]
    return fe.reduce512(carry_bytes(cols))


def reduce_raw_sums(v: torch.Tensor) -> torch.Tensor:
    """[32, B] un-carried byte-row sums (each row >= 0, < 2^40) ->
    [32, B] bytes of the value mod L."""
    return fe.reduce512(carry_bytes(v))


def sum_mod_l(terms) -> torch.Tensor:
    """Sum a list of [32, B] byte scalars over the list and the lanes ->
    [32, 1] bytes mod L. The int64 row sums are exact: a row of T terms
    of bytes stays below 255·T. No path calls it (the aggregate sums its
    B coefficient's rows in the dedupe kernel and reduces them there); the
    tests hold it as the reference's function."""
    acc = None
    for t in terms:
        s = t.to(_I64).sum(dim=-1, keepdim=True)
        acc = s if acc is None else acc + s
    return reduce_raw_sums(acc)


def to_int(col: torch.Tensor) -> list[int]:
    """[n, B] little-endian byte rows -> the B integers (tests, tools)."""
    rows = col.to(_I64).cpu().T.tolist()
    return [int.from_bytes(bytes(int(v) for v in r), "little") for r in rows]


def from_ints(vals, n: int = 32, device="cpu") -> torch.Tensor:
    """B integers below 2^(8n) -> [n, B] int64 byte rows."""
    return torch.tensor([list(int(v).to_bytes(n, "little")) for v in vals],
                        dtype=_I64, device=device).T.contiguous()
