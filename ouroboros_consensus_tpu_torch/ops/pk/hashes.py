"""SHA-512 and Blake2b over lanes, plain PyTorch.

Byte strings are [n, B] tensors (values 0..255), lanes last. A 64-bit
word is a (hi, lo) pair of int64 tensors each holding a value in
[0, 2^32): torch has no unsigned 64-bit type, int64 overflow is not
defined to wrap, and its right shift is arithmetic — so every 64-bit
operation is spelled out on 32-bit halves, as the JAX package does with
[..., 2] uint32 words. The CUDA kernels compute the same functions on
native uint64_t.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
BLOCK = 128

# SHA-512 initial state and round constants (FIPS 180-4), derived rather
# than transcribed: first 64 bits of the fractional parts of the square
# (H0) and cube (K) roots of the first primes.


def _primes(n):
    out, k = [], 2
    while len(out) < n:
        if all(k % p for p in out):
            out.append(k)
        k += 1
    return out


def _iroot_frac64(p: int, r: int) -> int:
    """floor(frac(p^(1/r)) * 2^64) by integer root of p * 2^(64 r)."""
    x = p << (64 * r)
    lo, hi = 0, 1 << (64 + 8)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid**r <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo & ((1 << 64) - 1)


SHA512_H0 = [_iroot_frac64(p, 2) for p in _primes(8)]
SHA512_K = [_iroot_frac64(p, 3) for p in _primes(80)]
B2B_IV = SHA512_H0  # Blake2b reuses SHA-512's IV
B2B_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _split(v: int):
    return (v >> 32, v & M32)


def _add(*xs):
    lo = xs[0][1]
    hi = xs[0][0]
    for x in xs[1:]:
        lo = lo + x[1]
        hi = hi + x[0]
    return ((hi + (lo >> 32)) & M32, lo & M32)


def _xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _and(a, b):
    return (a[0] & b[0], a[1] & b[1])


def _not(a):
    return (a[0] ^ M32, a[1] ^ M32)


def _rotr(x, n: int):
    hi, lo = x
    if n >= 32:
        hi, lo = lo, hi
        n -= 32
    if n == 0:
        return (hi, lo)
    return (((hi >> n) | (lo << (32 - n))) & M32,
            ((lo >> n) | (hi << (32 - n))) & M32)


def _shr(x, n: int):
    hi, lo = x
    return (hi >> n, ((lo >> n) | (hi << (32 - n))) & M32)


def _const(v: int, like: torch.Tensor):
    hi, lo = _split(v)
    return (torch.full_like(like, hi), torch.full_like(like, lo))


def sha512_compress(state, block: torch.Tensor):
    """One compression. state: 8 (hi, lo) words; block [128, B]."""
    b = block.to(torch.int64)
    w = []
    for t in range(16):
        o = 8 * t
        hi = (b[o] << 24) | (b[o + 1] << 16) | (b[o + 2] << 8) | b[o + 3]
        lo = (b[o + 4] << 24) | (b[o + 5] << 16) | (b[o + 6] << 8) | b[o + 7]
        w.append((hi, lo))
    for t in range(16, 80):
        s0 = _xor(_xor(_rotr(w[t - 15], 1), _rotr(w[t - 15], 8)), _shr(w[t - 15], 7))
        s1 = _xor(_xor(_rotr(w[t - 2], 19), _rotr(w[t - 2], 61)), _shr(w[t - 2], 6))
        w.append(_add(s1, w[t - 7], s0, w[t - 16]))
    a, b_, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _xor(_xor(_rotr(e, 14), _rotr(e, 18)), _rotr(e, 41))
        ch = _xor(_and(e, f), _and(_not(e), g))
        kt = _split(SHA512_K[t])
        t1 = _add(h, s1, ch, kt, w[t])
        s0 = _xor(_xor(_rotr(a, 28), _rotr(a, 34)), _rotr(a, 39))
        maj = _xor(_xor(_and(a, b_), _and(a, c)), _and(b_, c))
        t2 = _add(s0, maj)
        h, g, f, e, d, c, b_, a = g, f, e, _add(d, t1), c, b_, a, _add(t1, t2)
    return [_add(s, x) for s, x in zip(state, (a, b_, c, d, e, f, g, h))]


def _digest_be(state) -> torch.Tensor:
    rows = []
    for hi, lo in state:
        for v in (hi, lo):
            for sh in (24, 16, 8, 0):
                rows.append((v >> sh) & 0xFF)
    return torch.stack(rows)


def sha512_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """SHA-512 over pre-padded blocks [NB, 128, B] with per-lane block
    counts nblocks [B]: block 0 always applies, block i > 0 only where
    i < nblocks. -> digest [64, B]."""
    zero = torch.zeros(blocks.shape[-1], dtype=torch.int64, device=blocks.device)
    state = [_const(v, zero) for v in SHA512_H0]
    for i in range(blocks.shape[0]):
        nxt = sha512_compress(state, blocks[i])
        if i == 0:
            state = nxt
        else:
            act = i < nblocks
            state = [(torch.where(act, nh, sh), torch.where(act, nl, sl))
                     for (nh, nl), (sh, sl) in zip(nxt, state)]
    return _digest_be(state)


def pad_sha512(data: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Standard padding of [n, B] messages of one common length n ->
    ([NB, 128, B] blocks, NB)."""
    n, b = data.shape
    nb = (n + 17 + BLOCK - 1) // BLOCK
    tail = [0] * (nb * BLOCK - n)
    tail[0] = 0x80
    tail[-16:] = list((8 * n).to_bytes(16, "big"))
    pad = torch.tensor(tail, dtype=torch.int64, device=data.device)
    full = torch.cat([data.to(torch.int64), pad.unsqueeze(1).expand(-1, b)])
    return full.reshape(nb, BLOCK, b), nb


def sha512_fixed(data: torch.Tensor) -> torch.Tensor:
    """SHA-512 of [n, B] messages of one common length -> [64, B]."""
    blocks, nb = pad_sha512(data)
    cnt = torch.full((data.shape[-1],), nb, dtype=torch.int64, device=data.device)
    return sha512_blocks(blocks, cnt)


def blake2b_fixed(data: torch.Tensor, digest_size: int = 32) -> torch.Tensor:
    """Unkeyed single-block Blake2b of [n, B] messages (0 < n <= 128)
    -> [digest_size, B]."""
    n, b = data.shape
    assert 0 < n <= BLOCK
    d = torch.cat([
        data.to(torch.int64),
        torch.zeros(BLOCK - n, b, dtype=torch.int64, device=data.device),
    ])
    m = []
    for t in range(16):
        o = 8 * t
        lo = d[o] | (d[o + 1] << 8) | (d[o + 2] << 16) | (d[o + 3] << 24)
        hi = d[o + 4] | (d[o + 5] << 8) | (d[o + 6] << 16) | (d[o + 7] << 24)
        m.append((hi, lo))
    zero = torch.zeros(b, dtype=torch.int64, device=data.device)
    h = [_const(v, zero) for v in B2B_IV]
    h[0] = _const(B2B_IV[0] ^ (0x01010000 ^ digest_size), zero)
    v = list(h) + [_const(x, zero) for x in B2B_IV]
    v[12] = _xor(v[12], _const(n, zero))
    v[14] = _not(v[14])  # final block

    def g(a, b_, c, dd, x, y):
        v[a] = _add(v[a], v[b_], x)
        v[dd] = _rotr(_xor(v[dd], v[a]), 32)
        v[c] = _add(v[c], v[dd])
        v[b_] = _rotr(_xor(v[b_], v[c]), 24)
        v[a] = _add(v[a], v[b_], y)
        v[dd] = _rotr(_xor(v[dd], v[a]), 16)
        v[c] = _add(v[c], v[dd])
        v[b_] = _rotr(_xor(v[b_], v[c]), 63)

    for r in range(12):
        s = B2B_SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    out = [_xor(_xor(h[i], v[i]), v[i + 8]) for i in range(8)]
    rows = []
    for hi, lo in out:
        for x in (lo, hi):
            for sh in (0, 8, 16, 24):
                rows.append((x >> sh) & 0xFF)
    return torch.stack(rows[:digest_size])


def _selfcheck() -> None:
    """Constants derived above must equal the published values."""
    assert SHA512_H0[0] == 0x6A09E667F3BCC908
    assert SHA512_K[79] == 0x6C44198C4A475817


_selfcheck()
