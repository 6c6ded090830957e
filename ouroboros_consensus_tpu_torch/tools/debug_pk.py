"""Per-primitive bisection harness of the device library.

    python -m ouroboros_consensus_tpu_torch.tools.debug_pk [sha blake base ladder decomp scalar]
    python -m ouroboros_consensus_tpu_torch.tools.debug_pk --device cpu sha

Each primitive the stage kernels are built from (csrc/pk.cuh) runs as its
own small kernel (csrc/primitives.cu, bodies in csrc/tools.cuh, one lane
per thread) over 256 seeded lanes, and is held to references written
here without the port's arithmetic: `hashlib`, and Python-int Edwards
arithmetic. On the card each body is also held bit for bit to its plain
PyTorch twin on the same inputs; on the CPU the twins alone run. One
`OK` / `MISMATCH` line per body; the exit code is 1 on any mismatch.

Replaces the TPU harness scripts/debug_pk_tpu.py:run_kernel (one tiny
pallas_call per suspect piece), with its lanes, its seed and its CLI.
A body here is a launch of at most 2 blocks: its time is launch latency
and one SM's work, not a rate.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..ops.pk import curve as pc
from ..ops.pk import field as fe
from ..ops.pk import hashes as ph
from ..ops.pk import kernels as K

LANES = 256
SEED = 5
PRIMITIVES = ("sha", "blake", "base", "ladder", "decomp", "scalar")

# --- Python-int references ---------------------------------------------------

P, D, L = fe.P, fe.D, fe.L


def _even_point(y: int) -> tuple:
    """The point with this y and an even x, extended (x, y, 1, xy)."""
    xx = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    x = pow(xx, (P + 3) // 8, P)
    if (x * x - xx) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
    x = P - x if x & 1 else x
    return (x, y, 1, x * y % P)


BASE = _even_point(4 * pow(5, P - 2, P) % P)


def _add(p, q):
    """Unified addition in extended coordinates (a = -1, RFC 8032)."""
    (x1, y1, z1, t1), (x2, y2, z2, t2) = p, q
    a, b = (y1 - x1) * (y2 - x2) % P, (y1 + x1) * (y2 + x2) % P
    c, d = 2 * t1 * t2 * D % P, 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(k: int, p):
    q = (0, 1, 1, 0)
    while k:
        if k & 1:
            q = _add(q, p)
        p, k = _add(p, p), k >> 1
    return q


def _affine(p) -> tuple:
    zi = pow(p[2], P - 2, P)
    return p[0] * zi % P, p[1] * zi % P


def _compress(p) -> bytes:
    x, y = _affine(p)
    return (y | (x & 1) << 255).to_bytes(32, "little")


def _fe_int(limbs) -> int:
    return sum(int(v) << fe.OFF[i] for i, v in enumerate(limbs)) % P


def _point_affine(col) -> tuple:
    """[40] limb column -> affine (x, y) of the projective point."""
    x, y, z = (_fe_int(col[10 * k: 10 * (k + 1)]) for k in range(3))
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def _limbs(vals) -> list:
    return [v for x in vals for v in fe.int_to_limbs(x)]


def _bytes_cols(msgs) -> torch.Tensor:
    """Equal-length byte strings -> [n, B] int32."""
    return torch.tensor(np.stack([np.frombuffer(m, np.uint8) for m in msgs], 1),
                        dtype=torch.int32)


def _lane_bytes(col: torch.Tensor, i: int) -> bytes:
    return bytes(col[:, i].to(torch.uint8).tolist())


# --- the bodies ----------------------------------------------------------------


class Body(NamedTuple):
    name: str  # the kernel in csrc/primitives.cu
    entry: str  # its C launcher
    args: tuple  # int32 tensors [rows, B] (CPU) and ints, in launch order
    base8: bool  # the launcher takes the fixed-base table first
    out_rows: tuple  # rows of each int32 output [rows, B]
    twin: Callable  # *args -> tuple of int32 outputs (plain PyTorch)
    check: Callable  # outputs (CPU) -> bool, against the references


def _i64(t):
    return t.to(torch.int64)


def _i32(*ts):
    return tuple(t.to(torch.int32) for t in ts)


def bodies(names=PRIMITIVES, lanes: int = LANES, seed: int = SEED) -> list[Body]:
    """The bodies of the chosen primitives, inputs drawn from one seeded
    generator in the TPU harness's order."""
    rng = np.random.default_rng(seed)
    out = []
    b = lanes
    if "sha" in names:
        data = torch.tensor(rng.integers(0, 256, (66, b)), dtype=torch.int32)
        out.append(Body(
            "k_sha", "pk_prim_sha", (data,), False, (64,),
            lambda d: _i32(ph.sha512_fixed(_i64(d))),
            lambda o, d=data: all(_lane_bytes(o[0], i) == hashlib.sha512(_lane_bytes(d, i)).digest()
                                  for i in range(b))))
        msgs = [rng.bytes(int(rng.integers(1, 200))) for _ in range(b)]
        blocks = np.zeros((2, 128, b), np.int32)
        nblocks = np.zeros((1, b), np.int32)
        for i, m in enumerate(msgs):
            k = (len(m) + 17 + 127) // 128
            padded = bytearray(k * 128)
            padded[: len(m)] = m
            padded[len(m)] = 0x80
            padded[-16:] = (8 * len(m)).to_bytes(16, "big")
            blocks[:k, :, i] = np.frombuffer(bytes(padded), np.uint8).reshape(k, 128)
            nblocks[0, i] = k
        out.append(Body(
            "k_shav", "pk_prim_shav", (torch.from_numpy(blocks), 2, torch.from_numpy(nblocks)),
            False, (64,),
            lambda blk, _nb, n: _i32(ph.sha512_blocks(_i64(blk), _i64(n[0]))),
            lambda o, msgs=msgs: all(_lane_bytes(o[0], i) == hashlib.sha512(m).digest()
                                     for i, m in enumerate(msgs))))
    if "blake" in names:
        data = torch.tensor(rng.integers(0, 256, (64, b)), dtype=torch.int32)
        out.append(Body(
            "k_b2b", "pk_prim_b2b", (data,), False, (32,),
            lambda d: _i32(ph.blake2b_fixed(_i64(d), 32)),
            lambda o, d=data: all(
                _lane_bytes(o[0], i) == hashlib.blake2b(_lane_bytes(d, i), digest_size=32).digest()
                for i in range(b))))
    if "base" in names:
        ks = [int.from_bytes(rng.bytes(32), "little") for _ in range(b)]
        digits = _bytes_cols([k.to_bytes(32, "little") for k in ks])
        out.append(Body(
            "k_base", "pk_prim_base", (digits,), True, (40,),
            lambda d: _i32(pc.stack(pc.base_mul_w8(_i64(d)))),
            lambda o, ks=ks: all(_point_affine(o[0][:, i].tolist()) == _affine(_mul(k, BASE))
                                 for i, k in enumerate(ks))))
    if "ladder" in names:
        pts = [_mul(int(rng.integers(1, 2**60)), BASE) for _ in range(b)]
        aff = [_affine(p) for p in pts]
        flat = torch.tensor([_limbs([x, y, 1, x * y % P]) for x, y in aff],
                            dtype=torch.int32).T.contiguous()
        ks = [int.from_bytes(rng.bytes(32), "little") >> 3 for _ in range(b)]
        digits = torch.tensor([[(k >> (4 * w)) & 0xF for w in range(63, -1, -1)] for k in ks],
                              dtype=torch.int32).T.contiguous()
        out.append(Body(
            "k_lad", "pk_prim_lad", (flat, digits), False, (40,),
            lambda p, d: _i32(pc.stack(pc.scalar_mul_w4(_i64(d), pc.unstack(_i64(p))))),
            lambda o, ks=ks, aff=aff: all(
                _point_affine(o[0][:, i].tolist()) == _affine(_mul(k, (x, y, 1, x * y % P)))
                for i, (k, (x, y)) in enumerate(zip(ks, aff)))))
    if "decomp" in names:
        encs = [_compress(_mul(int(rng.integers(1, 2**60)), BASE)) for _ in range(b)]
        enc = _bytes_cols(encs)

        def dec_twin(e):
            ok, p = pc.decompress(e)
            return _i32(ok[None], pc.compress_many([p])[0])

        out.append(Body(
            "k_dec", "pk_prim_dec", (enc,), False, (1, 32), dec_twin,
            lambda o, e=enc: bool(o[0].all()) and torch.equal(o[1], e)))
    if "scalar" in names:
        raw = torch.tensor(rng.integers(0, 256, (64, b)), dtype=torch.int32)

        def red_check(o, r=raw):
            for i in range(b):
                v = int.from_bytes(_lane_bytes(r, i), "little")
                if int.from_bytes(_lane_bytes(o[0], i), "little") != v % L:
                    return False
                if bool(o[1][0, i]) != (int.from_bytes(_lane_bytes(r[:32], i), "little") < L):
                    return False
            return True

        out.append(Body(
            "k_red", "pk_prim_red", (raw,), False, (32, 1),
            lambda r: _i32(fe.reduce512(r), fe.scalar_lt_l(r[:32])[None]),
            red_check))
    return out


def _on(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)


def _launch(fn, body: Body, dev: torch.device, stream) -> tuple:
    args = _on(body.args, dev)
    b = body.args[0].shape[-1]
    outs = tuple(torch.empty((r, b), dtype=torch.int32, device=dev) for r in body.out_rows)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if body.base8:
        ptrs.insert(0, K._base8(dev).data_ptr())
    rc = fn(b, *ptrs, *(o.data_ptr() for o in outs), stream)
    if rc != 0:
        raise RuntimeError(f"{body.name} kernel launch failed: cudaError {rc}")
    return outs


def launch(body: Body, dev: torch.device) -> tuple:
    """The CUDA body on `dev` -> its int32 outputs (counted in
    kernels.LAUNCHES["primitives"]); no synchronisation. The source's
    resources row is k_lad's (build.ATTRIBUTE_KERNEL), so only the
    ladder's launch fills it, with its own bytes."""
    if dev.type != "cuda":
        raise ValueError(f"the primitive kernels run on CUDA, not {dev}")
    from ..ops.pk import build

    fn = build.kernel_lib("primitives", body.entry)
    t0 = time.monotonic()
    outs = _launch(fn, body, dev, K._stream(dev))
    K._launched("primitives", t0, body.args, outs, capture=body.entry == "pk_prim_lad")
    return outs


def run(names=PRIMITIVES, device=None) -> dict:
    """{body name: True if OK}. On the card: the CUDA body equals its twin
    bit for bit and the result equals the references; on the CPU: the
    twin equals the references."""
    dev = resolve(device)
    res = {}
    for body in bodies(names):
        want = body.twin(*_on(body.args, dev))
        if dev.type == "cuda":
            got = launch(body, dev)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            got, same = want, True
        res[body.name] = same and body.check(tuple(g.cpu() for g in got))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="primitive",
                    help=" ".join(PRIMITIVES) + " (default: all)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    unknown = set(a.names) - set(PRIMITIVES)
    if unknown:
        ap.error(f"unknown primitive(s): {' '.join(sorted(unknown))}")
    res = run(tuple(a.names) or PRIMITIVES, a.device)
    for name, ok in res.items():
        print(f"{name}: {'OK' if ok else 'MISMATCH'}", flush=True)
    return 0 if all(res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
