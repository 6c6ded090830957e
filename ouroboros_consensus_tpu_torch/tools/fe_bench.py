"""Field-op microbenchmark: fe_mul against the dedicated squaring fe_sq.

    python -m ouroboros_consensus_tpu_torch.tools.fe_bench               # on the card
    python -m ouroboros_consensus_tpu_torch.tools.fe_bench --device cpu  # correctness only

Each lane (one thread, csrc/fe_bench.cu) runs CHAINS = 4 independent
chains of K = 400 operations and sums the chains into one output:

  mul    w = fe_mul(w, v)   100 wide (32x32->64) products
  mulsq  w = fe_mul(w, w)   100 — the stages' squaring today
  sq     w = fe_sq(w)        55 — ref10's squaring (csrc/pk.cuh)

The card's times are reported in ns per operation at 8,192 lanes (a full
replay window: 64 blocks of 128 threads) and at 33,792 lanes (256 per SM
on 132 SMs), each beside its operation bound: the op's wide products
over SMs x 32 per clock x the maximum SM clock (device.wide_product_rate,
the model of chip_smoke.py's kernel bounds). If fe_sq's gain over
fe_mul(w, w) is near 100/55 the field work is issue-bound; near 1x it is
latency-bound.

Correctness (`check`, the TPU A/B's check()): the edge values 0, 1, 2,
p-1, p-19 and 2^255-20 and 30 seeded values, each op against Python
ints, and `sq` equal to `mulsq` limb for limb. The benchmark's own
outputs are held to Python ints too.

Replaces the TPU A/B scripts/exp_sqr.py:bench_device (13-bit limbs:
`sqr_sym` and `mul_suffix`), in the port's radix of 10 limbs of 2^25.5.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve, time_ms, wide_product_rate
from ..ops.pk import field as fe
from ..ops.pk import kernels as K

OPS = ("mul", "mulsq", "sq")
PRODUCTS = {"mul": 100, "mulsq": 100, "sq": 55}
CHAINS = 4
STEPS = 400
LANES = (8192, 33792)
P = fe.P


def inputs(lanes: int, seed: int = 1) -> torch.Tensor:
    """[10, lanes] int32 in-width limbs of seeded field elements."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.stack([rng.integers(0, 1 << w, lanes) for w in fe.W]),
                        dtype=torch.int32)


def twin(op: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's plain PyTorch twin, on x's device."""
    x = x.to(torch.int64)
    vs = []
    for c in range(CHAINS):
        v = x.clone()
        v[0] += c
        vs.append(v)
    step = {"mul": lambda w, v: fe.mul(w, v), "mulsq": lambda w, v: fe.mul(w, w),
            "sq": lambda w, v: fe.sq(w)}[op]
    ws = list(vs)
    for _ in range(k):
        ws = [step(w, v) for w, v in zip(ws, vs)]
    acc = ws[0]
    for w in ws[1:]:
        acc = fe.add(acc, w)
    return acc.to(torch.int32)


def _launch(fn, stream, op: str, x: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.empty_like(x)
    rc = fn(x.shape[-1], OPS.index(op), k, x.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fe_bench kernel launch failed: cudaError {rc}")
    return out


def run(op: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """The benchmark's function: x [10, B] int32 limbs -> [10, B] int32,
    the sum over c < CHAINS of op applied k times from v_c = x + c. The
    CUDA kernel for a CUDA tensor (counted in kernels.LAUNCHES), the
    plain twin for a CPU tensor."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    K._check("fe_bench.x", x, (10, x.shape[-1]), x.device)
    if K._route(x.device) == "plain":
        return twin(op, x, k)
    from ..ops.pk import build

    fn = build.kernel_lib("fe_bench")
    t0 = time.monotonic()
    out = _launch(fn, K._stream(x.device), op, x, k)
    K._launched("fe_bench", t0, (x,), out)
    return out


def expected(op: str, x: int, k: int) -> int:
    """run()'s value for one lane, in Python ints mod p."""
    e = k + 1 if op == "mul" else 1 << k
    return sum(pow(x + c, e, P) for c in range(CHAINS)) % P


def _value(col) -> int:
    return sum(int(v) << fe.OFF[i] for i, v in enumerate(col)) % P


def _agrees(op: str, x: torch.Tensor, out: torch.Tensor, k: int, lanes) -> bool:
    xs, os_ = x.cpu().T.tolist(), out.cpu().T.tolist()
    return all(_value(os_[i]) == expected(op, _value(xs[i]), k) for i in lanes)


def check(device=None, k: int = 4) -> None:
    """The edge values and 30 seeded values, each op against Python ints,
    and sq equal to mulsq limb for limb; raises AssertionError."""
    rng = np.random.default_rng(7)
    vals = [0, 1, 2, P - 1, P - 19, (1 << 255) - 20]
    vals += [int.from_bytes(rng.bytes(32), "little") % P for _ in range(30)]
    x = torch.tensor([fe.int_to_limbs(v) for v in vals], dtype=torch.int32).T.contiguous()
    x = x.to(resolve(device))
    outs = {op: run(op, x, k) for op in OPS}
    for op, out in outs.items():
        assert _agrees(op, x, out, k, range(len(vals))), f"{op} disagrees with Python ints"
    assert torch.equal(outs["sq"], outs["mulsq"]), "fe_sq differs from fe_mul(a, a)"


def bench(device=None, lanes=LANES, k: int = STEPS, reps: int = 5) -> list[dict]:
    """One row per (lanes, op): ms per launch, ns per operation and its
    bound; every output is held to Python ints (a sample of lanes) and
    sq to mulsq limb for limb. Needs the card."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("fe_bench times the card; pass a CUDA device")
    rate = wide_product_rate()
    rows = []
    for n in lanes:
        x = inputs(n).to(dev)
        outs = {}
        for op in OPS:
            ms = time_ms(lambda op=op: run(op, x, k), reps)
            outs[op] = run(op, x, k)
            ops = n * k * CHAINS
            rows.append({
                "op": op, "lanes": n, "steps": k, "chains": CHAINS, "ms": ms,
                "ns_per_op": ms * 1e6 / ops,
                "bound_ns_per_op": PRODUCTS[op] / rate * 1e9,
                "bound_ms": ops * PRODUCTS[op] / rate * 1e3,
            })
            if not _agrees(op, x, outs[op], k, range(0, n, max(1, n // 256))):
                raise AssertionError(f"{op} at {n} lanes disagrees with Python ints")
        if not torch.equal(outs["sq"], outs["mulsq"]):
            raise AssertionError(f"fe_sq differs from fe_mul(a, a) at {n} lanes")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve(a.device)
    check(dev)
    print(f"correctness OK on {dev.type}: edge + 30 seeded values, sq == mulsq", flush=True)
    if dev.type != "cuda":
        print("times: not measured (no card)")
        return 0
    rows = bench(dev)
    for r in rows:
        print(f"{r['op']:6s} {r['lanes']:6d} lanes: {r['ms']:8.4f} ms, "
              f"{r['ns_per_op']:.5f} ns/op (bound {r['bound_ns_per_op']:.5f}, "
              f"{r['ns_per_op'] / r['bound_ns_per_op']:.2f}x)", flush=True)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
