"""The port's two tools on the CPU: the primitive bisection harness
(tools/debug_pk.py) and the field-op microbenchmark (tools/fe_bench.py),
through their plain twins against hashlib and Python ints; their CUDA
lane bodies (csrc/tools.cuh) and the dedicated squaring fe_sq
(csrc/pk.cuh), built as host C++, against the twins bit for bit."""

import numpy as np
import pytest
import torch

from ouroboros_consensus_tpu_torch.ops.pk import build
from ouroboros_consensus_tpu_torch.ops.pk import field as fe
from ouroboros_consensus_tpu_torch.ops.pk import kernels as K
from ouroboros_consensus_tpu_torch.tools import debug_pk, fe_bench

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def emu():
    return build.build_host_emu()


@pytest.mark.parametrize("name", debug_pk.PRIMITIVES)
def test_debug_pk_twins_match_references(name):
    res = debug_pk.run((name,), "cpu")
    assert res and all(res.values()), res


def test_debug_pk_cli_reports_every_body(capsys):
    assert debug_pk.main(["--device", "cpu", "sha", "blake", "scalar"]) == 0
    lines = capsys.readouterr().out.split("\n")
    assert [ln for ln in lines if ln] == ["k_sha: OK", "k_shav: OK", "k_b2b: OK", "k_red: OK"]
    with pytest.raises(SystemExit):
        debug_pk.main(["--device", "cpu", "ripemd"])


@pytest.fixture(scope="module")
def bodies():
    return {b.name: b for b in debug_pk.bodies()}


@pytest.mark.parametrize("name", ["k_sha", "k_shav", "k_b2b", "k_base", "k_lad", "k_dec", "k_red"])
def test_primitive_lane_bodies_match_twins(emu, bodies, name):
    """Each body of csrc/primitives.cu, compiled as host C++, produces the
    plain twin's outputs bit for bit."""
    body = bodies[name]
    got = debug_pk._launch(getattr(emu, body.entry), body, CPU, None)
    want = body.twin(*body.args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _loose(n: int, seed: int) -> torch.Tensor:
    """n random loose field elements: limb i below 2^W[i] + 2^14, plus
    the edge values and the all-maximal loose element."""
    rng = np.random.default_rng(seed)
    rand = np.stack([rng.integers(0, (1 << w) + (1 << 14), n) for w in fe.W])
    edge = [fe.int_to_limbs(v) for v in (0, 1, 2, fe.P - 1, fe.P - 19, (1 << 255) - 20)]
    top = [(1 << w) + (1 << 14) - 1 for w in fe.W]
    cols = np.concatenate([rand, np.array(edge + [top]).T], axis=1)
    return torch.tensor(cols, dtype=torch.int64)


def test_dedicated_squaring_equals_mul_limb_for_limb(emu):
    a = _loose(1000, 3)
    sq = fe.sq(a)
    assert torch.equal(sq, fe.mul(a, a))
    for i in range(a.shape[1]):
        v = sum(int(x) << fe.OFF[k] for k, x in enumerate(a[:, i].tolist()))
        got = sum(int(x) << fe.OFF[k] for k, x in enumerate(sq[:, i].tolist()))
        assert got % fe.P == v * v % fe.P
    a32 = a.to(torch.int32).contiguous()
    out = torch.empty_like(a32)
    assert emu.pk_fe_sq(a.shape[1], a32.data_ptr(), out.data_ptr(), None) == 0
    assert torch.equal(out.to(torch.int64), sq)


def test_fe_bench_cpu_route_matches_python_ints():
    fe_bench.check("cpu", k=4)
    x = fe_bench.inputs(64)
    for op in fe_bench.OPS:
        out = fe_bench.run(op, x, 4)
        assert fe_bench._agrees(op, x, out, 4, range(64)), op
    with pytest.raises(ValueError):
        fe_bench.run("div", x, 4)


@pytest.mark.parametrize("op", fe_bench.OPS)
def test_fe_bench_lane_body_matches_twin(emu, op):
    x = fe_bench.inputs(40, seed=2)
    got = fe_bench._launch(emu.pk_fe_bench, None, op, x, 4)
    assert torch.equal(got, fe_bench.run(op, x, 4))


def test_tool_launch_counts_are_kept():
    assert K.LAUNCHES.keys() >= {"primitives", "fe_bench", "vrf_prep", "vrf_bc_prep"}
    with pytest.raises(RuntimeError, match="CUDA"):
        fe_bench.bench("cpu")
