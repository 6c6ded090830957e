"""The port stands alone: no module of ouroboros_consensus_tpu_torch and
not chip_smoke.py imports jax or the JAX package; its CUDA sources
include nothing from outside their directory but the C and CUDA
headers; the port replays a chain with jax made unimportable (on both
read paths, the native chunk scan included); and its device entry
points (the replay and the bench) raise without CUDA instead of running
on the CPU."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "ouroboros_consensus_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ouroboros_consensus_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    rel_base = path.relative_to(REPO).with_suffix("").parts
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                pkg = rel_base[: len(rel_base) - node.level]
                yield ".".join([*pkg, *(node.module.split(".") if node.module else [])])
            else:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value in FORBIDDEN:
                yield node.value


def test_no_jax_or_reference_imports():
    files = _sources()
    assert len(files) > 15
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p)
           if _forbidden(m)]
    assert bad == []


def test_scan_covers_the_tools_and_every_kernel_source():
    from ouroboros_consensus_tpu_torch.ops.pk import build

    scanned = {p.relative_to(PORT).as_posix() for p in _sources()[:-1]}
    assert {"tools/debug_pk.py", "tools/fe_bench.py", "tools/bench.py",
            "tools/db_analyser.py", "testing/corrupt.py", "native_scan.py",
            "protocol/views.py", "ops/pk/kernels.py", "ops/pk/build.py",
            "ops/pk/prove.py", "ops/host_kes.py", "protocol/forge.py",
            "tools/db_synthesizer.py", "obs/registry.py", "obs/server.py",
            "protocol/admission.py", "node/serve.py", "testing/traffic.py",
            "tools/serve_bench.py", "protocol/abstract.py", "protocol/select.py",
            "protocol/instances.py", "protocol/tpraos.py", "ops/ed25519_batch.py",
            "block/forge.py", "hardfork/__init__.py", "hardfork/history.py",
            "hardfork/combinator.py", "hardfork/byron_mock.py",
            "hardfork/composite.py"} <= scanned
    csrc = PORT / "ops" / "pk" / "csrc"
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(build.KERNELS)
    assert {"vrf_prep", "vrf_bc_prep", "primitives", "fe_bench", "forge",
            "ed_verify"} <= set(build.KERNELS)
    local = {p.name for p in csrc.iterdir()}
    system = {"stddef.h", "stdint.h"}
    for p in sorted(csrc.iterdir()):
        for inc in re.findall(r'^#include [<"]([^>"]+)[>"]', p.read_text(), re.M):
            assert inc in local or inc in system, (p.name, inc)


def test_relative_imports_stay_in_the_port():
    for p in _sources()[:-1]:
        for m in _imports(p):
            if m.startswith("ouroboros_consensus"):
                assert m.startswith("ouroboros_consensus_tpu_torch"), (p, m)


CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["ouroboros_consensus_tpu"] = None
import ouroboros_consensus_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, "ouroboros_consensus_tpu_torch."):
    importlib.import_module(m.name)
import torch
torch.set_num_threads(1)
from fractions import Fraction
from ouroboros_consensus_tpu_torch.protocol.praos import PraosParams
from ouroboros_consensus_tpu_torch.testing import synth
from ouroboros_consensus_tpu_torch.tools import db_analyser
params = PraosParams(slots_per_kes_period=20, max_kes_evolutions=62,
                     security_param=2, active_slot_coeff=Fraction(1, 2),
                     epoch_length=10, kes_depth=2)
pools = [synth.make_pool(0, kes_depth=2)]
lview = synth.make_ledger_view(pools)
synth.synthesize(sys.argv[1], params, pools, lview, 8)
r = db_analyser.revalidate(sys.argv[1], params, lview, backend="device", device="cpu")
n = db_analyser.revalidate(sys.argv[1], params, lview, backend="native")
v = db_analyser.revalidate(sys.argv[1], params, lview, backend="native", columnar=False)
assert r.n_valid == n.n_valid == v.n_valid == 8 and r.error is None
assert r.final_state == n.final_state == v.final_state
assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
print("REPLAYED", r.n_valid)
"""


def test_replays_with_jax_unimportable(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path / "db")],
                         capture_output=True, text=True, env=env, cwd=str(tmp_path),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "REPLAYED 8" in out.stdout


def test_device_entry_point_refuses_without_cuda(tmp_path, monkeypatch):
    from ouroboros_consensus_tpu_torch import device
    from ouroboros_consensus_tpu_torch.protocol.praos import PraosParams
    from ouroboros_consensus_tpu_torch.testing import synth
    from ouroboros_consensus_tpu_torch.tools import db_analyser

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve(None)
    pools = [synth.make_pool(0, kes_depth=2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        db_analyser.revalidate(str(tmp_path), PraosParams(kes_depth=2),
                               synth.make_ledger_view(pools), backend="device")
    from ouroboros_consensus_tpu_torch.tools import bench

    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--db", str(tmp_path)])
    with pytest.raises(ValueError):
        bench.measure(str(tmp_path), device="cpu")
    from ouroboros_consensus_tpu_torch.tools import db_synthesizer

    with pytest.raises(RuntimeError, match="CUDA"):
        db_synthesizer.synthesize(str(tmp_path / "forge"), PraosParams(kes_depth=2), pools,
                                  synth.make_ledger_view(pools), db_synthesizer.ForgeLimit(slots=4))
    assert not os.path.exists(tmp_path / "forge")
    assert device.resolve("cpu").type == "cpu"


def test_kernel_wrappers_refuse_unknown_devices():
    from ouroboros_consensus_tpu_torch.ops.pk import kernels

    with pytest.raises(ValueError):
        kernels._route(torch.device("meta"))


def test_serving_entry_points_refuse_without_cuda(monkeypatch):
    from ouroboros_consensus_tpu_torch.node import serve
    from ouroboros_consensus_tpu_torch.testing import traffic
    from ouroboros_consensus_tpu_torch.tools import serve_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = traffic.traffic_params(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.ValidationService(params, None, bytes(32))
    with pytest.raises(RuntimeError, match="CUDA"):
        traffic.make_traffic(kes_depth=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_bench.main(["--tenants", "2", "--kes-depth", "3"])
    host = serve.ValidationService(params, None, bytes(32), plane="host")
    assert host.device is None and not host.pump()


def test_composite_entry_points_refuse_without_cuda(tmp_path, monkeypatch):
    from ouroboros_consensus_tpu_torch.hardfork import composite
    from ouroboros_consensus_tpu_torch.ops import ed25519_batch

    cfg = composite.CardanoMockConfig(byron_epochs=1, byron_epoch_length=4, shelley_epochs=1,
                                      epoch_length=4, k=3)
    composite.synthesize(str(tmp_path / "db"), cfg, 10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        composite.revalidate(str(tmp_path / "db"), cfg, "device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ed25519_batch.verify_batch([bytes(32)], [bytes(64)], [b""])
    assert composite.revalidate(str(tmp_path / "db"), cfg, "native").n_valid == 10
