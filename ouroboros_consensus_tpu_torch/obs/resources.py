"""Device resources: what does each hand-written kernel take of the card?

The JAX package's obs/resources.py is the port's reference: it reads
XLA's cost and memory analyses of each compiled stage program. The
port's counterpart is each kernel's own figures, taken once per kernel
at its first launch in the process:

  registers      registers a thread        } cudaFuncGetAttributes, through
  local_bytes    local memory a thread     } the source's `pk_<name>_attributes`
  shared_bytes   static shared memory      } entry (ops/pk/build.py)
  max_threads    the most threads a block  }
  blocks_per_sm  resident blocks an SM at the launch geometry (the
  block_threads  occupancy API, `pk_<name>_occupancy`, which also gives
  dynamic_shared_bytes  the geometry it was asked at)
  argument_bytes the bytes of the launch's input tensors
  output_bytes   the bytes of its output tensors

The first capture of a kernel wins (the figures are fixed by the
build). Rows mirror into the default registry as `oct_stage_*` gauges,
labelled by the kernel. Capture is always on: it is two attribute
queries a kernel a process, never a timing or a synchronisation, where
the reference's OCT_STAGE_RESOURCES lever gates XLA's costly analyses.
A capture that fails inside a replay is counted in the report's
`failed` and not tried again, not raised: telemetry must not break
dispatch (chip_smoke.py fails its run when a launched kernel has no
row). The reference's budgets ratchet
(`check_device_resources`, `update_budgets_section`, `measure_graph`)
rests on its static cost model, which the port has not."""

from __future__ import annotations

import threading

RESOURCE_FIELDS = ("registers", "local_bytes", "shared_bytes", "max_threads",
                   "blocks_per_sm", "block_threads", "dynamic_shared_bytes",
                   "argument_bytes", "output_bytes")


class StageResources:
    """Each launched kernel's figures (first capture wins), and the
    captures that failed."""

    def __init__(self):
        self._lock = threading.Lock()
        self.kernels: dict[str, dict] = {}  # guarded-by: _lock
        self.failed: dict[str, str] = {}  # guarded-by: _lock

    def note_kernel(self, name: str, row: dict) -> bool:
        """Record a kernel's row; True when it was the first."""
        row = {k: int(v) for k, v in row.items() if k in RESOURCE_FIELDS}
        with self._lock:
            if name in self.kernels:
                return False
            self.kernels[name] = row
            self.failed.pop(name, None)
        from .registry import default_registry

        register_families(default_registry(), name, row)
        return True

    def tried(self, name: str) -> bool:
        """Whether `name` has its row or a failed capture."""
        with self._lock:
            return name in self.kernels or name in self.failed

    def note_failure(self, name: str, exc: BaseException) -> None:
        with self._lock:
            self.failed[name] = f"{type(exc).__name__}: {exc}"[:200]

    def report(self) -> dict:
        with self._lock:
            return {"kernels": {k: dict(v) for k, v in self.kernels.items()},
                    "failed": dict(self.failed)}

    def reset(self) -> None:
        with self._lock:
            self.kernels.clear()
            self.failed.clear()


RESOURCES = StageResources()

_GAUGES = (("registers", "oct_stage_registers", "registers a thread of one kernel"),
           ("local_bytes", "oct_stage_local_bytes", "local memory bytes a thread of one kernel"),
           ("shared_bytes", "oct_stage_shared_bytes", "static shared memory bytes of one kernel"),
           ("max_threads", "oct_stage_max_threads", "the most threads a block of one kernel"),
           ("blocks_per_sm", "oct_stage_blocks_per_sm",
            "resident blocks an SM of one kernel at its launch geometry"))


def register_families(reg, stage: str | None = None, row: dict | None = None) -> list:
    """Register (and, given a row, set) the oct_stage_* gauge families;
    split out so the metric-name check can list them without a capture."""
    fams = [reg.gauge(name, help_, ("stage",)) for _k, name, help_ in _GAUGES]
    hbm = reg.gauge("oct_stage_hbm_bytes",
                    "device bytes of one kernel launch by kind (argument|output)",
                    ("stage", "kind"))
    if row is not None and stage is not None:
        for (key, _n, _h), fam in zip(_GAUGES, fams):
            if key in row:
                fam.labels(stage=stage).set(row[key])
        for kind in ("argument", "output"):
            if f"{kind}_bytes" in row:
                hbm.labels(stage=stage, kind=kind).set(row[f"{kind}_bytes"])
    return [*fams, hbm]


def _bytes(x) -> int:
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return int(x.numel() * x.element_size())
    if isinstance(x, (tuple, list)):
        return sum(_bytes(y) for y in x)
    return 0


def capture_kernel(name: str, args, outs) -> bool:
    """Capture one kernel's figures at a launch (the wrapper's input
    tensors `args`, its outputs `outs`); a failure is counted, not
    raised."""
    try:
        from ..ops.pk import build

        row = build.kernel_figures(name)
        row["argument_bytes"] = _bytes(args)
        row["output_bytes"] = _bytes(outs)
        return RESOURCES.note_kernel(name, row)
    except Exception as e:  # noqa: BLE001 — telemetry must not break dispatch
        RESOURCES.note_failure(name, e)
        return False
