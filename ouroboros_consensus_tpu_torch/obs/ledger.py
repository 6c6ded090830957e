"""The run ledger: append-only provenance for every measured run.

The JAX package's obs/ledger.py is the port's reference, with its
schema. Each `tools/bench.py` run and `tools/profile_replay.py` call
appends one JSON record to `<repo>/.oct_ledger/runs-YYYYMMDD.jsonl`
(git-ignored; the `ledger` keyword or `--ledger DIR` moves it, "0"
turns it off), so "what was different when this number was taken?" is
a `read_runs()` filter. Append-only: a record is never rewritten, and a
torn line (a crash mid-append) is skipped by the reader.

Record schema (SCHEMA_VERSION = 1, `validate_record`):

    schema, kind, ts_unix, ts_iso, git {rev, dirty}, build_id, env, host
    {platform, pid, argv}, and the optional dicts config, result,
    phases_s, warmup_report, metrics, metrics_summary, device_resources,
    extra; wall_s.

The port's `build_id` is torch's version, CUDA's version, the card's
name and power limit (nvidia-smi) and the kernels' build digest
(`build._digest()`); its `env` is the run's keywords, since the port
reads no OCT_* lever. Everything is best-effort: a read-only disk or a
checkout without git gives partial provenance, never a failed run."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SCHEMA_VERSION = 1

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO, ".oct_ledger")

_OPTIONAL_DICTS = (
    "config", "result", "phases_s", "warmup_report", "metrics",
    "metrics_summary", "device_resources", "extra",
)


def ledger_dir(override: str | None = None) -> str | None:
    """The ledger directory: `override`, else the default; "0" turns
    the ledger off (None)."""
    if override == "0":
        return None
    return override or DEFAULT_DIR


def day_file(dir_: str, ts: float | None = None) -> str:
    day = time.strftime("%Y%m%d", time.gmtime(time.time() if ts is None else ts))
    return os.path.join(dir_, f"runs-{day}.jsonl")


# ---------------------------------------------------------------------------
# provenance probes, each best-effort
# ---------------------------------------------------------------------------


def git_provenance(repo: str | None = None) -> dict:
    """{"rev", "dirty"} of the checkout; None, None without git."""
    repo = repo or _REPO
    rev = dirty = None
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             cwd=repo, timeout=10, check=True).stdout.strip() or None
        status = subprocess.run(["git", "status", "--porcelain"], capture_output=True,
                                text=True, cwd=repo, timeout=10, check=True).stdout
        dirty = bool(status.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return {"rev": rev, "dirty": dirty}


def runtime_build_id() -> str | None:
    """torch's and CUDA's versions, the card's name and power limit,
    and the kernels' build digest; None off the card."""
    import torch

    if not torch.cuda.is_available():
        return None
    from ..ops.pk import build

    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = torch.cuda.get_device_name(0)
    return (f"torch {torch.__version__} cuda {torch.version.cuda} | {card} | "
            f"kernels {build._digest()}")


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def build_record(kind: str, *, config: dict | None = None, result: dict | None = None,
                 wall_s: float | None = None, phases_s: dict | None = None,
                 warmup_report: dict | None = None, metrics: dict | None = None,
                 metrics_summary: dict | None = None, device_resources: dict | None = None,
                 build_id: str | None = None, env: dict | None = None,
                 extra: dict | None = None) -> dict:
    """One record, not yet appended. `env`: the run's keywords."""
    now = time.time()
    return {
        "schema": SCHEMA_VERSION,
        "kind": str(kind),
        "ts_unix": now,
        "ts_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)),
        "git": git_provenance(),
        "build_id": build_id if build_id is not None else runtime_build_id(),
        "env": dict(env or {}),
        "host": {"platform": sys.platform, "pid": os.getpid(), "argv": list(sys.argv)},
        "config": config,
        "result": result,
        "wall_s": None if wall_s is None else float(wall_s),
        "phases_s": phases_s,
        "warmup_report": warmup_report,
        "metrics": metrics,
        "metrics_summary": metrics_summary,
        "device_resources": device_resources,
        "extra": extra,
    }


def validate_record(rec) -> list[str]:
    """The schema check -> the problems ([] = well-formed)."""
    errs: list[str] = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    if rec.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema must be {SCHEMA_VERSION}, got {rec.get('schema')!r}")
    if not isinstance(rec.get("kind"), str) or not rec.get("kind"):
        errs.append("kind missing or not a non-empty string")
    if not isinstance(rec.get("ts_unix"), (int, float)):
        errs.append("ts_unix missing or not a number")
    if not isinstance(rec.get("ts_iso"), str):
        errs.append("ts_iso missing or not a string")
    git = rec.get("git")
    if not isinstance(git, dict) or "rev" not in git or "dirty" not in git:
        errs.append("git must be a dict with rev and dirty")
    if not (rec.get("build_id") is None or isinstance(rec.get("build_id"), str)):
        errs.append("build_id must be a string or null")
    if not isinstance(rec.get("env"), dict):
        errs.append("env missing or not a dict")
    host = rec.get("host")
    if not isinstance(host, dict) or "platform" not in host:
        errs.append("host must be a dict with platform")
    for key in _OPTIONAL_DICTS:
        v = rec.get(key)
        if v is not None and not isinstance(v, dict):
            errs.append(f"{key} must be a dict or null")
    w = rec.get("wall_s")
    if w is not None and not isinstance(w, (int, float)):
        errs.append("wall_s must be a number or null")
    try:
        json.dumps(rec, allow_nan=False)
    except (TypeError, ValueError) as e:
        errs.append(f"not strict-JSON-serializable: {e}")
    return errs


def append(rec: dict, path: str | None = None, dir_: str | None = None) -> str | None:
    """Append one record as one JSONL line (one write: concurrent
    appenders interleave by lines under O_APPEND) -> the file, or None
    when the ledger is off or the disk refused."""
    if path is None:
        d = ledger_dir(dir_)
        if d is None:
            return None
        path = day_file(d)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        line = json.dumps(rec, sort_keys=True, allow_nan=False)
        # an append-only journal, not a document rewritten in place: the
        # reader skips a torn last line
        with open(path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
        return path
    except (OSError, TypeError, ValueError):
        return None


def record_run(kind: str, dir_: str | None = None, **kw) -> dict | None:
    """build_record + append -> the record (`_path`: where it landed),
    or None when the ledger is off or unwritable."""
    if ledger_dir(dir_) is None:
        return None
    rec = build_record(kind, **kw)
    path = append(rec, dir_=dir_)
    if path is None:
        return None
    rec["_path"] = path
    return rec


def record_replay(kind: str, recorder=None, dir_: str | None = None, **kw) -> dict | None:
    """record_run with the obs state folded in: the recorder's registry
    snapshot and latency summary, the warmup report and the resources
    report."""
    from .resources import RESOURCES
    from .warmup import WARMUP

    if recorder is not None:
        kw.setdefault("metrics", recorder.registry.snapshot())
        kw.setdefault("metrics_summary", recorder.latency_summary())
    kw.setdefault("warmup_report", WARMUP.report())
    res = RESOURCES.report()
    if res["kernels"] or res["failed"]:
        kw.setdefault("device_resources", res)
    return record_run(kind, dir_=dir_, **kw)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def iter_runs(dir_: str | None = None):
    """(record, file, line number) over every day file, oldest first;
    torn lines skipped."""
    d = ledger_dir(dir_)
    if d is None or not os.path.isdir(d):
        return
    for name in sorted(os.listdir(d)):
        if not (name.startswith("runs-") and name.endswith(".jsonl")):
            continue
        path = os.path.join(d, name)
        try:
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line), path, i
                    except json.JSONDecodeError:
                        continue  # a torn append
        except OSError:
            continue


def read_runs(dir_: str | None = None, kind: str | None = None) -> list[dict]:
    """Every record (of `kind`), in append order."""
    return [rec for rec, _p, _i in iter_runs(dir_) if kind is None or rec.get("kind") == kind]


def _result_blurb(rec: dict) -> str:
    res = rec.get("result") or {}
    parts = []
    if res.get("value") is not None:
        parts.append(f"{res['value']} {res.get('unit', '')}".strip())
    elif res.get("rate_per_s") is not None:
        parts.append(f"{res['rate_per_s']} headers/s")
    if res.get("headers") is not None:
        parts.append(f"{res['headers']} headers")
    ms = rec.get("metrics_summary") or {}
    if ms.get("windows"):
        parts.append(f"{ms['windows']} windows")
    metrics = rec.get("metrics") or {}
    stalls = sum(int(s.get("value", 0))
                 for s in (metrics.get("oct_stalls_total") or {}).get("samples", []))
    if stalls:
        parts.append(f"{stalls} STALL(s)")
    return ", ".join(parts) or "(no result banked)"


def format_run(rec: dict) -> str:
    build = rec.get("build_id") or "-"
    if len(build) > 24:
        build = build[:21] + "..."
    wall = rec.get("wall_s")
    wall_s = f"{wall:.0f}s" if isinstance(wall, (int, float)) else "?"
    return (f"{rec.get('ts_iso', '?'):20s} {rec.get('kind', '?'):14s} "
            f"build={build:24s} wall={wall_s:6s} " + _result_blurb(rec))


def main(argv: list[str] | None = None) -> int:
    """`tail --last N [--kind K] [--build-id S] [--dir D] [--json]`."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m ouroboros_consensus_tpu_torch.obs.ledger",
                                 description="query the append-only run ledger")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tail = sub.add_parser("tail", help="newest runs, one line each (newest last)")
    tail.add_argument("--last", type=int, default=10, metavar="N")
    tail.add_argument("--kind", default=None, help="filter by record kind")
    tail.add_argument("--build-id", default=None, dest="build_id",
                      help="substring filter over the build id")
    tail.add_argument("--dir", default=None, help="ledger directory (default: the repo's)")
    tail.add_argument("--json", action="store_true", help="print the records as JSONL")
    args = ap.parse_args(argv)
    runs = read_runs(args.dir, kind=args.kind)
    if args.build_id is not None:
        runs = [r for r in runs if args.build_id in (r.get("build_id") or "")]
    runs = runs[-args.last:] if args.last > 0 else []
    if not runs:
        print("(no matching ledger records)")
        return 1
    for rec in runs:
        print(json.dumps(rec, sort_keys=True) if args.json else format_run(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
