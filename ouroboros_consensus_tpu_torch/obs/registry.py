"""Numpy-backed metrics registry: counters, gauges, fixed-bucket
histograms, Prometheus text exposition and JSON snapshots.

Reference: cardano-node maps the consensus tracers onto EKG/Prometheus
gauges ("tracers -> EKG/Prometheus"); the JAX package's obs/registry.py
is the port's reference, and this is its copy, method for method, with
the same exposition and snapshot bytes for the same operations
(tests/test_torch_registry.py). Everything is host-side and
allocation-light: a histogram is one int64 numpy counts array indexed by
`np.searchsorted` over a fixed upper-bound vector, so observing a value
(or a whole column of values at once via `observe_many`) costs no Python
object churn on the hot path.

Vocabulary (one metric family per name, optional labels):

    reg = MetricsRegistry()
    wins = reg.counter("oct_windows_total", "windows", ("outcome",))
    wins.labels(outcome="packed").inc()
    lat = reg.histogram("oct_serve_verdict_latency_seconds", "submit->verdict")
    lat.observe(0.012)
    print(reg.expose_text())      # Prometheus text format 0.0.4
    json.dumps(reg.snapshot())    # machine-readable twin
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping, Sequence

import numpy as np

# default latency buckets (seconds): µs-scale staging through walls of
# minutes (the reference's, kept so that the two expositions agree)
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0, 300.0, 600.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render without a decimal."""
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _label_str(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotone counter (one labeled child of a family)."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    """Instantaneous value."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Fixed-bucket histogram: `uppers` are the finite upper bounds; the
    +Inf bucket is implicit. Counts live in one int64 numpy array."""

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        ups = np.asarray(sorted(buckets), np.float64)
        if ups.size == 0:
            raise ValueError("histogram needs at least one bucket")
        self._lock = lock
        self.uppers = ups
        self.counts = np.zeros(ups.size + 1, np.int64)
        self.sum = 0.0
        self.dropped_nonfinite = 0

    @property
    def count(self) -> int:
        """Total observations. Takes the registry lock: `counts` is
        mutated under it by concurrent observe()/observe_many(), so an
        unlocked sum could tear against a mid-flight bincount add (the
        SLO endpoint scrapes while the serving scheduler observes)."""
        with self._lock:
            return self._count_locked()

    def _count_locked(self) -> int:
        # caller holds self._lock (exposition renders under it and the
        # shared lock is non-reentrant, so the public property would
        # deadlock — same split as _snapshot_locked/_expose_text_locked)
        return int(self.counts.sum())

    def observe(self, value: float) -> None:
        v = float(value)
        if not np.isfinite(v):
            # a NaN/inf observation (a timing bug, a poisoned column)
            # would poison `sum` forever and leak NaN into every JSON
            # snapshot, which must stay strict JSON. Drop it, but keep
            # the drop countable.
            with self._lock:
                self.dropped_nonfinite += 1
            return
        with self._lock:
            self.counts[int(np.searchsorted(self.uppers, v))] += 1
            self.sum += v

    def observe_many(self, values) -> None:
        """Vectorized observe of a whole column (one searchsorted + one
        bincount — no per-value Python). Non-finite entries are dropped
        (and counted) like `observe` does."""
        a = np.asarray(values, np.float64).ravel()
        if a.size == 0:
            return
        finite = np.isfinite(a)
        n_bad = int(a.size - finite.sum())
        if n_bad:
            a = a[finite]
        idx = np.searchsorted(self.uppers, a)
        with self._lock:
            self.dropped_nonfinite += n_bad
            if a.size:
                self.counts += np.bincount(idx, minlength=self.counts.size)
                self.sum += float(a.sum())

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile (the Prometheus histogram_quantile
        estimate). None when empty, never NaN: a NaN here would ride the
        p50/p99 fields of `snapshot()` into strict-JSON consumers. The
        +Inf bucket clamps to the last finite bound.

        Takes the registry lock: the cumsum must see one consistent
        `counts` array, not a row torn against a concurrent observe (the
        serve SLO snapshot calls this from a scrape thread while the
        scheduler observes)."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float | None:
        # caller holds self._lock (non-reentrant; snapshot() renders
        # every child's p50/p99 under it)
        total = self._count_locked()
        if total == 0:
            return None
        rank = q * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        if i >= self.uppers.size:  # landed in +Inf
            return float(self.uppers[-1])
        lo = 0.0 if i == 0 else float(self.uppers[i - 1])
        hi = float(self.uppers[i])
        below = 0 if i == 0 else int(cum[i - 1])
        in_bucket = int(self.counts[i])
        if in_bucket == 0:
            return hi
        v = lo + (hi - lo) * (rank - below) / in_bucket
        return v if np.isfinite(v) else None


_TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class _Family:
    """One named metric family; children keyed by label values."""

    def __init__(self, registry: "MetricsRegistry", name: str, help_: str,
                 cls, labelnames: tuple[str, ...], **kw):
        self.name = name
        self.help = help_
        self.cls = cls
        self.labelnames = labelnames
        self._kw = kw
        self._lock = registry._lock
        self._children: dict[tuple, object] = {}  # guarded-by: _lock
        if not labelnames:
            self._default = self._make(())

    def _make(self, key: tuple):
        child = self.cls(self._lock, **self._kw)
        self._children[key] = child
        return child

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is not None:
            return child
        # create under the registry lock: two racing first-touches must
        # share ONE child (a lost duplicate would drop its increments),
        # and a concurrent exposition must never see the dict mid-insert
        with self._lock:
            child = self._children.get(key)
            return child if child is not None else self._make(key)

    # unlabeled families proxy the child API directly
    def __getattr__(self, attr):
        if not self.labelnames:
            return getattr(self._default, attr)
        raise AttributeError(attr)

    def samples(self):
        """[(labels dict, child)] in stable (sorted) order."""
        for key in sorted(self._children):
            yield dict(zip(self.labelnames, key)), self._children[key]


class MetricsRegistry:
    """Name -> family. One lock per registry: observations arrive from
    the scheduler thread while a scrape thread renders."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}  # guarded-by: _lock

    def _family(self, name: str, help_: str, cls, labelnames, **kw):
        # registration and exposition share the registry lock: a scrape
        # must never iterate _families/_children mid-insert
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.cls is not cls or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered differently"
                    )
                return fam
            fam = _Family(self, name, help_, cls, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._family(name, help_, Counter, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._family(name, help_, Gauge, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> _Family:
        return self._family(name, help_, Histogram, labelnames,
                            buckets=buckets)

    # -- exposition ---------------------------------------------------------

    def expose_text(self) -> str:
        """Prometheus text exposition format 0.0.4. Holds the registry
        lock for the render: concurrent label first-touches and
        increments wait instead of mutating the dicts mid-iteration."""
        with self._lock:
            return self._expose_text_locked()

    def _expose_text_locked(self) -> str:
        out: list[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {_TYPES[fam.cls]}")
            for labels, child in fam.samples():
                if isinstance(child, Histogram):
                    cum = 0
                    for upper, c in zip(child.uppers, child.counts):
                        cum += int(c)
                        le = dict(labels)
                        le["le"] = _fmt(float(upper))
                        out.append(f"{name}_bucket{_label_str(le)} {cum}")
                    le = dict(labels)
                    le["le"] = "+Inf"
                    n = child._count_locked()
                    out.append(
                        f"{name}_bucket{_label_str(le)} {n}"
                    )
                    out.append(
                        f"{name}_sum{_label_str(labels)} {_fmt(child.sum)}"
                    )
                    out.append(
                        f"{name}_count{_label_str(labels)} {n}"
                    )
                else:
                    out.append(
                        f"{name}{_label_str(labels)} {_fmt(child.value)}"
                    )
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        """JSON-able twin of the exposition."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        snap: dict = {}
        for name in sorted(self._families):
            fam = self._families[name]
            rows = []
            for labels, child in fam.samples():
                if isinstance(child, Histogram):
                    rows.append({
                        "labels": labels,
                        "count": child._count_locked(),
                        "sum": child.sum,
                        **({"dropped_nonfinite": child.dropped_nonfinite}
                           if child.dropped_nonfinite else {}),
                        "buckets": {
                            _fmt(float(u)): int(c)
                            for u, c in zip(child.uppers, child.counts)
                        },
                        "inf": int(child.counts[-1]),
                        "p50": child._quantile_locked(0.5),
                        "p99": child._quantile_locked(0.99),
                    })
                else:
                    rows.append({"labels": labels, "value": child.value})
            snap[name] = {
                "type": _TYPES[fam.cls], "help": fam.help, "samples": rows,
            }
        return snap


_DEFAULT: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry (a ValidationService's default)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


def reset_default_registry() -> None:
    """Test isolation: drop the process-wide registry."""
    global _DEFAULT
    _DEFAULT = None
