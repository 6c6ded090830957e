"""The port's metrics registry (obs/registry.py) against the JAX
package's: the same operations give byte-identical Prometheus text and
equal JSON snapshots; quantiles, non-finite drops and the registration
errors match."""

import json
import math
import threading

import numpy as np
import pytest

from ouroboros_consensus_tpu.obs import registry as rreg
from ouroboros_consensus_tpu_torch.obs import registry as preg


def _serve_families(reg):
    """The serving plane's six families, as node/serve.py registers them."""
    return (
        reg.counter("oct_serve_suffixes_total",
                    "candidate suffixes resolved by the serving plane", ("result",)),
        reg.counter("oct_serve_headers_total", "headers validated by the serving plane"),
        reg.counter("oct_serve_windows_total", "shared serving windows retired", ("mode",)),
        reg.gauge("oct_serve_degraded",
                  "1 while serving rides the recovery ladder (degraded mode)"),
        reg.gauge("oct_serve_queue_depth", "pending headers across all tenant queues"),
        reg.histogram("oct_serve_verdict_latency_seconds",
                      "submit->verdict wall per candidate suffix"),
    )


def _script_serve(reg):
    sfx, hdr, win, deg, queue, lat = _serve_families(reg)
    sfx.labels(result="valid").inc()
    sfx.labels(result="invalid").inc(2)
    sfx.labels(result="refused").inc()
    hdr.inc(4096)
    win.labels(mode="warm").inc(3)
    win.labels(mode="host").inc()
    deg.set(1)
    deg.set(0)
    queue.set(17)
    for v in (0.0004, 0.003, 0.02, 0.02, 0.7, 3.0, 700.0):
        lat.observe(v)


def _script_columns(reg):
    h = reg.histogram("oct_window_seconds", "a column at once", ("kind",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    rng = np.random.default_rng(5)
    h.labels(kind="packed").observe_many(rng.exponential(0.05, 200))
    h.labels(kind="generic").observe_many([0.5, float("nan"), float("inf"), 2.0])
    h.labels(kind="generic").observe(float("nan"))
    h.labels(kind="empty")
    g = reg.gauge("oct_fraction", "a float gauge")
    g.set(1 / 3)
    g.inc(0.25)
    c = reg.counter("oct_escaped_total", "labels with quotes", ("path",))
    c.labels(path='a"b\\c').inc()
    c.labels(path="/slo").inc(1.5)


def _script_empty(reg):
    reg.counter("oct_untouched_total", "a family with no child", ("x",))
    reg.histogram("oct_untouched_seconds", "no observation")


SCRIPTS = {"serve": _script_serve, "columns": _script_columns, "empty": _script_empty,
           "all": lambda r: (_script_serve(r), _script_columns(r), _script_empty(r))}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_exposition_is_byte_identical(name):
    a, b = rreg.MetricsRegistry(), preg.MetricsRegistry()
    SCRIPTS[name](a)
    SCRIPTS[name](b)
    assert b.expose_text() == a.expose_text()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_snapshot_is_identical(name):
    a, b = rreg.MetricsRegistry(), preg.MetricsRegistry()
    SCRIPTS[name](a)
    SCRIPTS[name](b)
    assert json.dumps(b.snapshot(), sort_keys=True) == json.dumps(a.snapshot(), sort_keys=True)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.9, 0.99, 1.0])
def test_quantiles_agree(q):
    a = rreg.MetricsRegistry().histogram("h", "")
    b = preg.MetricsRegistry().histogram("h", "")
    assert a.quantile(q) is None and b.quantile(q) is None
    vals = np.random.default_rng(11).lognormal(-4, 2, 500)
    a.observe_many(vals)
    b.observe_many(vals)
    assert b.quantile(q) == a.quantile(q)
    assert b.count == a.count == 500
    assert math.isfinite(b.quantile(q))


def test_registration_errors_match():
    for mod in (rreg, preg):
        reg = mod.MetricsRegistry()
        reg.counter("x_total", "", ("a",))
        assert reg.counter("x_total", "", ("a",)) is reg.counter("x_total", "other help", ("a",))
        with pytest.raises(ValueError, match="re-registered differently"):
            reg.gauge("x_total", "", ("a",))
        with pytest.raises(ValueError, match="re-registered differently"):
            reg.counter("x_total", "", ("b",))
        with pytest.raises(ValueError, match="expected labels"):
            reg.counter("x_total", "", ("a",)).labels(b=1)
        with pytest.raises(AttributeError):
            reg.counter("x_total", "", ("a",)).inc()
        with pytest.raises(ValueError, match="at least one bucket"):
            reg.histogram("empty_seconds", "", buckets=())


def test_default_registry_is_process_wide_and_resettable():
    a = preg.default_registry()
    assert preg.default_registry() is a
    preg.reset_default_registry()
    b = preg.default_registry()
    assert b is not a
    preg.reset_default_registry()


def test_concurrent_first_touch_shares_one_child():
    reg = preg.MetricsRegistry()
    fam = reg.counter("race_total", "", ("k",))
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(500):
            fam.labels(k="same").inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fam.labels(k="same").value == 4000
    assert 'race_total{k="same"} 4000' in reg.expose_text()
