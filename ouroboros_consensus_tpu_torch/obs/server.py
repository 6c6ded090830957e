"""The live metrics/health HTTP endpoint, hosted on a thread.

The JAX package's obs/server.py is the port's reference: the same
routes, the same bodies and the same scrape counter. The serving plane
mounts it with `slo_doc=service.slo_snapshot` (tools/serve_bench.py).

Routes (minimal HTTP/1.0, no dependencies):

    GET /metrics        Prometheus text exposition format 0.0.4
    GET /metrics.json   the registry's JSON snapshot
    GET /healthz        the heartbeat document (`live_doc()`; without
                        one, the idle heartbeat the reference serves in
                        a process that has retired no window)
    GET /progress       its compact twin: phase / headers /
                        headers_per_s / age_s / window_index
    GET /slo            the serving plane's SLO document (node/serve.py
                        `ValidationService.slo_snapshot`); 404 when no
                        serving plane is mounted (`slo_doc` unset)

Every request increments `oct_metrics_scrapes_total{path=}` (label
values are the fixed route names, never wire input). The reference's
asyncio twin (`serve_metrics`) comes with the block server."""

from __future__ import annotations

import json
import os
import socket
import threading
import time

from .registry import default_registry

_PROGRESS_KEYS = (
    "phase", "headers", "headers_per_s", "age_s", "window_index",
    "stalls", "ts_unix", "seq",
)


def idle_heartbeat() -> dict:
    """The heartbeat of a process that has dispatched nothing: the
    reference's `live_snapshot()` before its recorder's first event."""
    return {
        "v": 1,
        "pid": os.getpid(),
        "ts_unix": time.time(),
        "t_mono": time.monotonic(),
        "phase": "idle",
        "age_s": 0.0,
        "headers": 0,
        "window_index": -1,
        "stalls": 0,
    }


def _live_doc(live_doc) -> dict:
    return live_doc() if live_doc is not None else idle_heartbeat()


def handle_path(path: str, registry=None, live_doc=None, slo_doc=None):
    """Route one GET -> (status: bytes, content-type: bytes, body:
    bytes)."""
    reg = registry if registry is not None else default_registry()
    scrapes = reg.counter(
        "oct_metrics_scrapes_total", "metric-endpoint requests", ("path",)
    )
    if path.startswith("/metrics.json"):
        scrapes.labels(path="/metrics.json").inc()
        return (b"200 OK", b"application/json",
                json.dumps(reg.snapshot()).encode())
    if path.startswith("/metrics"):
        scrapes.labels(path="/metrics").inc()
        return (b"200 OK", b"text/plain; version=0.0.4",
                reg.expose_text().encode())
    if path.startswith("/healthz"):
        scrapes.labels(path="/healthz").inc()
        return (b"200 OK", b"application/json",
                json.dumps(_live_doc(live_doc)).encode())
    if path.startswith("/progress"):
        scrapes.labels(path="/progress").inc()
        doc = _live_doc(live_doc)
        slim = {k: doc.get(k) for k in _PROGRESS_KEYS if k in doc}
        return (b"200 OK", b"application/json", json.dumps(slim).encode())
    if path.startswith("/slo"):
        scrapes.labels(path="/slo").inc()
        if slo_doc is None:
            return (b"404 Not Found", b"text/plain",
                    b"no serving plane mounted\n")
        return (b"200 OK", b"application/json",
                json.dumps(slo_doc()).encode())
    return (b"404 Not Found", b"text/plain",
            b"try /metrics /metrics.json /healthz /progress /slo\n")


def _render(status: bytes, ctype: bytes, body: bytes) -> bytes:
    return (b"HTTP/1.0 " + status + b"\r\nContent-Type: " + ctype
            + b"\r\nContent-Length: " + str(len(body)).encode()
            + b"\r\n\r\n" + body)


class MetricsServer:
    """The responder on a daemon thread with its own socket loop, for a
    synchronous host. `port=0` binds an ephemeral port; `.port` reports
    the bound one. `close()` stops the thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry=None, live_doc=None, slo_doc=None):
        self.registry = registry
        self.live_doc = live_doc
        self.slo_doc = slo_doc
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self._sock.settimeout(0.5)  # the bound on close()'s latency
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="oct-metrics-http", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # the socket was closed under us
            try:
                conn.settimeout(5.0)
                data = b""
                while b"\r\n\r\n" not in data and b"\n\n" not in data:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                parts = data.split(None, 2)
                path = (parts[1].decode("ascii", "replace")
                        if len(parts) > 1 else "/")
                conn.sendall(_render(*handle_path(
                    path, self.registry, self.live_doc, self.slo_doc
                )))
            except OSError:
                pass  # a broken scrape never breaks the host
            except Exception:  # noqa: BLE001 — and neither does a
                # handler bug: count it, answer 500, keep serving
                self._note_handler_error(conn)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _note_handler_error(self, conn) -> None:
        reg = (self.registry if self.registry is not None
               else default_registry())
        reg.counter(
            "oct_metrics_scrape_errors_total", "scrape-handler failures"
        ).inc()
        try:
            conn.sendall(_render(b"500 Internal Server Error",
                                 b"text/plain", b"scrape handler error\n"))
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)

