"""Scrape exporter: a background HTTP thread serving /metrics, /healthz
and JSON ``/debug/*`` views.

The port's own copy of ``paddle_tpu/observability/exporter.py`` (stdlib
``http.server``; the port imports nothing of the JAX package), reading
the same ``PADDLE_TPU_METRICS_PORT`` variable.

Opt-in (nothing listens unless started): construct a ``MetricsExporter`` or
call ``start_default_exporter()`` — the latter also honours the
``PADDLE_TPU_METRICS_PORT`` environment variable so a serving deployment
turns scraping on with no code change.  stdlib ``http.server`` only; one
daemon thread; ``stop()`` is deterministic (shutdown + close + join) so
tests can assert no leaked thread or socket.

``/healthz`` carries liveness detail a router can health-check replicas
on without parsing the full ``/metrics`` page: last-step age (seconds
since the newest ``serving_last_step_unixtime`` sample), current queue
depth and inflight dispatch count — all read from the gauges the engine
already maintains (summed across policy children; a field is null until
an engine registers the series).

``/debug/<name>`` endpoints are pluggable: pass ``debug_sources`` (a
``{name: zero-arg callable}`` map — the callable returns a
JSON-serializable object) at construction or via ``add_debug_source``.
The serving engine's ``debug_sources()`` provides ``requests`` (recent
request timelines), ``flightrecorder`` (the event ring + dump records)
and ``slo`` (windowed attainment/burn rates).  Provider callables run on
the scrape thread, so they must be thread-safe snapshots — the engine's
are.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from paddle_tpu_torch.observability.metrics import get_registry

__all__ = ["MetricsExporter", "start_default_exporter",
           "stop_default_exporter"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    # set per-server via the class attribute patch in MetricsExporter.start
    registry = None
    debug_sources = None   # {name: zero-arg callable} -> /debug/<name>

    def _send(self, code, body, ctype):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code, obj):
        self._send(code, json.dumps(obj, default=str), "application/json")

    def _gauge_values(self, name):
        """Values of every child of gauge family ``name`` (empty when the
        series is absent or not a gauge)."""
        m = self.registry.get(name)
        if m is None or getattr(m, "kind", None) != "gauge":
            return []
        return [s["value"] for s in m._snapshot()["series"]]

    def _health(self):
        """Liveness detail off the existing serving gauges (module
        docstring): null fields simply mean no engine has registered the
        series yet — the endpoint itself stays a 200."""
        h = {"status": "ok"}
        stamps = [v for v in
                  self._gauge_values("serving_last_step_unixtime") if v > 0]
        h["last_step_age_seconds"] = (time.time() - max(stamps)
                                      if stamps else None)
        depth = self._gauge_values("serving_queue_depth")
        h["queue_depth"] = sum(depth) if depth else None
        inflight = self._gauge_values("serving_inflight_steps")
        h["inflight_steps"] = sum(inflight) if inflight else None
        return h

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, self.registry.to_prometheus(),
                       PROMETHEUS_CONTENT_TYPE)
        elif path == "/healthz":
            self._send_json(200, self._health())
        elif path.startswith("/debug/"):
            src = (self.debug_sources or {}).get(path[len("/debug/"):])
            if src is None:
                self._send(404, "not found\n", "text/plain; charset=utf-8")
                return
            try:
                self._send_json(200, src())
            except Exception as e:  # a broken provider must not 500-loop
                #                     the scrape thread into a traceback
                self._send_json(500, {"error": type(e).__name__,
                                      "detail": str(e)})
        else:
            self._send(404, "not found\n", "text/plain; charset=utf-8")

    def log_message(self, *args):  # silence per-request stderr lines
        pass


class MetricsExporter:
    """Background scrape endpoint over one registry.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` after
    ``start()``); ``host`` defaults to loopback — exposing beyond the host
    is an explicit deployment decision.  Usable as a context manager.
    """

    def __init__(self, registry=None, host="127.0.0.1", port=0,
                 debug_sources=None):
        self._registry = registry if registry is not None else get_registry()
        self._host = host
        self._want_port = int(port)
        self._server = None
        self._thread = None
        # the dict object itself is shared with the bound handler class, so
        # add_debug_source takes effect live on a running server
        self._debug = {}
        for name, fn in (debug_sources or {}).items():
            self.add_debug_source(name, fn)

    def add_debug_source(self, name, fn):
        """Register ``fn`` (zero-arg, JSON-serializable return) under
        ``/debug/<name>``.  Works before or after ``start()``."""
        name = str(name)
        if not name or "/" in name:
            raise ValueError(f"invalid debug source name {name!r}")
        if not callable(fn):
            raise TypeError(f"debug source {name!r} must be callable")
        self._debug[name] = fn
        return self

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    @property
    def port(self):
        if self._server is None:
            return None
        return self._server.server_address[1]

    @property
    def url(self):
        return None if self._server is None else \
            f"http://{self._host}:{self.port}"

    def start(self):
        if self._server is not None:
            raise RuntimeError("exporter already started")
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": self._registry,
                        "debug_sources": self._debug})
        self._server = ThreadingHTTPServer((self._host, self._want_port),
                                           handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            name=f"paddle-tpu-metrics-exporter:{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Deterministic shutdown: stop serving, close the listening socket,
        join the thread.  Idempotent."""
        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=10)
            if thread.is_alive():  # pragma: no cover - defensive
                raise RuntimeError("exporter thread failed to stop")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


_default = None
_default_lock = threading.Lock()


def start_default_exporter(port=None, host="127.0.0.1"):
    """Start (once) the process-wide exporter over the default registry.

    ``port=None`` reads ``PADDLE_TPU_METRICS_PORT``; when that is unset too,
    this is a no-op returning None — the subsystem stays fully opt-in.
    Returns the running exporter (subsequent calls return the same one).
    """
    global _default
    with _default_lock:
        if _default is not None and _default.running:
            return _default
        if port is None:
            env = os.environ.get("PADDLE_TPU_METRICS_PORT")
            if not env:
                return None
            port = int(env)
        _default = MetricsExporter(host=host, port=port).start()
        return _default


def stop_default_exporter():
    global _default
    with _default_lock:
        if _default is not None:
            _default.stop()
            _default = None
