"""Lightweight stats HTTP endpoint for training-time scraping.

The port's own copy of ``lightgbm_tpu/obs/server.py``. A daemon-threaded
``ThreadingHTTPServer`` that exposes the process-wide metrics registry
while a training run is live:

- ``GET /metrics``  -> Prometheus text exposition (0.0.4)
- ``GET /stats``    -> JSON snapshot of every registered series
- ``GET /healthz``  -> ``{"status": "ok"|"anomalous", "anomalies": N}``
- ``GET /roofline`` -> roofline attribution (obs/costmodel.py): the
  bytes and additions of the port's kernel launches, joined with span
  wall times, against the card's published peaks
- ``GET /metrics/cluster`` / ``GET /stats/cluster`` -> the federated
  cluster view. The port trains on one process, where these are
  exactly the local ``/metrics`` / ``/stats`` bodies (the JAX package's
  one-process case); ``set_cluster`` wires another provider.
- ``GET /slo``      -> SLO burn-rate judgment (obs/slo.py): every
  declared objective's fast/slow-window burn rate and burning flag, or
  ``{"status": "disabled"}`` when no SLO engine is wired here.
- ``GET /drift``    -> per-model train/serve drift status (obs/drift.py):
  every registered DriftMonitor's PSI/JS per feature + score sketch, or
  ``{"status": "no_profile"}`` when nothing monitors drift here.  The
  per-feature numbers also live in the registry as ``lgbm_drift_*``
  gauges, so the cluster routes federate them automatically.

Enabled via ``obs_stats_port`` (>= 0; 0 binds an OS-assigned port whose
number is exported in ``StatsServer.port`` and logged).  A busy port is
not fatal: the constructor catches ``EADDRINUSE`` and falls back to an
ephemeral port with a warning — a stale scraper or a second trainer on
the same host must never kill training startup.  The server binds
127.0.0.1 only — it is a diagnostics tap, not a service surface — and
shares nothing mutable with the training loop beyond the thread-safe
registry, so scrapes never block an iteration.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..log import Log
from .registry import MetricsRegistry, get_registry


class _Handler(BaseHTTPRequestHandler):
    server_version = "lgbm-obs/0.1"

    # class attributes bound by StatsServer.start()
    registry: MetricsRegistry = None
    anomaly_counter = None
    cluster = None   # DistributedObs (or None): set via set_cluster()
    slo = None       # SloEngine (or None): set via set_slo()

    def log_message(self, fmt, *args):  # quiet: route through our logger
        Log.debug("obs.server: " + fmt % args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        try:
            if self.path == "/metrics":
                body = self.registry.prometheus_text().encode()
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics/cluster":
                text = (self.cluster.cluster_prometheus()
                        if self.cluster is not None
                        else self.registry.prometheus_text())
                self._send(200, text.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/stats/cluster":
                snap = (self.cluster.cluster_stats()
                        if self.cluster is not None
                        else self.registry.snapshot())
                self._send(200, json.dumps(snap, sort_keys=True).encode(),
                           "application/json")
            elif self.path == "/stats":
                body = json.dumps(self.registry.snapshot(),
                                  sort_keys=True).encode()
                self._send(200, body, "application/json")
            elif self.path == "/healthz":
                n = (int(self.anomaly_counter.value)
                     if self.anomaly_counter is not None else 0)
                body = json.dumps({
                    "status": "ok" if n == 0 else "anomalous",
                    "anomalies": n,
                }).encode()
                self._send(200, body, "application/json")
            elif self.path == "/drift":
                # lazy import mirrors /roofline: the route reads the
                # process-wide monitor registry, populated by serving (or
                # anything that register_monitor()s)
                from .drift import drift_snapshot
                self._send(200, json.dumps(drift_snapshot(),
                                           sort_keys=True).encode(),
                           "application/json")
            elif self.path == "/slo":
                body = (self.slo.status() if self.slo is not None
                        else {"status": "disabled", "slos": {}})
                self._send(200, json.dumps(body, sort_keys=True).encode(),
                           "application/json")
            elif self.path == "/roofline":
                # lazy import: the cost model reads torch only inside
                # functions, and the server stays importable without it
                from .costmodel import roofline_snapshot
                body = json.dumps(
                    roofline_snapshot(registry=self.registry),
                    sort_keys=True).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b'{"error": "not found"}',
                           "application/json")
        except Exception as e:  # never kill the scrape thread
            try:
                self._send(500, json.dumps({"error": str(e)}).encode(),
                           "application/json")
            except Exception:
                pass


class StatsServer:
    """Own one bound socket + serving thread; ``stop()`` is idempotent."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None else get_registry()
        handler = type("BoundStatsHandler", (_Handler,), {
            "registry": self._registry,
            "anomaly_counter": self._registry.counter(
                "lgbm_train_health_anomalies_total",
                "Non-finite grad/hess or gain anomalies detected in "
                "training."),
        })
        try:
            self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        except OSError as e:
            # EADDRINUSE (or any bind failure) on a diagnostics port must
            # not kill training startup — fall back to an OS-assigned
            # port and say where we actually landed
            Log.warning("obs: stats port %d unavailable (%s); falling "
                        "back to an ephemeral port" % (int(port), e))
            self._httpd = ThreadingHTTPServer((host, 0), handler)
        self._httpd.daemon_threads = True
        self._handler = handler
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def set_cluster(self, provider) -> None:
        """Wire the ``/metrics/cluster`` + ``/stats/cluster`` routes to a
        DistributedObs (anything with ``cluster_prometheus()`` /
        ``cluster_stats()``).  Without a provider the routes serve the
        local registry — the single-process degenerate case."""
        self._handler.cluster = provider

    def set_slo(self, engine) -> None:
        """Wire ``/slo`` to an obs.slo.SloEngine (anything with
        ``status()``); without one the route reports disabled."""
        self._handler.slo = engine

    def start(self) -> "StatsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="lgbm-obs-stats", daemon=True)
        self._thread.start()
        Log.info("obs: stats endpoint on http://%s:%d (metrics/stats/"
                 "healthz/roofline/drift)" % (self.host, self.port))
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()
