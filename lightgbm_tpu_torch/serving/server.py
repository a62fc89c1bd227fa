"""Serving front-ends: HTTP (stdlib ThreadingHTTPServer) and JSON-lines stdin.

The port of ``lightgbm_tpu/serving/server.py``. The wire layer is thin:
parse JSON, hand rows to the MicroBatchQueue, serialize the Future's
result. Bucketing, CUDA graphs and metrics live in the engine underneath
and are shared by both transports and by in-process callers.

HTTP API:
  POST /predict   {"model": "...", "data": [[...], ...],
                   "raw_score": false, "num_iteration": null}
                  -> {"model": ..., "rows": N, "predictions": [...]}
  GET  /metrics   one ServingMetrics snapshot
  GET  /metrics/prometheus   process-wide metrics registry, Prometheus
                  text exposition 0.0.4
  GET  /healthz   {"status": "ok", "models": [...], "drift": "ok"|"warn"|
                   "no_profile"|"disabled", "breaker": {...}}
  GET  /stats     the metrics snapshot with the breaker and queue state
                  (the QoS policy's per-model block), the cascade
                  autotuner's state and this replica's announced document
  GET  /metrics/cluster, /stats/cluster   the fleet's merged replica
                  documents (``fleet_kv_dir``; the local registry and an
                  empty fleet without one)
  GET  /drift     per-model train/serve drift detail
  GET  /slo       burn-rate verdicts per declared SLO (obs/slo.py):
                  {"slos": {...}}, or {"status": "disabled"} without one
  GET  /traces    the recently KEPT request traces (tail sampling) with
                  their span records; obs_trace=true only, else empty
  GET  /models    registered model ids and shapes

POST /predict honors an inbound ``x-lgbm-trace: <trace_id>[-<span_id>]``
header (obs/reqtrace.py), so fleet peers and load generators keep one
trace id across hops. ``obs_trace`` traces each request (one root span a
request, its queue wait, the batch that carried it, the engine pass and
its copies around the graph's replay; ``obs_trace_sample``,
``obs_trace_slow_ms``; kept spans also go to ``obs_event_file``);
``serve_slo_p99_ms`` (with ``serve_slo_target``) and
``serve_slo_availability`` declare the SLOs ``/slo`` judges.

stdin mode (``serve_stdin=true``) speaks the same request objects, one
JSON object per line, and replies one JSON line each.

``checkpoint_dir`` attaches a ``CheckpointWatcher`` to model "default": it
rolls the directory's newest valid snapshot in at boot and every
WATCH_POLL_S seconds after, through the guarded roll, and at once on a
drift warn. ``fault_inject`` arms its plan (``serve_error``,
``serve_delay`` at each dispatched predict, which the breaker counts).

The fleet (``fleet/``), each part optional: ``serve_qos_weights`` /
``serve_qos_quota_rows`` put a ``QosPolicy`` on the queue;
``serve_latency_budget_ms`` starts the ``CascadeAutotuner``;
``fleet_kv_dir`` makes the process a replica named ``fleet_replica`` that
announces itself every ``fleet_announce_period_s`` and, with
``checkpoint_dir``, rolls the directory's snapshots in turn with the other
replicas (``RollingDeployCoordinator``, which then drives the watcher).
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..config import Config
from ..log import LightGBMError, Log, OverloadedError
from ..obs.registry import get_registry
from ..obs.reqtrace import TRACE_HEADER
from ..resilience.breaker import CircuitBreaker
from .batching import MicroBatchQueue
from .metrics import ServingMetrics
from .predictor import ServingEngine, bucket_sizes

# seconds between the checkpoint watcher's polls (the JAX package's
# default poll interval)
WATCH_POLL_S = 10.0


def _predictions_payload(model_id: str, out: np.ndarray) -> Dict:
    return {"model": model_id, "rows": int(np.asarray(out).shape[0]),
            "predictions": np.asarray(out).tolist()}


class ServingApp:
    """Engine + queue + registry bound together for a transport to drive.

    The circuit breaker sits BETWEEN validation and dispatch: client
    errors (missing data, unknown model, bad width) are classified before
    the queue and never count as failures; only dispatch failures (the
    engine itself is sick) advance the breaker. An open breaker rejects
    fast with OverloadedError carrying the Retry-After hint; transports
    map that to 503."""

    def __init__(self, engine: ServingEngine,
                 queue: Optional[MicroBatchQueue] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.engine = engine
        self.queue = queue if queue is not None else MicroBatchQueue(engine)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.watcher = None        # serving.registry.CheckpointWatcher
        self.tuner = None          # fleet.qos.CascadeAutotuner
        self.announcer = None      # fleet.replica.ReplicaAnnouncer
        self.coordinator = None    # fleet.replica.RollingDeployCoordinator
        self.cluster = None        # fleet.replica.FleetClusterProvider
        self.tracer = None         # obs.reqtrace.RequestTracer
        self.slo = None            # obs.slo.SloEngine
        self.trace_events = None   # EventStream owned by build_app
        self.queue.start()

    # ------------------------------------------------------------ requests
    def handle_predict(self, req: Dict, trace: Optional[str] = None) -> Dict:
        model_id = req.get("model", "")
        if not model_id:
            ids = self.engine.registry.ids()
            if len(ids) != 1:
                raise LightGBMError(
                    "request must name a model (registered: %s)" % ids)
            model_id = ids[0]
        data = req.get("data")
        if data is None:
            raise LightGBMError('request is missing "data"')
        # client-side validation BEFORE the breaker/queue: an unknown
        # model or wrong width is the caller's fault, not engine sickness
        self.engine.registry.get(model_id)
        X = np.asarray(data, np.float64)
        if not self.breaker.allow():
            self.engine.metrics.record_shed()
            raise OverloadedError(
                "circuit breaker open (%d consecutive dispatch failures); "
                "retry in %.1fs"
                % (self.breaker.failure_threshold,
                   self.breaker.retry_after_s()),
                retry_after_s=max(self.breaker.retry_after_s(), 0.1))
        try:
            out = self.queue.predict(
                model_id, X, raw_score=bool(req.get("raw_score", False)),
                num_iteration=req.get("num_iteration"), trace=trace)
        except OverloadedError:
            raise          # admission shed: not an engine failure
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return _predictions_payload(model_id, out)

    def handle_models(self) -> Dict:
        models = []
        for mid in self.engine.registry.ids():
            b = self.engine.registry.get(mid)
            models.append({"model": mid, "num_features": b.num_features,
                           "num_class": b.num_class,
                           "iterations": b.total_iterations})
        return {"models": models}

    def close(self) -> None:
        for part in (self.coordinator, self.announcer, self.tuner):
            if part is not None:
                part.stop()
        if self.watcher is not None:
            self.watcher.stop()
        if self.slo is not None:
            self.slo.stop()
        self.queue.stop()
        if self.trace_events is not None:
            self.trace_events.close()


class _Handler(BaseHTTPRequestHandler):
    app: ServingApp = None  # type: ignore[assignment]  # bound by make_server

    def log_message(self, fmt, *args):  # route through our logger, not stderr
        Log.debug("serve: " + fmt, *args)

    def _reply(self, code: int, payload: Dict,
               retry_after_s: Optional[float] = None) -> None:
        self._reply_raw(code, json.dumps(payload).encode("utf-8"),
                        "application/json", retry_after_s=retry_after_s)

    def _reply_raw(self, code: int, body: bytes, ctype: str,
                   retry_after_s: Optional[float] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if retry_after_s is not None:
            self.send_header("Retry-After",
                             str(max(int(round(retry_after_s)), 1)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_prometheus(self) -> None:
        self._reply_raw(200, get_registry().prometheus_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path == "/healthz":
            brk = self.app.breaker.snapshot()
            code = 200 if brk["state"] != "open" else 503
            # drift is advisory: a drifted model still answers correctly
            # for its training distribution, so "warn" never turns the
            # probe 503
            self._reply(code, {"status": "ok" if code == 200 else "degraded",
                               "models": self.app.engine.registry.ids(),
                               "drift":
                                   self.app.engine.drift_status()["status"],
                               "breaker": brk})
        elif self.path == "/stats":
            snap = self.app.engine.metrics.snapshot()
            snap["breaker"] = self.app.breaker.snapshot()
            snap["queue"] = self.app.queue.stats()
            if self.app.tuner is not None:
                snap["cascade_autotune"] = self.app.tuner.snapshot()
            if self.app.announcer is not None:
                # the whole announced document: what THIS replica tells
                # the fleet (snap_id, rejections, digest)
                snap["replica"] = self.app.announcer.state()
            self._reply(200, snap)
        elif self.path == "/metrics/prometheus" or (
                self.path == "/metrics/cluster" and self.app.cluster is None):
            # without a fleet the cluster view is the local registry
            self._reply_prometheus()
        elif self.path == "/metrics/cluster":
            self._reply_raw(200, self.app.cluster.cluster_prometheus()
                            .encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/stats/cluster":
            self._reply(200, self.app.cluster.cluster_stats()
                        if self.app.cluster is not None
                        else {"fleet": {"replicas": 0, "live": 0},
                              "replicas": {}})
        elif self.path == "/metrics":
            self._reply(200, self.app.engine.metrics.snapshot())
        elif self.path == "/drift":
            from ..obs.drift import drift_snapshot
            self._reply(200, drift_snapshot())
        elif self.path == "/slo":
            self._reply(200, self.app.slo.status() if self.app.slo is not None
                        else {"status": "disabled", "slos": {}})
        elif self.path == "/traces":
            # the most recent KEPT traces (tail sampling), newest last
            self._reply(200, {"traces": self.app.tracer.recent_traces()
                              if self.app.tracer is not None else []})
        elif self.path == "/models":
            self._reply(200, self.app.handle_models())
        else:
            self._reply(404, {"error": "unknown path %r" % self.path})

    def do_POST(self):  # noqa: N802 - http.server API
        if self.path != "/predict":
            self._reply(404, {"error": "unknown path %r" % self.path})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            # an inbound trace context continues the caller's trace; an
            # absent or malformed header mints a fresh one
            self._reply(200, self.app.handle_predict(
                req, trace=self.headers.get(TRACE_HEADER)))
        except OverloadedError as e:
            # shed (bounded admission) or breaker-open: 503 + Retry-After
            self._reply(503, {"error": str(e),
                              "retry_after_s": e.retry_after_s},
                        retry_after_s=e.retry_after_s)
        except (LightGBMError, ValueError, KeyError) as e:
            self.app.engine.metrics.record_error()
            self._reply(400, {"error": str(e)})


def make_server(app: ServingApp, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (not yet serving); port 0 lets the OS pick (read
    ``server.server_address``)."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


def serve_stdin(app: ServingApp, in_stream=None, out_stream=None) -> int:
    """One JSON request per line in, one JSON reply per line out; blank
    line or EOF ends the session. Returns requests served."""
    import sys
    in_stream = in_stream if in_stream is not None else sys.stdin
    out_stream = out_stream if out_stream is not None else sys.stdout
    served = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            break
        try:
            reply = app.handle_predict(json.loads(line))
        except OverloadedError as e:
            reply = {"error": str(e), "overloaded": True,
                     "retry_after_s": e.retry_after_s}
        except (LightGBMError, ValueError, KeyError) as e:
            app.engine.metrics.record_error()
            reply = {"error": str(e)}
        out_stream.write(json.dumps(reply) + "\n")
        out_stream.flush()
        served += 1
    return served


def _metrics_writer(metrics: ServingMetrics, path: str, freq_s: float,
                    stop: threading.Event) -> threading.Thread:
    def loop():
        while not stop.wait(max(freq_s, 0.1)):
            metrics.write_jsonl(path)
    t = threading.Thread(target=loop, name="lgbm-serve-metrics", daemon=True)
    t.start()
    return t


def build_app(config: Config) -> ServingApp:
    """Engine + queue from the serve_* config on ``device_type``'s device
    (CUDA unless it says ``cpu``); loads ``input_model`` (if any) under id
    "default", then, with ``checkpoint_dir``, the directory's newest valid
    snapshot over it and a watcher polling for newer ones. Tests and
    embedders register models themselves."""
    from ..cli import device_of
    if config.fault_inject:
        from ..resilience import faults
        faults.install_plan(config.fault_inject, config.fault_seed)
    engine = ServingEngine(
        max_batch=config.serve_max_batch, min_bucket=config.serve_min_bucket,
        num_devices=config.serve_num_devices,
        backend=config.serving_backend,
        cascade_trees=config.serving_cascade_trees,
        cascade_margin=config.serving_cascade_margin,
        quantize_leaves=config.serving_quantize_leaves,
        guard_hot_roll=config.serve_guard_hot_roll,
        canary_rows=config.serve_canary_rows,
        roll_max_latency_ms=config.serve_roll_max_latency_ms,
        drift=config.serve_drift,
        drift_warn_psi=config.obs_drift_warn_psi,
        drift_min_rows=config.obs_drift_min_rows,
        drift_decay=config.obs_drift_decay, device=device_of(config))
    if config.input_model:
        engine.registry.load_file("default", config.input_model)
    qos = None
    if config.serve_qos_weights or config.serve_qos_quota_rows:
        from ..fleet.qos import QosPolicy
        qos = QosPolicy.from_spec(config.serve_qos_weights,
                                  config.serve_qos_quota_rows)
    tracer = trace_events = None
    if config.obs_trace:
        from ..obs.reqtrace import RequestTracer
        from ..obs.trace import EventStream
        if config.obs_event_file:
            trace_events = EventStream(
                config.obs_event_file,
                static_fields={"source": "serve",
                               "replica": config.fleet_replica or ""})
        tracer = RequestTracer(events=trace_events,
                               slow_ms=config.obs_trace_slow_ms,
                               sample=config.obs_trace_sample,
                               seed=config.seed)
    app = ServingApp(
        engine,
        MicroBatchQueue(engine, deadline_ms=config.serve_deadline_ms,
                        max_queue_rows=config.serve_max_queue_rows,
                        request_timeout_ms=config.serve_request_timeout_ms,
                        qos=qos, tracer=tracer),
        breaker=CircuitBreaker(
            failure_threshold=config.serve_breaker_failures,
            cooldown_s=config.serve_breaker_cooldown_s))
    app.tracer = tracer
    app.trace_events = trace_events
    if config.serve_slo_p99_ms > 0 or config.serve_slo_availability > 0:
        from ..obs.slo import SloEngine
        slo = SloEngine(fast_window_s=config.slo_fast_window_s,
                        slow_window_s=config.slo_slow_window_s,
                        burn_warn=config.slo_burn_warn,
                        monitor=engine._drift_health())
        if config.serve_slo_p99_ms > 0:
            slo.add_latency_slo(
                "serve_p99", "lgbm_serving_request_latency_ms",
                threshold_ms=config.serve_slo_p99_ms,
                objective=config.serve_slo_target,
                description="fraction of requests under serve_slo_p99_ms")
        if config.serve_slo_availability > 0:
            slo.add_availability_slo(
                "serve_availability", "lgbm_serving_requests_total",
                bad=["lgbm_serving_errors_total",
                     "lgbm_serving_shed_total",
                     "lgbm_serving_request_timeouts_total"],
                objective=config.serve_slo_availability,
                description="requests neither errored, shed nor expired")
        app.slo = slo.start(config.slo_tick_s)
    if config.serve_latency_budget_ms > 0:
        from ..fleet.qos import CascadeAutotuner
        app.tuner = CascadeAutotuner(
            engine, config.serve_latency_budget_ms,
            interval_s=config.serve_qos_tune_interval_s).start()
    if config.checkpoint_dir:
        app.watcher = engine.registry.watch_dir(
            "default", config.checkpoint_dir, poll_interval=WATCH_POLL_S,
            engine=engine)
        if not config.fleet_kv_dir:
            app.watcher.poll()
            app.watcher.start()
    if config.fleet_kv_dir:
        from ..fleet.replica import (FileKvClient, FleetClusterProvider,
                                     ReplicaAnnouncer,
                                     RollingDeployCoordinator)
        client = FileKvClient(config.fleet_kv_dir)
        replica = config.fleet_replica or ("replica-%d" % os.getpid())
        app.announcer = ReplicaAnnouncer(
            client, replica, engine=engine, watcher=app.watcher,
            period_s=config.fleet_announce_period_s).start()
        if app.watcher is not None:
            # the coordinator DRIVES the watcher (one replica rolls at a
            # time): the watcher's own poll thread stays off, and the
            # first roll waits for the replicas before this one
            app.coordinator = RollingDeployCoordinator(
                client, app.announcer, app.watcher)
            app.coordinator.step()
            app.coordinator.start()
        app.cluster = FleetClusterProvider(client)
    return app


def run_server(config: Config, params: Optional[Dict] = None) -> int:
    """cli.py task=serve entry: boot, warm every bucket, serve until EOF
    (stdin mode) or interrupt (HTTP mode)."""
    if not config.input_model and not config.checkpoint_dir:
        raise LightGBMError("No model: pass input_model=<file> or "
                            "checkpoint_dir=<dir>")
    app = build_app(config)
    engine = app.engine
    if config.serve_warmup:
        warmed = engine.warmup()
        Log.info("serve: warmed %d predictor entries (buckets %s)",
                 warmed, ",".join(str(b) for b in
                                  bucket_sizes(engine.min_bucket,
                                               engine.max_batch)))
    stop = threading.Event()
    if config.serve_metrics_file:
        _metrics_writer(engine.metrics, config.serve_metrics_file,
                        config.serve_metrics_freq, stop)
    try:
        if config.serve_stdin:
            served = serve_stdin(app)
            Log.info("serve: stdin session done, %d requests", served)
            return 0
        server = make_server(app, config.serve_host, config.serve_port)
        Log.info("serve: listening on http://%s:%d (pid %d)",
                 server.server_address[0], server.server_address[1],
                 os.getpid())
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            Log.info("serve: interrupted, shutting down")
        finally:
            server.server_close()
        return 0
    finally:
        stop.set()
        if config.serve_metrics_file:
            engine.metrics.write_jsonl(config.serve_metrics_file)
        app.close()
