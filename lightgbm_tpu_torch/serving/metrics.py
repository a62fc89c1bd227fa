"""Serving metrics: latency quantiles, queue depth, cache and capture counts.

The port of ``lightgbm_tpu/serving/metrics.py``. Backed by the
process-wide metrics registry (``obs/registry.py``): every
``ServingMetrics`` owns a labelled slice (``sink="serving-N"``) of shared
``lgbm_serving_*`` series, so the Prometheus exposition (serving
``/metrics/prometheus``) and this class's JSON snapshots read the same
counters. The snapshot keeps the JAX package's schema, so ``/metrics`` and
``/stats`` read the same keys; request latency is a Prometheus histogram
(``lgbm_serving_request_latency_ms_bucket``).

Two sources of truth for "did serving build anything after warmup":

- the predictor cache's own miss counter (every miss builds a bucketed
  predictor entry), and
- the process-wide count of CUDA-graph captures (``backend_compile_count``,
  ``lgbm_serving_graph_captures_total``), where the JAX package counts XLA
  backend compiles: the snapshot's ``backend_compiles`` and
  ``recompiles_after_warmup`` read captures. An entry on the card captures
  its graphs on its first call; on the CPU entries run eagerly, capture
  nothing, and only the cache misses count.

Snapshots export as JSON (one object) or JSON-lines (append per snapshot).
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Dict

import numpy as np

from ..obs.registry import get_registry

_sink_seq = itertools.count()
_c_captures = get_registry().counter(
    "lgbm_serving_graph_captures_total",
    "CUDA graphs captured by serving predictor entries (process-wide).")


def backend_compile_count() -> int:
    """CUDA graphs captured by serving in this process so far."""
    return int(_c_captures.value)


def record_graph_capture() -> None:
    """Count one CUDA-graph capture (called by the predictor entries)."""
    _c_captures.inc()


def latency_summary(samples_ms) -> Dict[str, float]:
    """Quantile summary of a latency sample window (milliseconds): the
    serving-side p50/p90/p99 view (``lightgbm_tpu/profiling.py:122``)."""
    a = np.asarray(list(samples_ms), np.float64)
    if a.size == 0:
        return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p90_ms": 0.0,
                "p99_ms": 0.0, "max_ms": 0.0}
    p50, p90, p99 = np.percentile(a, [50.0, 90.0, 99.0])
    return {"count": int(a.size), "mean_ms": round(float(a.mean()), 4),
            "p50_ms": round(float(p50), 4), "p90_ms": round(float(p90), 4),
            "p99_ms": round(float(p99), 4),
            "max_ms": round(float(a.max()), 4)}


class ServingMetrics:
    """Aggregated serving counters + a bounded latency window."""

    # sub-ms to multi-second: wide enough for a warm padded-batch predict
    # (sub-ms..ms) and a queue-inclusive cold request (seconds)
    LATENCY_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                          250.0, 500.0, 1000.0, 2500.0, 5000.0)
    # device predict latency per shape bucket: finer at the low end —
    # a warm traversal pass is sub-ms to ms
    PREDICT_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                          50.0, 100.0, 250.0, 1000.0)

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._t0 = time.time()
        reg = get_registry()
        # per-instance label: each engine/test gets independent series
        # while one scrape of the global registry still sees them all
        lbl = {"sink": "serving-%d" % next(_sink_seq)}
        self._lbl = dict(lbl)
        self._c_requests = reg.counter(
            "lgbm_serving_requests_total", "Prediction requests served.",
            labels=lbl)
        self._c_rows = reg.counter(
            "lgbm_serving_rows_total", "Prediction rows served.", labels=lbl)
        self._c_batches = reg.counter(
            "lgbm_serving_batches_total",
            "Padded forward passes dispatched.", labels=lbl)
        self._c_cache_hits = reg.counter(
            "lgbm_serving_predictor_cache_hits_total",
            "Predictor cache hits.", labels=lbl)
        self._c_cache_misses = reg.counter(
            "lgbm_serving_predictor_cache_misses_total",
            "Predictor cache misses (== entries built).",
            labels=lbl)
        self._c_errors = reg.counter(
            "lgbm_serving_errors_total", "Failed requests.", labels=lbl)
        self._g_queue = reg.gauge(
            "lgbm_serving_queue_depth",
            "Micro-batch queue depth in REQUESTS (gauge, set by the batch "
            "queue).", labels=lbl)
        # queue depth in ROWS: dispatch sizing and the admission bound
        # (serve_max_queue_rows) are row-based; a queue of 3 requests can
        # be 3 rows or 12288 — report both
        self._g_queue_rows = reg.gauge(
            "lgbm_serve_queue_rows",
            "Micro-batch queue depth in ROWS (gauge; the admission bound "
            "serve_max_queue_rows applies to this).", labels=lbl)
        self._c_shed = reg.counter(
            "lgbm_serving_shed_total",
            "Requests shed by bounded admission or open circuit breaker.",
            labels=lbl)
        self._c_timeouts = reg.counter(
            "lgbm_serving_request_timeouts_total",
            "Requests expired past their per-request deadline before "
            "dispatch.", labels=lbl)
        self._c_rollbacks = reg.counter(
            "lgbm_serving_rollbacks_total",
            "Hot-rolls refused by canary validation (prior generation "
            "kept live).", labels=lbl)
        # request latency is a HISTOGRAM (cumulative le-buckets), not a
        # summary: bucket counts aggregate across serving processes and
        # scrape intervals, which windowed quantiles cannot — Summary
        # stays the right tool for in-process span timings.  The JSON
        # snapshot keeps its p50/p90/p99 schema from a local window.
        self._h_latency = reg.histogram(
            "lgbm_serving_request_latency_ms",
            "Request latency (milliseconds, queue-inclusive for batched "
            "callers).", labels=lbl, buckets=self.LATENCY_BUCKETS_MS)
        self._lat_window = collections.deque(maxlen=window)
        self._batch_rows = collections.deque(maxlen=window)
        self._bucket_hist: Dict[int, object] = {}   # bucket -> Histogram
        self._compile_floor = 0          # graph captures at warmup end
        self._miss_floor = 0             # cache misses at warmup end
        self._warmup_credit_compiles = 0  # hot-roll prewarm captures
        self._warmup_credit_misses = 0

    # ------------------------------------------------------------ views
    # historical attribute API, now reading the registry-backed series
    @property
    def requests(self) -> int:
        return int(self._c_requests.value)

    @property
    def rows(self) -> int:
        return int(self._c_rows.value)

    @property
    def batches(self) -> int:
        return int(self._c_batches.value)

    @property
    def cache_hits(self) -> int:
        return int(self._c_cache_hits.value)

    @property
    def cache_misses(self) -> int:
        return int(self._c_cache_misses.value)

    @property
    def errors(self) -> int:
        return int(self._c_errors.value)

    @property
    def queue_depth(self) -> int:
        return int(self._g_queue.value)

    @property
    def queue_rows(self) -> int:
        return int(self._g_queue_rows.value)

    @property
    def shed(self) -> int:
        return int(self._c_shed.value)

    @property
    def request_timeouts(self) -> int:
        return int(self._c_timeouts.value)

    @property
    def rollbacks(self) -> int:
        return int(self._c_rollbacks.value)

    # ------------------------------------------------------------ recording
    def record_request(self, rows: int, latency_s: float) -> None:
        self._c_requests.inc()
        self._c_rows.inc(rows)
        ms = latency_s * 1000.0
        self._h_latency.observe(ms)
        with self._lock:
            self._lat_window.append(ms)

    def record_batch(self, rows: int) -> None:
        self._c_batches.inc()
        with self._lock:
            self._batch_rows.append(rows)

    def record_bucket_latency(self, bucket: int, ms: float) -> None:
        """Device predict latency for one padded forward pass, keyed by
        its shape bucket (``lgbm_serving_predict_latency_ms`` histogram
        with a ``bucket`` label; the per-bucket p50/p99 view is
        ``bucket_latency()``)."""
        with self._lock:
            h = self._bucket_hist.get(bucket)
            if h is None:
                lbl = dict(self._lbl)
                lbl["bucket"] = str(int(bucket))
                h = get_registry().histogram(
                    "lgbm_serving_predict_latency_ms",
                    "Device predict latency per shape bucket "
                    "(milliseconds, padded forward pass only).",
                    labels=lbl, buckets=self.PREDICT_BUCKETS_MS)
                self._bucket_hist[bucket] = h
        h.observe(ms)

    def bucket_latency(self) -> Dict[str, Dict[str, float]]:
        """``{bucket: {count, p50_ms, p99_ms}}`` estimated from the
        per-bucket histogram counts (obs Histogram.quantile)."""
        with self._lock:
            hists = sorted(self._bucket_hist.items())
        return {str(b): {"count": int(h.count),
                         "p50_ms": round(h.quantile(0.5), 4),
                         "p99_ms": round(h.quantile(0.99), 4)}
                for b, h in hists}

    def record_cache(self, hit: bool) -> None:
        (self._c_cache_hits if hit else self._c_cache_misses).inc()

    def record_error(self) -> None:
        self._c_errors.inc()

    def set_queue_depth(self, depth: int) -> None:
        self._g_queue.set(depth)

    def set_queue_rows(self, rows: int) -> None:
        self._g_queue_rows.set(rows)

    def record_shed(self) -> None:
        self._c_shed.inc()

    def record_timeout(self) -> None:
        self._c_timeouts.inc()

    def record_rollback(self) -> None:
        self._c_rollbacks.inc()

    def mark_warmup_done(self) -> None:
        """Anchor the capture counter: captures past this point are
        "recompiles" (the zero-recompiles-after-warmup check)."""
        with self._lock:
            self._compile_floor = backend_compile_count()
            self._miss_floor = self.cache_misses
            self._warmup_credit_compiles = 0
            self._warmup_credit_misses = 0

    def add_warmup_credit(self, compiles: int, misses: int) -> None:
        """Raise the capture/miss floors for captures a hot-roll prewarm
        paid OFF the request path (ServingEngine.prewarm_bundle): they are
        warmup work for the next model generation, not serving
        recompiles. Tracked separately so snapshots show how much credit
        was granted."""
        with self._lock:
            self._compile_floor += int(compiles)
            self._miss_floor += int(misses)
            self._warmup_credit_compiles += int(compiles)
            self._warmup_credit_misses += int(misses)

    def recompiles_after_warmup(self) -> int:
        with self._lock:
            return backend_compile_count() - self._compile_floor

    def cache_misses_after_warmup(self) -> int:
        with self._lock:
            return self.cache_misses - self._miss_floor

    # ------------------------------------------------------------ export
    def snapshot(self) -> Dict:
        by_bucket = self.bucket_latency()
        # copy the windows under the lock; the percentile math, dict
        # build and (at the caller) JSON serialization all run OUTSIDE
        # it: record_request() on the hot path must never wait on a
        # stats scrape
        with self._lock:
            lat_window = list(self._lat_window)
            batch_rows = list(self._batch_rows)
            compile_floor = self._compile_floor
            credit_compiles = self._warmup_credit_compiles
            credit_misses = self._warmup_credit_misses
        lat = latency_summary(lat_window)
        rows_per_batch = float(sum(batch_rows)) / max(len(batch_rows), 1)
        return {
            "ts": round(time.time(), 3),
            "uptime_s": round(time.time() - self._t0, 3),
            "requests": self.requests,
            "rows": self.rows,
            "batches": self.batches,
            "rows_per_batch": round(rows_per_batch, 2),
            "queue_depth": self.queue_depth,
            "queue_rows": self.queue_rows,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "errors": self.errors,
            "shed": self.shed,
            "request_timeouts": self.request_timeouts,
            "rollbacks": self.rollbacks,
            "backend_compiles": backend_compile_count(),
            "recompiles_after_warmup":
                backend_compile_count() - compile_floor,
            "warmup_credit_compiles": credit_compiles,
            "warmup_credit_misses": credit_misses,
            "latency_ms": lat,
            "predict_latency_ms_by_bucket": by_bucket,
            }

    def write_jsonl(self, path_or_fh) -> Dict:
        """Append one snapshot as a JSON line; returns the snapshot."""
        snap = self.snapshot()
        line = json.dumps(snap, sort_keys=True) + "\n"
        if hasattr(path_or_fh, "write"):
            path_or_fh.write(line)
            path_or_fh.flush()
        else:
            with open(path_or_fh, "a") as fh:
                fh.write(line)
        return snap
