"""lightgbm_tpu_torch.obs: runtime telemetry of training and serving.

The port's own copy of the JAX package's ``lightgbm_tpu/obs/``, one
layer shared by training, checkpointing and serving:

- ``registry``: a process-wide, thread-safe counter/gauge/summary/
  histogram registry with Prometheus text exposition and JSON snapshots.
- ``costmodel``: the bytes and additions of the port's kernel launches,
  and roofline attribution against the card's published peaks
  (``GET /roofline``).
- ``trace``: host-side span timers (a device sync only at span close), a
  JSON-lines event stream, and a ``torch.profiler`` window over chosen
  iterations that writes a Chrome trace.
- ``health``: the device-side health vector (non-finite grad/hess, stump
  iterations, frontier waves and non-finite gains) and the host monitor
  that warns, checkpoints and aborts, or raises.
- ``reqtrace``: request-scoped span trees with tail-based sampling, one
  trace per admitted serving request (the ``x-lgbm-trace`` header) or per
  streamed training iteration.
- ``slo``: declarative SLOs judged as multi-window burn rates over
  registry metrics; ``/slo``, ``lgbm_slo_*`` gauges, warn-only monitor
  routing.
- ``server``: the training stats HTTP endpoint.
- ``distributed``: process identity, straggler skew, metric merging and
  the crash-dumping flight recorder. The JAX package's ``DistributedObs``
  needs several processes (ROADMAP Queue 1 #13).
- ``modelstats``: split-gain statistics and streaming importance from the
  host trees.
- ``drift``: train/serve drift monitors.
- ``runtime``: ``TrainingObs``, the per-booster facade built from
  ``observability=none|basic|full``.

Everything is off by default (``observability=none``): the training loop
then adds no launch, sync or allocation.
"""
from .costmodel import (CHIP_PEAKS, CostModel, detect_peaks,
                        get_cost_model, roofline_snapshot)
from .distributed import (FlightRecorder, merge_prometheus_texts,
                          process_env, straggler_skew)
from .drift import DataProfile, DriftMonitor, drift_snapshot
from .health import (HEALTH_NONFINITE, HEALTH_NONFINITE_GAIN, HEALTH_STUMP,
                     HEALTH_VEC_LEN, HEALTH_WAVES, HealthMonitor,
                     HealthReport, health_vec)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Summary,
                       get_registry)
from .reqtrace import (NULL_REQ_SPAN, NULL_TRACER, NullRequestTracer,
                       ReqSpan, RequestTracer, TRACE_HEADER,
                       format_trace_header, keep_decision, new_trace_id,
                       parse_trace_header)
from .runtime import TrainingObs, resolve_health_action
from .server import StatsServer
from .slo import SloEngine, SloSpec
from .trace import EventStream, Tracer, perfetto_trace, span

__all__ = ["CHIP_PEAKS", "CostModel", "Counter", "DataProfile",
           "DriftMonitor", "EventStream", "FlightRecorder", "Gauge",
           "HEALTH_NONFINITE", "HEALTH_NONFINITE_GAIN", "HEALTH_STUMP",
           "HEALTH_VEC_LEN", "HEALTH_WAVES", "HealthMonitor", "HealthReport",
           "Histogram", "MetricsRegistry", "NULL_REQ_SPAN", "NULL_TRACER",
           "NullRequestTracer", "ReqSpan", "RequestTracer", "SloEngine",
           "SloSpec", "StatsServer", "Summary", "TRACE_HEADER", "Tracer",
           "TrainingObs", "detect_peaks", "drift_snapshot",
           "format_trace_header", "get_cost_model", "get_registry",
           "health_vec", "keep_decision", "merge_prometheus_texts",
           "new_trace_id", "parse_trace_header", "perfetto_trace",
           "process_env", "resolve_health_action", "roofline_snapshot",
           "span", "straggler_skew"]
