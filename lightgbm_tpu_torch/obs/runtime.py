"""TrainingObs: the per-booster observability facade.

The port of ``lightgbm_tpu/obs/runtime.py``. Built once in
``GBDT._setup_train`` from the config knobs and handed to the boosting
loop, which drives it at three intensities:

- ``observability=none``  (level 0): every hook returns at once; the loop
  adds no launch, sync or allocation (``TrainingObs.disabled()`` when no
  health action is set either).
- ``observability=basic`` (level 1): ``train_many`` keeps its blocks of
  ``TRAIN_BLOCK`` iterations; the block's health rows go into one device
  buffer fetched once at its end, then one ``train_block`` span, one
  ``block`` event, the rows accounted and the device memory gauge set.
- ``observability=full``  (level 2): the loop dispatches one iteration at
  a time: a ``train_iter`` span, an ``iteration`` event and one fetch an
  iteration, health flagged within the iteration, the optional Perfetto
  window (a ``torch.profiler`` capture), device memory every iteration.

Health monitoring is orthogonal: ``health_monitor=auto`` enables it
whenever observability is on, and ``callback.health_monitor()`` can arm
it even at ``observability=none``.

Under ``basic``/``full`` the kernels' launches are accounted in the
process cost model (``obs/costmodel.py``), which ``/roofline`` reads.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..log import Log
from .health import HealthMonitor
from .registry import get_registry
from .reqtrace import NULL_REQ_SPAN, NULL_TRACER, RequestTracer
from .server import StatsServer
from .slo import SloEngine
from .trace import EventStream, PerfettoWindow, Tracer, _NULL_SPAN

LEVELS = {"none": 0, "basic": 1, "full": 2}


def resolve_health_action(config) -> str:
    """``health_monitor=auto`` means: warn when observability is on,
    nothing when it is off (no device-side cost by default)."""
    action = getattr(config, "health_monitor", "auto")
    if action == "auto":
        return "warn" if getattr(config, "observability", "none") != "none" \
            else "none"
    return action


class TrainingObs:
    """Observability state for one booster; cheap when disabled."""

    def __init__(self, level: int = 0, health_action: str = "none",
                 events: Optional[EventStream] = None,
                 perfetto: Optional[PerfettoWindow] = None,
                 stats: Optional[StatsServer] = None,
                 checkpoint_dir: str = "", checkpoint_keep: int = 3,
                 flight=None, device: Optional[torch.device] = None):
        self.level = level
        self.device = device if device is not None else torch.device("cpu")
        self.registry = get_registry()
        self.events = events
        self.tracer = Tracer(enabled=level > 0, registry=self.registry,
                             events=events, metric="lgbm_train_span_seconds")
        self.perfetto = perfetto
        self.stats = stats
        self.flight = flight      # FlightRecorder (obs/distributed.py)
        if flight is not None:
            flight.install()
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_keep = checkpoint_keep
        self.monitor: Optional[HealthMonitor] = None
        if health_action != "none":
            self._make_monitor(health_action)
        self._c_iters = self.registry.counter(
            "lgbm_train_iterations_total", "Boosting iterations completed.")
        self._s_iter = self.registry.summary(
            "lgbm_train_iteration_seconds",
            "Per-iteration wall time (derived from block time when fused).")
        self._g_wave_s = self.registry.gauge(
            "lgbm_train_seconds_per_wave",
            "Mean wall time per frontier wave (sharded-collective step) "
            "over the last synced dispatch.")
        self._g_hbm = self.registry.gauge(
            "lgbm_train_device_bytes_in_use",
            "Live device memory (allocator bytes_in_use; live-array sum "
            "as fallback).")
        self._c_rows = self.registry.counter(
            "lgbm_train_rows_total",
            "Training rows processed (rows x iterations completed) — the "
            "train_slo_rows_per_sec throughput source.")
        # request-scoped tracing of the training loop (obs/reqtrace.py):
        # one root per streamed iteration, a child a sweep
        self.reqtrace = NULL_TRACER
        self.slo: Optional[SloEngine] = None
        self._stop_accounting = None

    # ------------------------------------------------------------ setup
    @classmethod
    def disabled(cls) -> "TrainingObs":
        return cls(level=0, health_action="none")

    @classmethod
    def from_config(cls, config, device: Optional[torch.device] = None
                    ) -> "TrainingObs":
        """The JAX package's ``from_config`` on one process:
        ``obs_distributed=auto`` is off there, and ``on`` refuses before
        this runs (``boosting/gbdt.py`` ``check_slice``)."""
        level = LEVELS.get(getattr(config, "observability", "none"), 0)
        action = resolve_health_action(config)
        if level == 0 and action == "none":
            return cls.disabled()
        events = None
        flight = None
        if level > 0 and getattr(config, "obs_event_file", ""):
            if getattr(config, "obs_flight_recorder", 0) > 0:
                from .distributed import FlightRecorder
                flight = FlightRecorder(config.obs_event_file,
                                        size=config.obs_flight_recorder)
            events = EventStream(config.obs_event_file, ring=flight)
            if flight is not None:
                flight._on_dump = lambda reason: events.flush(fsync=True)
        perfetto = None
        if (level >= 2 and getattr(config, "obs_perfetto_dir", "")
                and getattr(config, "obs_perfetto_iters", 0) > 0):
            perfetto = PerfettoWindow(config.obs_perfetto_dir,
                                      getattr(config, "obs_perfetto_start", 0),
                                      config.obs_perfetto_iters)
        stats = None
        port = getattr(config, "obs_stats_port", -1)
        if level > 0 and port >= 0:
            try:
                stats = StatsServer(port).start()
            except OSError as e:
                Log.warning("obs: could not bind stats port %d: %s"
                            % (port, e))
        obs = cls(level=level, health_action=action,
                  events=events, perfetto=perfetto, stats=stats,
                  checkpoint_dir=getattr(config, "checkpoint_dir", ""),
                  checkpoint_keep=getattr(config, "checkpoint_keep", 3),
                  flight=flight, device=device)
        if level > 0:
            from ..core import kernels
            from .costmodel import get_cost_model
            obs._stop_accounting = kernels.account_launches(get_cost_model())
        if level > 0 and getattr(config, "obs_trace", False):
            obs.reqtrace = RequestTracer(
                events=events,
                slow_ms=getattr(config, "obs_trace_slow_ms", 250.0),
                sample=getattr(config, "obs_trace_sample", 0.01),
                seed=getattr(config, "seed", 0))
        floor = getattr(config, "train_slo_rows_per_sec", 0.0)
        if level > 0 and floor > 0:
            obs.slo = SloEngine(
                fast_window_s=getattr(config, "slo_fast_window_s", 300.0),
                slow_window_s=getattr(config, "slo_slow_window_s", 3600.0),
                burn_warn=getattr(config, "slo_burn_warn", 2.0),
                monitor=obs.monitor)
            obs.slo.add_throughput_slo(
                "train_throughput", "lgbm_train_rows_total", floor,
                description="training rows/sec floor "
                            "(train_slo_rows_per_sec)")
            obs.slo.start(getattr(config, "slo_tick_s", 5.0))
            if stats is not None:
                stats.set_slo(obs.slo)
        return obs

    def _make_monitor(self, action: str) -> None:
        self.monitor = HealthMonitor(action=action, registry=self.registry,
                                     events=self.events,
                                     on_abort=self._abort_checkpoint,
                                     on_fatal=self._fatal_dump)

    def _fatal_dump(self, report) -> None:
        self.crash_flush("health:%s" % getattr(report, "kind", "anomaly"))

    def _abort_checkpoint(self, booster, report) -> None:
        if booster is None or not self._checkpoint_dir:
            return
        from ..checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(self._checkpoint_dir,
                                keep_last_n=self._checkpoint_keep)
        path = mgr.save(booster)
        Log.warning("health: checkpoint-and-abort wrote %s" % path)

    # ------------------------------------------------------------ state
    @property
    def enabled(self) -> bool:
        return self.level > 0

    @property
    def per_iteration(self) -> bool:
        """full mode: the loop must dispatch one iteration at a time."""
        return self.level >= 2

    @property
    def health_enabled(self) -> bool:
        return self.monitor is not None and self.monitor.action != "none"

    @property
    def fetches_health(self) -> bool:
        """Whether the loop builds and fetches health rows: under basic and
        full (their spans end at the fetch), or for a health action."""
        return self.level > 0 or self.health_enabled

    def arm_health(self, action: str) -> bool:
        """Enable or retarget health monitoring (callback.health_monitor).
        Returns True when monitoring was off before."""
        rebuild = not self.health_enabled and action != "none"
        if self.monitor is None:
            if action != "none":
                self._make_monitor(action)
        else:
            self.monitor.action = action
        return rebuild

    # ------------------------------------------------------------ hooks
    def span(self, name: str, sync=None, **fields):
        if self.level == 0:
            return _NULL_SPAN
        return self.tracer.span(name, sync=sync, **fields)

    def iteration_scope(self, name: str = "train_iter"):
        """The Perfetto window's ``record_function(name)`` scope around one
        iteration's work while it captures, else a no-op."""
        if self.perfetto is None:
            return _NULL_SPAN
        return self.perfetto.iteration(name)

    def event(self, name: str, **fields) -> None:
        if self.events is not None:
            self.events.write(name, **fields)

    def perfetto_step(self, lo: int, hi: int) -> None:
        if self.perfetto is not None:
            self.perfetto.step(lo, hi)

    def trace_iter(self, iteration: int, **fields):
        """Root span for one training iteration (streamed path). Returns
        the shared no-op span when request tracing is off, so the caller
        threads it unconditionally; finish() runs the tail-sampling
        keep/drop like any serving request."""
        if not self.reqtrace.enabled:
            return NULL_REQ_SPAN
        return self.reqtrace.start_trace("train_iter",
                                         iteration=int(iteration), **fields)

    def account_rows(self, rows: int) -> None:
        """Rows processed by one completed dispatch, the throughput-SLO
        source (rows x iterations, so a 5-iteration block over 1M rows
        accounts 5M)."""
        if rows > 0:
            self._c_rows.inc(int(rows))

    def dispatch_done(self, start_iter: int, count: int, dur_s: float,
                      health_rows=None, busy_s=None, wait_s=None,
                      **fields) -> None:
        """Account one synced dispatch covering ``count`` iterations.
        ``busy_s``/``wait_s``: the host/device split of its wall time, on
        the event."""
        self._c_iters.inc(count)
        per_iter = dur_s / max(count, 1)
        for _ in range(count):
            self._s_iter.observe(per_iter)
        if health_rows is not None:
            waves = float(sum(r[3] for r in health_rows))
            if waves > 0:
                self._g_wave_s.set(dur_s / waves)
        if self.events is not None:
            kind = "iteration" if count == 1 else "block"
            if busy_s is not None:
                fields = dict(fields, host_s=round(float(busy_s), 6))
            if wait_s is not None:
                fields = dict(fields, device_s=round(float(wait_s), 6))
            self.events.write(kind, iteration=start_iter, count=count,
                              dur_s=round(dur_s, 6),
                              iter_s=round(per_iter, 6), **fields)

    def check_health(self, health_rows, start_iter: int,
                     booster=None) -> None:
        if self.monitor is not None:
            self.monitor.check(health_rows, start_iter, booster=booster)

    def record_hbm(self) -> None:
        """Set the device-memory gauge to the caching allocator's bytes in
        use on the card; nothing on the CPU."""
        if self.level == 0 or self.device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(self.device)
        self._g_hbm.set(stats.get("allocated_bytes.all.current", 0))

    def crash_flush(self, reason: str):
        """The crash path: fsync the event stream, dump the flight
        recorder. Called from the HealthMonitor fatal hook, the
        checkpoint callback's SIGTERM latch, and (via the recorder's own
        hooks) SIGTERM/unhandled-exception. Safe to call repeatedly: the
        dump latches on first use."""
        if self.events is not None:
            try:
                self.events.flush(fsync=True)
            except Exception:
                pass
        if self.flight is not None:
            return self.flight.dump(reason)
        return None

    def release(self) -> None:
        """Close the profiler window, stop the SLO ticker and the kernel
        accounting: the end of a run, finished or crashed."""
        if self.perfetto is not None:
            self.perfetto.close()
        if self.slo is not None:
            self.slo.stop()
        if self._stop_accounting is not None:
            self._stop_accounting()
            self._stop_accounting = None

    def finish(self) -> None:
        """End-of-training flush; the stats server stays up so callers can
        scrape final state before exit."""
        self.release()
        if self.events is not None:
            self.events.write(
                "train_done",
                iterations=int(self._c_iters.value),
                anomalies=(self.monitor.anomaly_count()
                           if self.monitor is not None else 0))
        if self.flight is not None:
            # a completed run keeps its ring but disarms the global
            # SIGTERM/excepthook seams: post-training crashes belong to
            # the embedding application, not this booster
            self.flight.uninstall()
