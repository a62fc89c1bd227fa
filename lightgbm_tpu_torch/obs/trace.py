"""Spans, event streams and the profiler window of the training loop.

The port's own copy of ``lightgbm_tpu/obs/trace.py``. The span API is
host-side: a ``with tracer.span("train_iter")`` block times wall clock and
touches the device only at span CLOSE, where a span given ``sync=`` (a
CUDA device or tensor) calls ``torch.cuda.synchronize`` on its device: one
sync per span, never per op, so the launches inside a span stay
asynchronous. A CPU device or tensor syncs nothing. When tracing is
disabled the span object is a shared no-op constant and the ``with``
costs two trivial method calls.

Events are JSON-lines (one object per line, ``ts`` + ``event`` keys
always present), append-only and flushed per write so a preempted run
keeps everything it logged.

The JAX package's Perfetto capture rides ``jax.profiler``; the port's
rides a ``torch.profiler.profile`` window over CPU activity, and CUDA
activity on the card, and writes a Chrome trace JSON
(``trace_<pid>_<n>.json``) into the directory, which ui.perfetto.dev and
chrome://tracing open. The profiler is process-global, so the helper
refuses to nest instead of crashing mid-train.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Optional

from ..log import Log
from .registry import MetricsRegistry, get_registry


class EventStream:
    """Thread-safe JSON-lines sink (a file path or an open handle).

    Every record carries ``ts`` (wall clock) and ``seq`` — a per-stream
    monotonic counter assigned under the write lock.  ``seq`` is what
    ``tools/merge_events.py`` tie-breaks on when zipping streams from
    hosts with skewed clocks: wall time orders ACROSS streams, the
    monotonic counter orders WITHIN one.  ``static_fields`` (e.g.
    ``process``/``host`` in distributed runs) are stamped onto every
    record; ``ring`` is an optional flight recorder (anything with
    ``append``) that sees each record after it is written.
    """

    def __init__(self, path_or_fh, static_fields: Optional[Dict] = None,
                 ring=None):
        self._lock = threading.Lock()
        self._static = dict(static_fields or {})
        self._ring = ring
        self._seq = 0
        if hasattr(path_or_fh, "write"):
            self._fh = path_or_fh
            self._owns = False
        else:
            self._fh = open(path_or_fh, "a")
            self._owns = True

    def write(self, event: str, **fields) -> Dict:
        rec = {"ts": round(time.time(), 6), "event": event}
        rec.update(self._static)
        rec.update(fields)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            line = json.dumps(rec, sort_keys=True, default=str) + "\n"
            self._fh.write(line)
            self._fh.flush()
        if self._ring is not None:
            self._ring.append(rec)
        return rec

    def flush(self, fsync: bool = False) -> None:
        """Push buffered lines to the OS and, with ``fsync=True``, to
        disk — called from the crash paths (HealthMonitor abort, the
        checkpoint SIGTERM latch, the flight recorder's dump) so the
        final events before a kill are never lost."""
        with self._lock:
            try:
                self._fh.flush()
                if fsync:
                    import os
                    os.fsync(self._fh.fileno())
            except (OSError, ValueError):
                pass   # closed handle / non-file sink: nothing to sync

    def close(self) -> None:
        self.flush(fsync=self._owns)
        with self._lock:
            if self._owns:
                self._fh.close()


def synchronize(what) -> None:
    """Wait for the card that ``what`` (a ``torch.device`` or a tensor)
    lives on; nothing for the CPU."""
    import torch
    dev = what if isinstance(what, torch.device) else what.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _NullSpan:
    """Disabled span: shared constant, ~free to enter/exit."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    def __init__(self, tracer: "Tracer", name: str, sync, fields: Dict):
        self._tracer = tracer
        self.name = name
        self._sync = sync
        self._fields = fields
        self.duration_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sync is not None:
            synchronize(self._sync)
        self.duration_s = time.perf_counter() - self._t0
        self._tracer._close(self, failed=exc_type is not None)
        return False


class Tracer:
    """Span factory bound to a registry summary + optional event stream."""

    def __init__(self, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 events: Optional[EventStream] = None,
                 metric: str = "lgbm_span_seconds"):
        self.enabled = enabled
        self._registry = registry if registry is not None else get_registry()
        self.events = events
        self._metric = metric

    def span(self, name: str, sync=None, **fields):
        """Open a timed span.  ``sync``: a CUDA device or tensor to
        synchronize at close (ONE sync point); extra ``fields`` land on the
        event."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, sync, fields)

    def _close(self, s: _Span, failed: bool) -> None:
        self._registry.summary(
            self._metric, "Wall-clock span durations.",
            labels={"span": s.name}).observe(s.duration_s)
        if self.events is not None:
            self.events.write("span", span=s.name,
                              dur_s=round(s.duration_s, 6),
                              failed=failed, **s._fields)


def span(name: str, sync=None, **fields):
    """Module-level convenience: an always-on span against the global
    registry (no event stream).  Library code should prefer a
    ``TrainingObs``-owned tracer, which respects ``observability=none``."""
    return Tracer(enabled=True).span(name, sync=sync, **fields)


# ------------------------------------------------------------ perfetto
_trace_lock = threading.Lock()
_trace_active = False


@contextlib.contextmanager
def perfetto_trace(trace_dir: Optional[str]):
    """Profile the body of the ``with`` with ``torch.profiler`` (CPU
    activity, and CUDA activity when the card is there) and write its
    Chrome trace into ``trace_dir``. ``trace_dir`` falsy -> no-op.
    Nested/concurrent captures degrade to a warning (the profiler is
    process-global). Yields the started profile, or None."""
    global _trace_active
    if not trace_dir:
        yield None
        return
    with _trace_lock:
        start = not _trace_active
        _trace_active = True if start else _trace_active
    if not start:
        Log.warning("perfetto capture already active; skipping nested "
                    "capture into %s" % trace_dir)
        yield None
        return
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception as e:  # profiler backend unavailable: degrade
            Log.warning("torch.profiler failed to start (%s); continuing "
                        "without a Perfetto capture" % e)
            prof = None
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                path = os.path.join(trace_dir, "trace_%d_%d.json"
                                    % (os.getpid(), next(_TRACE_SEQ)))
                prof.export_chrome_trace(path)
                Log.info("obs: Chrome trace written to %s" % path)
            except Exception as e:
                Log.warning("torch.profiler trace export failed: %s" % e)
        with _trace_lock:
            _trace_active = False


_TRACE_SEQ = itertools.count()


class PerfettoWindow:
    """Drive ``perfetto_trace`` over a [start, start+count) iteration
    window from inside the boosting loop.  ``step(lo, hi)`` is called
    before each dispatch covering iterations [lo, hi); capture starts
    when the window first overlaps and stops once ``lo`` passes the end.
    ``iteration(name)`` marks one iteration's work with a
    ``torch.profiler.record_function`` while the capture runs."""

    def __init__(self, trace_dir: str, start_iter: int, num_iters: int):
        self.trace_dir = trace_dir
        self.lo = int(start_iter)
        self.hi = int(start_iter) + int(num_iters)
        self._cm = None
        self.captured = False

    def step(self, lo: int, hi: int) -> None:
        if self._cm is None and lo < self.hi and hi > self.lo:
            self._cm = perfetto_trace(self.trace_dir)
            self.captured = self._cm.__enter__() is not None
        elif self._cm is not None and lo >= self.hi:
            self.close()

    def iteration(self, name: str):
        """A ``record_function(name)`` scope while capturing, else a
        no-op one."""
        if self._cm is None or not self.captured:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def close(self) -> None:
        if self._cm is not None:
            cm, self._cm = self._cm, None
            cm.__exit__(None, None, None)
