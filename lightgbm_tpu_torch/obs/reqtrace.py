"""Request-scoped tracing: span trees with tail-based sampling.

The port's own copy of ``lightgbm_tpu/obs/reqtrace.py``, host code only.
Every admitted serving request (and every streamed training iteration)
can carry a trace: a tree of host-side spans recording where that one
request spent its time (queue wait, the QoS virtual-time pick, the
micro-batch it was coalesced into, the copy to the card and the graph's
replay against the copy back). Spans are buffered per trace and only
emitted when the ROOT span finishes, because the sampling policy is
tail-based: it needs the final duration and status before it can decide.

Sampling policy (``RequestTracer``):

- always keep traces slower than ``obs_trace_slow_ms``;
- always keep traces that end in ``shed`` or ``error``;
- probabilistically keep ``obs_trace_sample`` of the rest, decided by a
  deterministic hash of ``(seed, trace_id)`` (``keep_decision``, the JAX
  package's function), so a replayed event stream, and either package,
  makes the same decisions.

Kept spans are emitted as ``span`` records on the shared
:class:`~lightgbm_tpu_torch.obs.trace.EventStream`; they ring-mirror into
the flight recorder like every other event.

Propagation: the ``x-lgbm-trace`` header carries ``<trace_id>`` or
``<trace_id>-<parent_span_id>``; the serving front-end honors it at
admission so fleet replicas and load generators keep one trace id across
process hops.

Tracing off is the shared :data:`NULL_REQ_SPAN` / :data:`NULL_TRACER`:
every call site collapses to attribute lookups on a slotless singleton,
and the captured CUDA graphs never see any of this (host-side only).
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from . import registry as _registry

TRACE_HEADER = "x-lgbm-trace"

_HEX = set("0123456789abcdef")

# id minting is on the per-request hot path (every admitted request mints
# a trace id + several span ids even when the trace will be dropped), so
# no os.urandom syscall per id: one random base per process, mixed with
# an atomic counter through the splitmix64 multiplier — unique within a
# process, collision-unlikely across processes, and cheap
_ID_BASE = int.from_bytes(os.urandom(8), "big")
_ID_COUNT = itertools.count(1)
_MIX = 0x9E3779B97F4A7C15


def new_trace_id() -> str:
    return "%016x" % ((_ID_BASE ^ (next(_ID_COUNT) * _MIX))
                      & 0xFFFFFFFFFFFFFFFF)


def new_span_id() -> str:
    return "%08x" % ((_ID_BASE ^ (next(_ID_COUNT) * _MIX)) & 0xFFFFFFFF)


def parse_trace_header(value) -> Optional[Tuple[str, Optional[str]]]:
    """``"<trace_id>"`` or ``"<trace_id>-<parent_span_id>"`` ->
    ``(trace_id, parent_span_id_or_None)``; malformed headers return None
    (the request simply starts a fresh trace — a bad client header must
    never fail admission)."""
    if not value:
        return None
    parts = str(value).strip().lower().split("-")
    tid = parts[0]
    if not tid or len(tid) > 32 or not set(tid) <= _HEX:
        return None
    parent = None
    if len(parts) > 1 and parts[1]:
        cand = parts[1]
        if len(cand) <= 32 and set(cand) <= _HEX:
            parent = cand
    return (tid, parent)


def format_trace_header(span) -> str:
    """Header value that makes ``span`` the parent on the next hop."""
    return "%s-%s" % (span.trace_id, span.span_id)


def keep_decision(trace_id: str, sample: float, seed: int = 0) -> bool:
    """Deterministic probabilistic keep for the non-slow, non-error tail:
    hash ``(seed, trace_id)`` into [0, 1) and compare against ``sample``.
    Pure function of its inputs so replica processes and replays agree."""
    s = float(sample)
    if s >= 1.0:
        return True
    if s <= 0.0:
        return False
    h = zlib.crc32(("%d:%s" % (int(seed), trace_id)).encode("ascii"))
    return (h & 0xFFFFFFFF) / 4294967296.0 < s


class _NullReqSpan:
    """The shared do-nothing span handed out when tracing is off.  One
    instance for the whole process; ``child`` returns itself so arbitrary
    trees of instrumentation cost a method call and nothing else."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    status = "ok"
    dur_ms = 0.0

    def child(self, name, **fields):
        return self

    def annotate(self, **fields):
        return None

    def end(self, status="ok", **fields):
        return None

    def finish(self, status="ok", **fields):
        return None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        return False


NULL_REQ_SPAN = _NullReqSpan()


class ReqSpan:
    """One node of a request's span tree.

    Roots are minted by :meth:`RequestTracer.start_trace`; children by
    :meth:`child`.  ``end()`` buffers the span on its root; nothing is
    serialized or emitted until the root's ``finish()`` runs the
    tail-based sampling decision.  Cross-thread safe: the batching worker ends spans
    created on submitter threads (buffer appends go through the root's
    lock)."""

    __slots__ = ("_tracer", "_root", "trace_id", "span_id", "parent_id",
                 "name", "fields", "status", "dur_ms", "_t0", "_wall0",
                 "_done", "_buf", "_lock", "_batch", "_dependent",
                 "_emitted")

    def __init__(self, tracer, root, trace_id, span_id, parent_id, name,
                 fields, dependent=False):
        self._tracer = tracer
        self._root = root                      # None => this IS a root
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.fields = dict(fields)
        self.status = "ok"
        self.dur_ms = 0.0
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._done = False
        self._dependent = dependent
        self._emitted = False
        self._batch = None
        if root is None:
            self._buf: List["ReqSpan"] = []
            self._lock = threading.Lock()
        else:
            self._buf = None
            self._lock = None

    def __bool__(self):
        return True

    # ------------------------------------------------------------- tree
    def child(self, name: str, **fields) -> "ReqSpan":
        root = self._root if self._root is not None else self
        return ReqSpan(self._tracer, root, self.trace_id, new_span_id(),
                       self.span_id, name, fields)

    def annotate(self, **fields) -> None:
        self.fields.update(fields)

    # --------------------------------------------------------- lifecycle
    def end(self, status: str = "ok", **fields) -> None:
        """Close the span and buffer it on its root.  Only the SPAN goes
        in the buffer — the flat record dict is materialized lazily in
        ``_record()``, so the ~99% of traces the sampler drops never pay
        for serialization."""
        if self._done:
            return
        self._done = True
        self.dur_ms = (time.perf_counter() - self._t0) * 1000.0
        self.status = str(status)
        if fields:
            self.fields.update(fields)
        root = self._root if self._root is not None else self
        with root._lock:
            root._buf.append(self)

    def _record(self) -> Dict:
        rec = dict(self.fields)
        rec.update(trace=self.trace_id, span_id=self.span_id,
                   parent=self.parent_id, name=self.name,
                   t0=round(self._wall0, 6),
                   dur_ms=round(self.dur_ms, 3), status=self.status)
        return rec

    def finish(self, status: str = "ok", **fields) -> None:
        """End the span; on a root this also runs the keep/drop decision
        and emits the buffered tree when kept."""
        self.end(status, **fields)
        if self._root is None and not self._dependent:
            self._tracer._finish(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.finish("error" if exc_type is not None else "ok")
        return False


class RequestTracer:
    """Mints trace roots, buffers span trees, applies tail-based sampling
    at root finish, and emits kept spans on the EventStream."""

    enabled = True

    def __init__(self, events=None, slow_ms: float = 250.0,
                 sample: float = 0.01, seed: int = 0, registry=None,
                 keep_recent: int = 64):
        self.events = events
        self.slow_ms = float(slow_ms)
        self.sample = float(sample)
        self.seed = int(seed)
        # bounded summaries of kept traces, newest last — lets smokes and
        # tests inspect the verdicts without re-reading the event file
        self.recent = collections.deque(maxlen=int(keep_recent))
        reg = registry if registry is not None else _registry.get_registry()
        self._started = reg.counter(
            "lgbm_trace_started_total", "Trace roots minted")
        self._kept = reg.counter(
            "lgbm_trace_kept_total", "Traces kept by tail-based sampling")
        self._kept_slow = reg.counter(
            "lgbm_trace_kept_slow_total",
            "Traces kept because dur_ms >= obs_trace_slow_ms")
        self._kept_bad = reg.counter(
            "lgbm_trace_kept_bad_total",
            "Traces kept because they ended in shed/error")
        self._span_count = reg.counter(
            "lgbm_trace_spans_total", "Spans emitted from kept traces")

    # ------------------------------------------------------------- mint
    def start_trace(self, name: str, ctx=None, **fields) -> ReqSpan:
        """Root span for one request/iteration.  ``ctx`` is an inbound
        ``x-lgbm-trace`` header value (or a pre-parsed ``(trace_id,
        parent_span_id)`` tuple) — honoring it keeps one trace id across
        fleet hops."""
        if isinstance(ctx, str):
            ctx = parse_trace_header(ctx)
        tid, parent = ctx if ctx else (new_trace_id(), None)
        self._started.inc()
        return ReqSpan(self, None, tid, new_span_id(), parent, name, fields)

    def batch_span(self, name: str, members, **fields) -> ReqSpan:
        """One batch span linked from N coalesced request spans.

        The span rides the first member's trace (its request span is the
        parent) and records every member as a ``links`` entry; every
        member's root is annotated with the batch span's id.  The batch
        subtree is buffered on its own and emitted once if ANY member
        trace is kept, so a slow straggler's trace still shows the batch
        that carried it even when the batch's own trace is dropped."""
        members = [m for m in members if isinstance(m, ReqSpan)]
        if not members:
            return NULL_REQ_SPAN
        first = members[0]
        links = ["%s-%s" % (m.trace_id, m.span_id) for m in members]
        sp = ReqSpan(self, None, first.trace_id, new_span_id(),
                     first.span_id, name, dict(fields, links=links),
                     dependent=True)
        ref = "%s-%s" % (sp.trace_id, sp.span_id)
        for m in members:
            m.annotate(batch=ref)
            root = m._root if m._root is not None else m
            root._batch = sp
        return sp

    # ------------------------------------------------------------ flush
    def _finish(self, root: ReqSpan) -> None:
        slow = root.dur_ms >= self.slow_ms
        bad = root.status != "ok"
        keep = slow or bad or keep_decision(root.trace_id, self.sample,
                                            self.seed)
        if slow:
            self._kept_slow.inc()
        if bad:
            self._kept_bad.inc()
        if not keep:
            return
        self._kept.inc()
        spans: List[ReqSpan] = []
        batch = root._batch
        if batch is not None:
            with batch._lock:
                if not batch._emitted:
                    batch._emitted = True
                    spans.extend(batch._buf)
        with root._lock:
            spans.extend(root._buf)
        recs = [s._record() for s in spans]
        self._span_count.inc(len(recs))
        if self.events is not None:
            for rec in recs:
                self.events.write("span", **rec)
        self.recent.append({
            "trace": root.trace_id, "name": root.name,
            "dur_ms": round(root.dur_ms, 3), "status": root.status,
            "reason": ("slow" if slow else
                       ("status" if bad else "sample")),
            "spans": len(recs),
            # the flat span records themselves (parent links intact) so
            # /traces can answer "which stage ate the latency" without
            # re-reading the event file
            "records": recs})

    def recent_traces(self) -> List[Dict]:
        """Summaries (+ span records) of recently KEPT traces, newest
        last — the serving ``/traces`` body."""
        return list(self.recent)


class NullRequestTracer:
    """Tracing disabled: every mint returns the shared no-op span."""

    enabled = False
    recent: collections.deque = collections.deque(maxlen=1)

    def start_trace(self, name, ctx=None, **fields):
        return NULL_REQ_SPAN

    def batch_span(self, name, members, **fields):
        return NULL_REQ_SPAN

    def recent_traces(self):
        return []


NULL_TRACER = NullRequestTracer()
