"""Micro-batching queue: coalesce concurrent requests into one forward pass.

The port of ``lightgbm_tpu/serving/batching.py``. Individual serving
requests are tiny (often 1 row); dispatching each as its own device call
wastes the card and pays per-call latency. The queue holds arriving
requests for at most ``deadline_ms`` and fuses every compatible request,
same ``(model_id, raw_score, num_iteration)``, into ONE padded bucketed
pass through the ServingEngine, then hands each caller's Future its own
rows of the result.

Deadline semantics: the clock starts at the OLDEST queued request, so a
request never waits more than ``deadline_ms`` in the queue regardless of
traffic; a full bucket (``max_rows``) dispatches immediately.
``deadline_ms=0`` degrades to pass-through (still fusing whatever is
already queued).

Overload protection: ``max_queue_rows`` bounds the TOTAL queued rows; a
request that would exceed it is shed immediately with
:class:`OverloadedError`. ``request_timeout_ms`` is a per-request
deadline: a request still queued past it is expired at dispatch time
instead of wasting a device pass. ``stop(drain=True)`` (the default)
closes admission first, finishes the queued work, then joins the worker.

Multi-model QoS: an optional :class:`fleet.qos.QosPolicy` adds
per-MODEL admission quotas (only the over-quota model sheds; the rest keep
being admitted under the engine-wide bound) and replaces the head-of-line
dispatch pick with weighted-fair queueing: each dispatch serves the queued
model with the smallest ``rows_served / weight`` virtual time. Without a
policy the queue picks head-of-line and sheds engine-wide only.

Request tracing (``obs_trace``, ``obs/reqtrace.py``): with a tracer, each
admitted request gets a root span (an inbound ``x-lgbm-trace`` header
continues its trace) and a ``queue_wait`` child; a dispatch makes ONE
``batch`` span linked from every coalesced request, with the QoS pick and
the engine's ``predict`` pass as children. Spans are host objects around
the engine's call, never inside a captured graph.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..log import LightGBMError, OverloadedError
from .predictor import ServingEngine


class _Request:
    __slots__ = ("key", "X", "future", "t", "deadline", "span", "qspan")

    def __init__(self, key, X, future, timeout_s=0.0, span=None, qspan=None):
        self.key = key
        self.X = X
        self.future = future
        self.t = time.perf_counter()
        self.deadline = self.t + timeout_s if timeout_s > 0 else None
        self.span = span        # trace root (obs/reqtrace.py) or None
        self.qspan = qspan      # open queue_wait child span or None


class MicroBatchQueue:
    """Deadline-bounded request coalescer in front of a ServingEngine."""

    def __init__(self, engine: ServingEngine, max_rows: Optional[int] = None,
                 deadline_ms: float = 2.0, max_queue_rows: int = 0,
                 request_timeout_ms: float = 0.0, qos=None, tracer=None):
        self.engine = engine
        self.max_rows = int(max_rows) if max_rows else engine.max_batch
        self.deadline_s = max(float(deadline_ms), 0.0) / 1000.0
        self.max_queue_rows = max(int(max_queue_rows), 0)   # 0 = unbounded
        self.request_timeout_s = max(float(request_timeout_ms), 0.0) / 1000.0
        self.qos = qos                      # fleet.qos.QosPolicy or None
        self.tracer = tracer                # obs.reqtrace.RequestTracer/None
        self._last_pick = None              # QoS decision for the batch span
        self._queue: List[_Request] = []
        self._queued_rows = 0
        self._model_rows: Dict[str, int] = {}
        self._cond = threading.Condition()
        self._running = False
        self._draining = False
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MicroBatchQueue":
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._draining = False
        self._worker = threading.Thread(target=self._loop,
                                        name="lgbm-serve-batcher", daemon=True)
        self._worker.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the queue. ``drain=True`` closes admission, lets the worker
        finish everything already queued, then joins; ``drain=False`` stops
        immediately and fails queued callers."""
        with self._cond:
            if drain:
                self._draining = True
            else:
                self._running = False
            self._cond.notify_all()
        if drain:
            # admission is closed; the worker empties the queue then we
            # shut it down for real
            deadline = time.monotonic() + 30.0
            with self._cond:
                while self._queue and time.monotonic() < deadline:
                    self._cond.wait(timeout=0.05)
                self._running = False
                self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None
        # fail any stragglers rather than hanging their callers
        with self._cond:
            leftovers, self._queue = self._queue, []
            self._queued_rows = 0
            self._model_rows.clear()
            self._publish_depth_locked()
        for r in leftovers:
            r.future.set_exception(LightGBMError("serving queue stopped"))
            if r.span is not None:
                r.span.finish("error", error="serving queue stopped")

    # ------------------------------------------------------------ submit
    def _publish_depth_locked(self) -> None:
        self.engine.metrics.set_queue_depth(len(self._queue))
        self.engine.metrics.set_queue_rows(self._queued_rows)

    def submit(self, model_id: str, X, raw_score: bool = False,
               num_iteration: Optional[int] = None,
               trace=None) -> "Future":
        """Enqueue one request; the Future resolves to the same array
        ``engine.predict`` would return for it alone. Sheds with
        OverloadedError when admission would exceed ``max_queue_rows``.

        ``trace`` is an optional inbound ``x-lgbm-trace`` header value (or
        a parsed ``(trace_id, parent_span_id)``): with a tracer, the
        request's trace ROOT is minted here, where its life starts, so a
        shed or a refused admission is recorded on the trace before the
        error propagates."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        fut: Future = Future()
        span = qspan = None
        if self.tracer is not None and self.tracer.enabled:
            span = self.tracer.start_trace("request", ctx=trace,
                                           model=str(model_id),
                                           rows=int(X.shape[0]))
            qspan = span.child("queue_wait")
        req = _Request((model_id, bool(raw_score), num_iteration), X, fut,
                       self.request_timeout_s, span, qspan)
        try:
            self._admit(req, model_id)
        except OverloadedError as e:
            # finish OUTSIDE the queue lock: a kept shed-trace writes to
            # the event stream, which must not serialize admissions
            if span is not None:
                span.finish("shed", error=str(e))
            raise
        except Exception as e:
            if span is not None:
                span.finish("error", error=str(e))
            raise
        return fut

    def _admit(self, req: _Request, model_id: str) -> None:
        """Queue ``req`` under the lock, or raise: not started, draining,
        or over the engine-wide or the model's bound (shed)."""
        with self._cond:
            if not self._running:
                raise LightGBMError("MicroBatchQueue.submit before start()")
            if self._draining:
                raise LightGBMError(
                    "serving queue is draining (shutting down); "
                    "request rejected")
            nrows = req.X.shape[0]
            if self.max_queue_rows and \
                    self._queued_rows + nrows > self.max_queue_rows:
                self.engine.metrics.record_shed()
                raise OverloadedError(
                    "serving queue overloaded: %d queued rows + %d would "
                    "exceed serve_max_queue_rows=%d"
                    % (self._queued_rows, nrows, self.max_queue_rows),
                    retry_after_s=max(self.deadline_s * 2, 0.05))
            if self.qos is not None and not self.qos.admit(
                    model_id, self._model_rows.get(model_id, 0), nrows):
                # per-MODEL shed: only this tenant backs off; every other
                # model keeps being admitted under the engine-wide bound
                self.engine.metrics.record_shed()
                raise OverloadedError(
                    "model %r over its QoS quota: %d queued rows + %d "
                    "would exceed quota_rows=%d"
                    % (model_id, self._model_rows.get(model_id, 0), nrows,
                       self.qos.quota(model_id)),
                    retry_after_s=max(self.deadline_s * 2, 0.05))
            self._queue.append(req)
            self._queued_rows += nrows
            self._model_rows[model_id] = \
                self._model_rows.get(model_id, 0) + nrows
            self._publish_depth_locked()
            self._cond.notify_all()

    def predict(self, model_id: str, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                trace=None) -> np.ndarray:
        """Blocking convenience wrapper around submit()."""
        return self.submit(model_id, X, raw_score, num_iteration,
                           trace=trace).result()

    def stats(self) -> Dict:
        """Queue and per-model QoS state (the ``queue`` block of /stats)."""
        with self._cond:
            out: Dict = {"queued_requests": len(self._queue),
                         "queued_rows": self._queued_rows,
                         "model_rows": dict(self._model_rows)}
            if self.qos is not None:
                out["qos"] = self.qos.snapshot()
        return out

    # ------------------------------------------------------------ worker
    def _pick_key_locked(self) -> Tuple:
        """The dispatch key: head-of-line without QoS; with a policy, the
        oldest key of the queued model with the smallest weighted-fair
        virtual time (fleet/qos.py)."""
        if self.qos is None:
            return self._queue[0].key
        by_model: Dict[str, int] = {}
        for r in self._queue:
            by_model[r.key[0]] = by_model.get(r.key[0], 0) + r.X.shape[0]
        mid = self.qos.pick(by_model)
        # remember the decision for the batch span: which tenant the
        # weighted-fair virtual time elected, over what queue composition
        self._last_pick = {"picked": mid, "queued_rows": dict(by_model)}
        for r in self._queue:
            if r.key[0] == mid:
                return r.key
        return self._queue[0].key

    def _collect(self) -> List[_Request]:
        """Under the lock: wait out the head request's deadline, then take
        every queued request sharing the picked dispatch key (arrival
        order preserved within the key)."""
        head = self._queue[0]
        deadline = head.t + self.deadline_s
        while self._running and not self._draining:
            key = self._pick_key_locked()
            rows = sum(r.X.shape[0] for r in self._queue if r.key == key)
            now = time.perf_counter()
            if rows >= self.max_rows or now >= deadline:
                break
            self._cond.wait(timeout=deadline - now)
        key = self._pick_key_locked()
        taken = [r for r in self._queue if r.key == key]
        self._queue = [r for r in self._queue if r.key != key]
        nrows = sum(r.X.shape[0] for r in taken)
        self._queued_rows -= nrows
        left = self._model_rows.get(key[0], 0) - nrows
        if left > 0:
            self._model_rows[key[0]] = left
        else:
            self._model_rows.pop(key[0], None)
        if self.qos is not None:
            self.qos.account(key[0], nrows)
        self._publish_depth_locked()
        self._cond.notify_all()   # stop(drain=True) waits on queue empty
        return taken

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._queue:
                    if self._draining:
                        return
                    self._cond.wait()
                if not self._running:
                    return
                batch = self._collect()
            # expire requests whose per-request deadline passed while
            # queued: their caller stopped waiting; don't burn a pass
            if self.request_timeout_s > 0:
                now = time.perf_counter()
                live = []
                for r in batch:
                    if r.deadline is not None and now > r.deadline:
                        self.engine.metrics.record_timeout()
                        r.future.set_exception(OverloadedError(
                            "request expired in queue after %.0f ms "
                            "(serve_request_timeout_ms=%.0f)"
                            % ((now - r.t) * 1000.0,
                               self.request_timeout_s * 1000.0),
                            retry_after_s=max(self.deadline_s * 2, 0.05)))
                        if r.span is not None:
                            r.qspan.end("shed")
                            r.span.finish("shed", error="expired in queue")
                    else:
                        live.append(r)
                batch = live
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: List[_Request]) -> None:
        model_id, raw_score, num_iteration = batch[0].key
        bspan = pspan = None
        spans = [r.span for r in batch if r.span is not None]
        if spans:
            # queue_wait ends when the batch leaves the queue; the batch
            # span is ONE span linked from every coalesced request, with
            # the QoS election and the engine pass as children
            for r in batch:
                if r.qspan is not None:
                    r.qspan.end()
            bspan = self.tracer.batch_span(
                "batch", spans, model=str(model_id), requests=len(batch),
                rows=int(sum(r.X.shape[0] for r in batch)))
            pick = self._last_pick
            if pick is not None:
                bspan.child("qos_pick", picked=pick["picked"],
                            queued_rows=pick["queued_rows"]).end()
            pspan = bspan.child("predict", model=str(model_id))
        try:
            X = (batch[0].X if len(batch) == 1
                 else np.concatenate([r.X for r in batch], axis=0))
            # _span travels only when tracing minted one: engines that
            # wrap or stand in for ServingEngine never see the keyword
            kw = {"_span": pspan} if pspan is not None else {}
            out = self.engine.predict(model_id, X, raw_score=raw_score,
                                      num_iteration=num_iteration,
                                      _record_request=False, **kw)
            if pspan is not None:
                pspan.end()
                bspan.end()
            done = time.perf_counter()
            lo = 0
            for r in batch:
                hi = lo + r.X.shape[0]
                r.future.set_result(out[lo:hi])
                # per-CALLER accounting: latency includes the coalescing
                # wait (what the caller actually observed)
                self.engine.metrics.record_request(r.X.shape[0], done - r.t)
                if r.span is not None:
                    r.span.finish(
                        "ok", latency_ms=round((done - r.t) * 1000.0, 3))
                lo = hi
        except Exception as e:  # noqa: BLE001 - delivered to each caller
            if pspan is not None:
                pspan.end("error", error=str(e))
                bspan.end("error")
            self.engine.metrics.record_error()
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
                if r.span is not None:
                    r.span.finish("error", error=str(e))
