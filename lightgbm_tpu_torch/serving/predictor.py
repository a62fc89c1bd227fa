"""The predictor cache: shape-bucketed batch inference, no capture after
warmup.

The port of ``lightgbm_tpu/serving/predictor.py``. The cache is keyed
``(model_id, generation, bucket, raw_score, num_iteration, margin)``:

- request rows are padded up to a power-of-two bucket (floored at
  ``min_bucket``, capped at ``max_batch``; larger requests are chunked),
  so at most ``log2(max_batch / min_bucket) + 1`` shapes exist per key
  prefix, and a warmup pass over them makes every later request a cache
  hit that captures nothing;
- on the card each entry is a captured CUDA graph with a static float64
  input buffer ``[bucket, F]`` and a static float32 output buffer
  ``[bucket, K]``: a request chunk is copied in, the graph replays, and
  the rows it asked for are copied out, under one lock an entry because
  its static buffers are shared. With a cascade the entry holds two
  graphs, stage 1 and stage 2, and replays the second only when a row of
  stage 1 is uncertain: one host read of ``any(uncertain)``, where the JAX
  package decides with ``lax.cond`` on the device. The read costs no extra
  wait, because the entry reads its output back right after, and a
  confident batch skips stage 2's device work, as the JAX package's does;
  the outputs are the same either way. On the CPU the same entry runs
  eagerly;
- the raw -> output transform (sigmoid, softmax, exp) and the
  average-output division run on the host in float64, as the port's
  ``GBDT.predict`` runs them, so a served response is ``predict``'s bit
  for bit (the JAX package bakes them into its compiled function, in
  float32).

Requests stay float64 (the JAX package casts them to float32,
``serving/predictor.py:350``). Nothing falls back: an entry on the card
that cannot capture raises.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import SERVING_BACKENDS
from ..core import tree as tree_mod
from ..log import LightGBMError, Log, check, outside_slice
from ..resilience import faults
from . import traversal as traversal_mod
from .metrics import ServingMetrics, backend_compile_count, \
    record_graph_capture
from .registry import ModelBundle, ModelRegistry

# one capture at a time in the process: captures are rare (warmup and hot
# rolls) and each takes the allocator's private pool for its duration
_CAPTURE_LOCK = threading.Lock()


def bucket_rows(n: int, min_bucket: int = 16, max_batch: int = 4096) -> int:
    """Power-of-two padded size for an ``n``-row request (chunks of
    ``max_batch`` beyond the cap): the smallest power-of-two multiple of
    ``min_bucket`` that covers ``n``, clamped to ``max_batch``."""
    check(n >= 1, "empty prediction request")
    b = max(int(min_bucket), 1)
    while b < int(n):
        b <<= 1
    return min(b, int(max_batch))


def bucket_sizes(min_bucket: int = 16, max_batch: int = 4096) -> List[int]:
    """Every bucket the cache can produce: the warmup schedule. Doubles
    from ``min_bucket`` and always ends exactly at ``max_batch``."""
    out: List[int] = []
    b = max(int(min_bucket), 1)
    while b < int(max_batch):
        out.append(b)
        b <<= 1
    out.append(int(max_batch))
    return out


class _BucketPredictor:
    """One cache entry: the raw scores of one (bundle generation, bucket,
    raw_score, iterations, margin) as a CUDA graph on the card, eagerly on
    the CPU.

    ``backend="traversal"`` (default) serves from the bundle's flat forest
    (serving/traversal.py): O(depth) gather steps over all rows x all
    trees. ``backend="replay"`` serves through ``predict``'s own
    ``predict_forest_scores`` over the bundle's replay trees."""

    def __init__(self, bundle: ModelBundle, bucket: int, raw_score: bool,
                 num_iteration: int, backend: str = "traversal",
                 cascade_trees: int = 0, cascade_margin: float = 10.0,
                 quantize_leaves: bool = False):
        self.bucket = bucket
        self.backend = backend
        self.device = bundle.device
        self.k = bundle.num_tree_per_iteration
        self.num_features = max(bundle.num_features, 1)
        self._ck = 0
        if backend == "traversal":
            self._forest, self._depth = bundle.flat_for(
                num_iteration, quantize=quantize_leaves)
            self._ck = traversal_mod.cascade_split(self._forest, self.k,
                                                   cascade_trees)
        else:
            self._trees = bundle.trees_for(num_iteration)
        self._margin = float(cascade_margin)
        self._convert = (None if raw_score or bundle.objective is None
                         else bundle.objective.convert_output)
        self._avg_iters = num_iteration if bundle.average_output else 0
        self._lock = threading.Lock()
        self._x: Optional[torch.Tensor] = None   # static input, on the card
        self._graphs: Optional[tuple] = None

    # ------------------------------------------------------------ device work
    def _stage1(self, x: torch.Tensor):
        """(scores, uncertain): the whole forest's [N, K] scores and None
        without a cascade; stage 1's scores and uncertain rows with one."""
        if self.backend == "replay":
            return torch.stack([tree_mod.predict_forest_scores(t, x)
                                for t in self._trees], dim=1), None
        if self._ck == 0:
            return traversal_mod.forest_scores(self._forest, x, self.k,
                                               self._depth), None
        return traversal_mod.cascade_stage1(self._forest, x, self.k,
                                            self._depth, self._ck,
                                            self._margin)

    def _stage2(self, x: torch.Tensor, acc: torch.Tensor,
                uncertain: torch.Tensor) -> torch.Tensor:
        return traversal_mod.cascade_stage2(self._forest, x, self.k,
                                            self._depth, self._ck, acc,
                                            uncertain)

    def eager(self, x: torch.Tensor) -> torch.Tensor:
        """[bucket, K] float32 raw scores of ``x`` [bucket, F] float64,
        computed op by op on ``x``'s device (the CPU path, and the card's
        warm-up before a capture)."""
        acc, uncertain = self._stage1(x)
        if uncertain is None or not bool(uncertain.any()):
            return acc
        return self._stage2(x, acc, uncertain)

    def _capture(self) -> None:
        """Capture this entry's graphs on the card: the whole forest, or
        the cascade's two stages (stage 2 in stage 1's memory pool, since
        it always replays after it)."""
        x = torch.zeros((self.bucket, self.num_features), dtype=torch.float64,
                        device=self.device)
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.eager(x)      # warm-up before capture
            torch.cuda.current_stream(self.device).wait_stream(side)
            g1 = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g1, capture_error_mode="thread_local"):
                acc, uncertain = self._stage1(x)
                flag = None if uncertain is None else uncertain.any()
            record_graph_capture()
            g2 = out2 = None
            if uncertain is not None:
                g2 = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g2, pool=g1.pool(),
                                      capture_error_mode="thread_local"):
                    out2 = self._stage2(x, acc, uncertain)
                record_graph_capture()
        self._x = x
        self._graphs = (g1, acc, flag, g2, out2)

    def replay(self) -> torch.Tensor:
        """Replay the captured graphs on the static input; returns the
        static [bucket, K] output that holds the scores (call under the
        entry's lock)."""
        g1, acc, flag, g2, out2 = self._graphs
        g1.replay()
        if flag is None or not bool(flag.item()):
            return acc
        g2.replay()
        return out2

    def raw_scores(self, xc: np.ndarray, span=None) -> np.ndarray:
        """[rows, K] float32 raw scores of the chunk ``xc`` [rows, F]
        (rows <= bucket), padded with zero rows to the bucket. ``span``
        (a request trace span, optional) gets a ``device_dispatch`` child
        around the copy in and the replay and a ``device_wait`` child
        around the copy back: host spans around the graph, never in it."""
        rows = xc.shape[0]
        xt = torch.from_numpy(np.ascontiguousarray(xc, np.float64))
        if self.device.type != "cuda":
            dspan = span.child("device_dispatch", bucket=self.bucket) \
                if span is not None else None
            x = torch.zeros((self.bucket, self.num_features),
                            dtype=torch.float64, device=self.device)
            x[:rows] = xt
            return _fetch(self.eager(x)[:rows], span, dspan, self.bucket)
        with self._lock:
            if self._graphs is None:
                self._capture()
            dspan = span.child("device_dispatch", bucket=self.bucket) \
                if span is not None else None
            self._x[:rows].copy_(xt)
            if rows < self.bucket:
                self._x[rows:].zero_()
            return _fetch(self.replay()[:rows], span, dspan, self.bucket)

    def __call__(self, xc: np.ndarray, span=None) -> np.ndarray:
        """The chunk's outputs as ``GBDT.predict`` gives them: float64,
        [rows] for one tree an iteration, [rows, K] for K."""
        out = self.raw_scores(xc, span).astype(np.float64)
        if self._avg_iters:
            out = out / self._avg_iters
        if self.k == 1:
            out = out[:, 0]
        if self._convert is not None:
            out = np.asarray(self._convert(out))
        return out


def _fetch(out: torch.Tensor, span, dspan, bucket: int) -> np.ndarray:
    """``out`` on the host; with a trace ``span``, its ``device_dispatch``
    child ``dspan`` ends here and a ``device_wait`` child covers the
    copy back."""
    if span is None:
        return out.cpu().numpy()
    dspan.end()
    wspan = span.child("device_wait", bucket=bucket)
    host = out.cpu().numpy()
    wspan.end()
    return host


class ServingEngine:
    """Registry + predictor cache on one device: the serve path's core.

    ``predict`` is thread-safe and synchronous; the micro-batching queue
    (serving/batching.py) sits in front of it for concurrent traffic.
    ``device`` is the registry's (CUDA unless the caller asks for the
    CPU); with a ``registry`` given, its device.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 max_batch: int = 4096, min_bucket: int = 16,
                 num_devices: int = 1,
                 metrics: Optional[ServingMetrics] = None,
                 backend: str = "traversal", cascade_trees: int = 0,
                 cascade_margin: float = 10.0,
                 quantize_leaves: bool = False,
                 guard_hot_roll: bool = True, canary_rows: int = 16,
                 roll_max_latency_ms: float = 0.0,
                 drift: bool = True, drift_warn_psi: float = 0.25,
                 drift_min_rows: int = 256, drift_decay: float = 0.999,
                 device=None):
        if num_devices != 1:
            raise outside_slice("serve_num_devices=%d (the serving mesh)"
                                % num_devices, "ROADMAP Queue 1 #13")
        check(max_batch >= 1 and min_bucket >= 1,
              "serve_max_batch and serve_min_bucket must be >= 1")
        check(backend in SERVING_BACKENDS,
              "serving_backend should be one of %s, got %r"
              % (list(SERVING_BACKENDS), backend))
        check(cascade_trees >= 0 and cascade_margin >= 0,
              "serving_cascade_trees and serving_cascade_margin must be >= 0")
        # normalize both to powers of two so bucket_rows' ladder is exact
        self.min_bucket = 1 << (int(min_bucket) - 1).bit_length()
        self.max_batch = max(1 << (int(max_batch) - 1).bit_length(),
                             self.min_bucket)
        self.backend = backend
        self.cascade_trees = int(cascade_trees)
        self.cascade_margin = float(cascade_margin)
        self.quantize_leaves = bool(quantize_leaves)
        self.guard_hot_roll = bool(guard_hot_roll)
        self.canary_rows = max(int(canary_rows), 1)
        self.roll_max_latency_ms = max(float(roll_max_latency_ms), 0.0)
        if registry is None:
            registry = ModelRegistry(device)
        elif device is not None and torch.device(device).type \
                != registry.device.type:
            raise LightGBMError("the registry serves on %s, not %s"
                                % (registry.device, device))
        self.registry = registry
        self.device = registry.device
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._cache: Dict[Tuple, _BucketPredictor] = {}
        self._lock = threading.Lock()
        # train/serve drift (obs/drift.py): one DriftMonitor per live
        # (model, generation), created lazily on the first predict
        self.drift_enabled = bool(drift)
        self.drift_warn_psi = float(drift_warn_psi)
        self.drift_min_rows = int(drift_min_rows)
        self.drift_decay = float(drift_decay)
        self._drift: Dict[str, Tuple[int, object]] = {}
        self._drift_hooks: List = []   # attached to every (future) monitor
        self._health_monitor = None    # lazy HealthMonitor, warn-only
        # atomic re-registration (hot roll): purge this model's entries
        # when its bundle is swapped
        self.registry.add_replace_listener(self._invalidate_model)

    # ------------------------------------------------------------ cache
    def _invalidate_model(self, model_id: str) -> None:
        """Drop cache entries built against generations OTHER than the
        model's current one. The generation in the cache key already
        prevents stale hits; this frees dead entries' graphs and buffers
        while keeping entries a hot-roll prewarm captured for the
        just-committed generation (prewarm_bundle)."""
        current = self.registry.generation(model_id)
        with self._lock:
            for key in [k for k in self._cache
                        if k[0] == model_id and k[1] != current]:
                del self._cache[key]
            held = self._drift.get(model_id)
            if held is not None and held[0] != current:
                # the new generation may carry a different (or no) training
                # profile: drop the monitor; the next predict rebuilds it
                del self._drift[model_id]
                from ..obs.drift import unregister_monitor
                unregister_monitor(model_id)

    def _active_margin(self) -> float:
        """The cascade margin live entries are built for; part of the cache
        key so a retune (set_cascade_margin) can build the new margin's
        entries while the old ones keep serving. Constant 0.0 when no
        cascade is configured."""
        return float(self.cascade_margin) if self.cascade_trees > 0 else 0.0

    def _predictor(self, bundle: ModelBundle, bucket: int, raw_score: bool,
                   iters: int) -> _BucketPredictor:
        margin = self._active_margin()
        key = (bundle.model_id, bundle.generation, bucket, bool(raw_score),
               iters, margin)
        with self._lock:
            entry = self._cache.get(key)
            if entry is None:
                entry = _BucketPredictor(
                    bundle, bucket, raw_score, iters, backend=self.backend,
                    cascade_trees=self.cascade_trees,
                    cascade_margin=margin if self.cascade_trees > 0
                    else self.cascade_margin,
                    quantize_leaves=self.quantize_leaves)
                self._cache[key] = entry
                hit = False
            else:
                hit = True
        self.metrics.record_cache(hit)
        return entry

    def cache_size(self) -> int:
        with self._lock:
            return len(self._cache)

    def set_cascade_margin(self, margin: float) -> int:
        """Retune the cascade margin OFF the request path: build and run
        every bucket at the new margin inside a warmup-credit window (the
        ``stage_and_prewarm`` accounting, so the no-capture-after-warmup
        invariant survives the retune), then purge the old margin's
        entries. Returns the number of entries re-warmed (0 for a no-op or
        when no cascade is configured)."""
        margin = float(margin)
        check(margin >= 0, "cascade margin must be >= 0, got %s" % margin)
        if self.cascade_trees <= 0 or margin == self.cascade_margin:
            self.cascade_margin = margin
            return 0
        c0 = backend_compile_count()
        m0 = self.metrics.cache_misses
        self.cascade_margin = margin
        warmed = 0
        try:
            for mid in self.registry.ids():
                warmed += self._warm_bundle(self.registry.get(mid),
                                            (False,), (None,))
        finally:
            self.metrics.add_warmup_credit(backend_compile_count() - c0,
                                           self.metrics.cache_misses - m0)
        with self._lock:
            for key in [k for k in self._cache if k[5] != margin]:
                del self._cache[key]
        return warmed

    # ------------------------------------------------------------ drift
    def drift_monitor(self, bundle: ModelBundle):
        """The DriftMonitor for ``bundle``'s current generation (created
        and registered on first use, so ``/drift`` sees it). A monitor
        exists even when the bundle carries no training profile: it then
        reports ``no_profile``. Returns None only when drift monitoring is
        disabled engine-wide."""
        if not self.drift_enabled:
            return None
        gen = bundle.generation
        with self._lock:
            held = self._drift.get(bundle.model_id)
            if held is not None and held[0] == gen:
                return held[1]
        from ..obs.drift import DriftMonitor, register_monitor
        mon = DriftMonitor(
            bundle.profile, model_id=bundle.model_id,
            warn_psi=self.drift_warn_psi, min_rows=self.drift_min_rows,
            decay=self.drift_decay, monitor=self._drift_health())
        for hook in list(self._drift_hooks):
            mon.on_drift(hook)
        with self._lock:
            held = self._drift.get(bundle.model_id)
            if held is not None and held[0] == gen:
                return held[1]   # raced another request; keep the winner
            self._drift[bundle.model_id] = (gen, mon)
        register_monitor(mon)
        return mon

    def add_drift_hook(self, hook) -> None:
        """Subscribe ``hook(report_dict)`` to the ok->warn drift
        transitions of EVERY model this engine serves: the monitors that
        exist and those not made yet (they are lazy, one a generation).
        This is how ``CheckpointWatcher`` arms its refit-trigger poll
        without knowing which bundle will drift first."""
        self._drift_hooks.append(hook)
        with self._lock:
            monitors = [held[1] for held in self._drift.values()]
        for mon in monitors:
            mon.on_drift(hook)

    def _drift_health(self):
        """Warn-only HealthMonitor shared by this engine's drift monitors."""
        if self._health_monitor is None:
            from ..obs.health import HealthMonitor
            self._health_monitor = HealthMonitor(action="warn")
        return self._health_monitor

    def drift_status(self) -> Dict:
        """Worst drift status across this engine's live monitors: the
        ``drift`` field of ``/healthz``. ``disabled`` with
        ``serve_drift=false``; ``no_profile`` when no monitored model
        carries a training profile."""
        if not self.drift_enabled:
            return {"status": "disabled", "models": {}}
        with self._lock:
            monitors = [held[1] for held in self._drift.values()]
        rank = {"warn": 2, "ok": 1, "no_profile": 0}
        worst, models = "no_profile", {}
        for mon in monitors:
            st = mon.status()
            models[st.get("model", "")] = st
            if rank.get(st["status"], 0) > rank[worst]:
                worst = st["status"]
        return {"status": worst, "models": models}

    # ------------------------------------------------------------ predict
    def predict(self, model_id: str, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                _record_request: bool = True, _span=None) -> np.ndarray:
        """Serve one request: ``Booster.predict``'s output on the same
        rows, bit for bit, for any request size. ``_record_request=False``
        is for the micro-batch queue, which accounts its callers itself
        (per-caller count and queue-inclusive latency) so a fused dispatch
        is not double-counted. ``_span`` is an optional trace span
        (``obs/reqtrace.py``): each bucket pass gets its
        ``device_dispatch`` and ``device_wait`` children; the graphs
        replayed are the same with it or without."""
        t0 = time.perf_counter()
        # the serve_predict seam: "request" is a dispatched predict, counted
        # by the plan (a fused queue batch counts once)
        faults.inject("serve_predict", model=model_id)
        bundle = self.registry.get(model_id)
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        check(X.ndim == 2, "prediction input must be 2-D")
        if bundle.num_features:
            check(X.shape[1] == bundle.num_features,
                  "model %r expects %d features, request has %d"
                  % (model_id, bundle.num_features, X.shape[1]))
        iters = bundle.effective_iterations(num_iteration)
        if _span is not None and self.cascade_trees > 0:
            # the cascade's stages run inside the graphs; the trace records
            # the configuration they were captured with
            _span.annotate(cascade_trees=self.cascade_trees,
                           cascade_margin=self.cascade_margin)
        n = X.shape[0]
        outs = []
        for lo in range(0, n, self.max_batch):
            xc = X[lo:lo + self.max_batch]
            b = bucket_rows(xc.shape[0], self.min_bucket, self.max_batch)
            entry = self._predictor(bundle, b, raw_score, iters)
            t1 = time.perf_counter()
            outs.append(entry(xc, _span))
            self.metrics.record_batch(b)
            self.metrics.record_bucket_latency(
                b, (time.perf_counter() - t1) * 1000.0)
        out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
        if self.drift_enabled:
            mon = self.drift_monitor(bundle)
            if mon is not None:
                try:
                    mon.observe(X, scores=out)
                except Exception as e:  # noqa: BLE001 - diagnostics must not fail serving
                    Log.debug("drift observe failed for %r: %s",
                              model_id, e)
        if _record_request:
            self.metrics.record_request(n, time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------ warmup
    def warmup(self, model_ids: Optional[Iterable[str]] = None,
               raw_scores: Iterable[bool] = (False,),
               num_iterations: Iterable[Optional[int]] = (None,)) -> int:
        """Build (and on the card capture) every bucket for the given key
        prefixes so live traffic never captures; returns the number of
        entries warmed. Marks the metrics' capture floor when done."""
        ids = list(model_ids) if model_ids is not None else self.registry.ids()
        warmed = 0
        for mid in ids:
            warmed += self._warm_bundle(self.registry.get(mid), raw_scores,
                                        num_iterations)
        self.metrics.mark_warmup_done()
        return warmed

    def _warm_bundle(self, bundle: ModelBundle, raw_scores,
                     num_iterations) -> int:
        """Build and run every bucket for one bundle (shared by boot-time
        ``warmup`` and hot-roll ``prewarm_bundle``)."""
        nf = max(bundle.num_features, 1)
        warmed = 0
        for b in bucket_sizes(self.min_bucket, self.max_batch):
            zeros = np.zeros((b, nf), np.float64)
            for raw in raw_scores:
                for ni in num_iterations:
                    iters = bundle.effective_iterations(ni)
                    self._predictor(bundle, b, raw, iters)(zeros)
                    warmed += 1
        return warmed

    def prewarm_bundle(self, bundle: ModelBundle,
                       raw_scores: Iterable[bool] = (False,),
                       num_iterations: Iterable[Optional[int]] = (None,)
                       ) -> int:
        """Capture a STAGED bundle's entries before it is registered
        (registry.stage_file -> prewarm_bundle -> register): a hot roll
        pays its captures here, off the request path, and the captures
        and misses are credited to the metrics floors so the
        no-capture-after-warmup check survives the roll. Entries are
        cached under the staged generation; the generation-aware purge
        keeps them when the swap commits."""
        c0 = backend_compile_count()
        m0 = self.metrics.cache_misses
        warmed = self._warm_bundle(bundle, raw_scores, num_iterations)
        self.metrics.add_warmup_credit(backend_compile_count() - c0,
                                       self.metrics.cache_misses - m0)
        return warmed

    def stage_and_prewarm(self, model_id: str, path: str,
                          raw_scores: Iterable[bool] = (False,),
                          num_iterations: Iterable[Optional[int]] = (None,)
                          ) -> ModelBundle:
        """The off-path half of a hot roll: stage ``path`` as the next
        generation of ``model_id`` and prewarm it, crediting every capture
        in the window to the warmup floors. The caller commits with
        ``registry.register(bundle, replace=True)``.

        Guarded roll (``guard_hot_roll``): canary rows are scored on the
        staged bundle (finite outputs, traversal equal to replay, an
        optional latency cap), and a failing bundle is REFUSED: its
        entries are purged, ``lgbm_serving_rollbacks_total`` ticks, and
        the raised LightGBMError leaves the prior generation serving."""
        c0 = backend_compile_count()
        m0 = self.metrics.cache_misses
        try:
            bundle = self.registry.stage_file(model_id, path)
            self._warm_bundle(bundle, raw_scores, num_iterations)
            if self.guard_hot_roll:
                try:
                    self._validate_bundle(bundle)
                except LightGBMError as e:
                    self.metrics.record_rollback()
                    self._purge_generation(model_id, bundle.generation)
                    Log.warning("hot-roll REFUSED for %r (%s): prior "
                                "generation stays live", model_id, e)
                    raise
        finally:
            # validation captures (if any) are staged-roll work, never
            # serving captures: credit even on refusal
            self.metrics.add_warmup_credit(backend_compile_count() - c0,
                                           self.metrics.cache_misses - m0)
        return bundle

    # ------------------------------------------------------------ guard
    def _purge_generation(self, model_id: str, generation: int) -> None:
        """Drop every entry of one (model, generation): a refused staged
        bundle's predictors must not linger or ever serve a request."""
        with self._lock:
            for key in [k for k in self._cache
                        if k[0] == model_id and k[1] == generation]:
                del self._cache[key]

    def _canary(self, bundle: ModelBundle) -> np.ndarray:
        """Deterministic canary rows: a fixed grid spanning a wide value
        range (zeros, extremes, and a dense ramp), enough to route down
        both sides of any split and surface NaN/inf leaves."""
        nf = max(bundle.num_features, 1)
        n = self.canary_rows
        X = np.linspace(-1e3, 1e3, num=n * nf).reshape(n, nf)
        X[0, :] = 0.0
        if n > 1:
            X[1, :] = 1e30
        return X

    def _validate_bundle(self, bundle: ModelBundle) -> None:
        """Score canary rows on the STAGED bundle; raise LightGBMError on
        any failed check. Runs inside the stage_and_prewarm credit window
        so nothing here counts as a serving capture."""
        if bundle.profile is None:
            # warn, don't refuse: bare model files are valid models, they
            # just cannot be drift-monitored (``/drift`` says no_profile)
            Log.warning(
                "staged model %r carries no training data profile (bare "
                "model file); train/serve drift detection is unavailable "
                "for this generation", bundle.model_id)
        X = self._canary(bundle)
        iters = bundle.effective_iterations(None)
        b = bucket_rows(X.shape[0], self.min_bucket, self.max_batch)
        entry = self._predictor(bundle, b, False, iters)
        entry(X)                                 # warm before timing
        t1 = time.perf_counter()
        out = entry(X)
        latency_ms = (time.perf_counter() - t1) * 1000.0
        if not np.isfinite(out).all():
            bad = int(np.count_nonzero(~np.isfinite(out)))
            raise LightGBMError(
                "staged model %r failed canary validation: %d non-finite "
                "output(s) across %d canary rows"
                % (bundle.model_id, bad, X.shape[0]))
        # traversal against replay on the canary rows, op by op: both
        # paths must agree before the flat forest serves traffic
        flat, depth = bundle.flat_for(iters)
        xt = torch.as_tensor(X, device=bundle.device)
        a = traversal_mod.forest_scores_flat(
            flat, xt, bundle.num_tree_per_iteration, depth).cpu().numpy()
        r = torch.stack([tree_mod.predict_forest_scores(t, xt)
                         for t in bundle.trees_for(iters)],
                        dim=1).cpu().numpy()
        if not (np.isfinite(a).all() and np.isfinite(r).all()):
            raise LightGBMError(
                "staged model %r failed canary validation: non-finite "
                "raw scores (traversal/replay)" % bundle.model_id)
        if not np.array_equal(a, r):
            raise LightGBMError(
                "staged model %r failed canary validation: traversal "
                "vs replay diverge (max |diff| %.3g)"
                % (bundle.model_id, float(np.max(np.abs(a - r)))))
        if self.roll_max_latency_ms and \
                latency_ms > self.roll_max_latency_ms:
            raise LightGBMError(
                "staged model %r failed canary validation: warmed predict "
                "took %.1f ms > serve_roll_max_latency_ms=%.1f"
                % (bundle.model_id, latency_ms, self.roll_max_latency_ms))
