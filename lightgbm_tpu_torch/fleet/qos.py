"""Multi-model QoS: admission quotas, weighted-fair scheduling, and
closed-loop cascade-margin autotuning.

The port's own copy of ``lightgbm_tpu/fleet/qos.py`` (which imports no
JAX). When several models share one ServingEngine the micro-batch queue's
head-of-line pick lets a chatty model starve the rest, and the single
engine-wide row bound sheds EVERY model once any one of them floods the
queue. :class:`QosPolicy` fixes both:

- **per-model admission**: each model gets a queued-row quota; a request
  that would exceed its own model's quota is shed with a per-model
  503-with-Retry-After while other models keep being admitted (the
  engine-wide ``serve_max_queue_rows`` bound still backstops the total);
- **weighted-fair scheduling**: dispatch picks the queued model with the
  smallest ``rows_served / weight`` virtual time (weighted fair queueing
  over row counts), so a weight-4 model gets ~4x the device rows of a
  weight-1 model under saturation.

:class:`CascadeAutotuner` closes the latency loop: it watches the
per-bucket latency histograms (serving/metrics.py) and walks the
early-exit cascade margin (serving/traversal.py) down when the observed
p99 overshoots ``serve_latency_budget_ms`` and back up toward full-model
exactness when there is headroom. Margin changes go through
``ServingEngine.set_cascade_margin``, which captures the new margin's
CUDA graphs OFF the request path inside a warmup-credit window, so no
capture after warmup is charged to live traffic.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..log import Log, check


class QosPolicy:
    """Per-model admission quotas + weighted-fair virtual time.

    ``weights`` maps model_id -> scheduling weight (default 1.0);
    ``quota_rows`` maps model_id -> max queued rows for that model
    (``default_quota_rows`` for unlisted models; 0 = no per-model bound).
    Thread-safety: all mutation happens under the owning queue's lock.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 quota_rows: Optional[Dict[str, int]] = None,
                 default_weight: float = 1.0,
                 default_quota_rows: int = 0):
        check(default_weight > 0, "QoS default_weight must be > 0")
        self.weights = dict(weights or {})
        for mid, w in self.weights.items():
            check(w > 0, "QoS weight for %r must be > 0" % mid)
        self.quota_rows = {m: int(q) for m, q in (quota_rows or {}).items()}
        self.default_weight = float(default_weight)
        self.default_quota_rows = max(int(default_quota_rows), 0)
        self._served_rows: Dict[str, float] = {}
        self._shed: Dict[str, int] = {}

    @classmethod
    def from_spec(cls, weights_spec: str = "", quota_rows: int = 0
                  ) -> "QosPolicy":
        """Build from the config-string surface: ``serve_qos_weights`` is
        ``"modelA=4,modelB=1"`` (empty = every model weight 1) and
        ``serve_qos_quota_rows`` is the default per-model quota."""
        weights: Dict[str, float] = {}
        for part in (weights_spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            check("=" in part,
                  "serve_qos_weights entries must look like model=weight, "
                  "got %r" % part)
            mid, w = part.split("=", 1)
            weights[mid.strip()] = float(w)
        return cls(weights=weights, default_quota_rows=quota_rows)

    # ------------------------------------------------------------ admission
    def weight(self, model_id: str) -> float:
        return self.weights.get(model_id, self.default_weight)

    def quota(self, model_id: str) -> int:
        return self.quota_rows.get(model_id, self.default_quota_rows)

    def admit(self, model_id: str, queued_model_rows: int,
              nrows: int) -> bool:
        """True when ``nrows`` more rows fit under the model's quota."""
        q = self.quota(model_id)
        if q and queued_model_rows + nrows > q:
            self._shed[model_id] = self._shed.get(model_id, 0) + 1
            return False
        return True

    # ------------------------------------------------------------ fairness
    def _floor_vt(self) -> float:
        """The fleet's minimum VIRTUAL time (``served_rows / weight``) —
        the start point for models seen for the first time, so a
        newcomer neither starves the incumbents nor gets an unbounded
        catch-up burst. The floor must be in virtual-time units, not raw
        rows: seeding a weight-1 newcomer with a weight-4 incumbent's
        ROW count would hand it a 4x-inflated virtual time and starve
        it indefinitely."""
        return min((self._served_rows[m] / self.weight(m)
                    for m in self._served_rows), default=0.0)

    def pick(self, queued_rows_by_model: Dict[str, int]) -> str:
        """The model to dispatch next: smallest virtual time
        ``served_rows / weight`` among models with queued work. An
        unseen model sits AT the floor, which follows the incumbents'
        virtual time — so ties must break toward the newcomer or it
        never receives the first service that enters it into the
        rotation."""
        floor = self._floor_vt()
        best, best_key = None, None
        for mid in sorted(queued_rows_by_model):
            seen = mid in self._served_rows
            vt = self._served_rows[mid] / self.weight(mid) if seen else floor
            key = (vt, seen)               # False < True: unseen wins ties
            if best_key is None or key < best_key:
                best, best_key = mid, key
        return best

    def account(self, model_id: str, rows: int) -> None:
        if model_id not in self._served_rows:
            self._served_rows[model_id] = \
                self._floor_vt() * self.weight(model_id)
        self._served_rows[model_id] += float(rows)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-model QoS state for ``/stats`` (the schema of docs/Fleet.md)."""
        models = set(self._served_rows) | set(self._shed) \
            | set(self.weights) | set(self.quota_rows)
        return {mid: {
            "weight": self.weight(mid),
            "quota_rows": self.quota(mid),
            "served_rows": self._served_rows.get(mid, 0.0),
            "shed": self._shed.get(mid, 0),
        } for mid in sorted(models)}


class CascadeAutotuner:
    """Walk the engine's cascade margin along a static ladder to hold the
    observed per-bucket p99 under ``budget_ms``.

    The ladder is geometric from near-exact (the engine's configured
    margin — largest, fewest early exits) down to ``margin / 2**(n-1)``.
    Each step only ever moves ONE rung and re-warms through
    ``set_cascade_margin`` (off-path, warmup-credited), so a noisy p99
    cannot thrash the compiled-entry cache. ``headroom`` (default 0.6):
    only retune UP toward exactness when p99 < headroom * budget —
    hysteresis against oscillation at the boundary."""

    def __init__(self, engine, budget_ms: float, rungs: int = 4,
                 interval_s: float = 2.0, headroom: float = 0.6,
                 min_samples: int = 20):
        check(budget_ms > 0, "serve_latency_budget_ms must be > 0 to tune")
        check(engine.cascade_trees > 0,
              "cascade autotuning needs serving_cascade_trees > 0 "
              "(no early-exit stage to widen)")
        self.engine = engine
        self.budget_ms = float(budget_ms)
        top = float(engine.cascade_margin)
        self.ladder: List[float] = [top / (2.0 ** i) for i in range(rungs)]
        self.interval_s = float(interval_s)
        self.headroom = float(headroom)
        self.min_samples = int(min_samples)
        self._idx = 0                      # current rung (0 = widest margin)
        self._seen: Dict[int, int] = {}    # bucket -> samples already judged
        self.retunes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    def observed_p99_ms(self) -> Optional[float]:
        """Worst p99 across buckets with NEW samples since the last step
        (stale histograms must not re-trigger a retune forever)."""
        worst = None
        for bucket, st in self.engine.metrics.bucket_latency().items():
            fresh = int(st["count"]) - self._seen.get(int(bucket), 0)
            if fresh < self.min_samples:
                continue
            if worst is None or st["p99_ms"] > worst:
                worst = float(st["p99_ms"])
        return worst

    def step(self) -> Optional[float]:
        """One control decision; returns the newly applied margin or None
        when nothing changed."""
        p99 = self.observed_p99_ms()
        if p99 is None:
            return None
        target = self._idx
        if p99 > self.budget_ms and self._idx < len(self.ladder) - 1:
            target = self._idx + 1         # tighter margin, more early exit
        elif p99 < self.headroom * self.budget_ms and self._idx > 0:
            target = self._idx - 1         # headroom: move toward exactness
        for bucket, st in self.engine.metrics.bucket_latency().items():
            self._seen[int(bucket)] = int(st["count"])
        if target == self._idx:
            return None
        self._idx = target
        margin = self.ladder[target]
        self.engine.set_cascade_margin(margin)
        self.retunes += 1
        Log.info("cascade autotune: p99 %.1f ms vs budget %.1f ms -> "
                 "margin %.4g (rung %d/%d)", p99, self.budget_ms, margin,
                 target + 1, len(self.ladder))
        return margin

    def snapshot(self) -> Dict[str, float]:
        return {"budget_ms": self.budget_ms,
                "margin": self.ladder[self._idx],
                "rung": self._idx, "rungs": len(self.ladder),
                "retunes": self.retunes}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "CascadeAutotuner":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="lgbm-cascade-tuner",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - tuner must not die
                Log.warning("cascade autotune step failed: %s", e)
