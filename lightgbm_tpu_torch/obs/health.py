"""Training health: device-side flag vector + host-side dispatch.

The port's own copy of ``lightgbm_tpu/obs/health.py``. The device side is
``health_vec``, a float32[4] tensor on the card built in the boosting
iteration from values it already has:

- non-finite grad/hess: ``sum(g) + sum(h)`` is two reductions over the
  gradients the histogram kernels are about to read anyway; any NaN/Inf
  in either tensor poisons the scalar (NaN survives masking because
  ``NaN * 0 == NaN``), so one isfinite on the sum catches a single bad
  row.
- zero-positive-gain iteration ("stump"): whether any of the iteration's
  trees split, which the host knows once the trees are on it.
- frontier gain health: the frontier grower counts its waves on the host,
  where its loop is, and keeps the non-finite committed gain as a device
  max (``core/grow_frontier.py`` ``GrowerHealth``).

It stays on the card: the boosting loop fetches the rows once a block of
``train_many`` (``observability=basic``, or a health action under
``none``) or once an iteration (``full``, or the per-iteration path).

The host side is ``HealthMonitor``: it inspects the fetched rows and
dispatches the configured action: ``warn`` (log + count), ``abort``
(checkpoint-then-raise) or ``raise``. Stump iterations are counted and
logged but never escalate: a converged model legitimately stops
splitting, while non-finite values never legitimately appear. Stragglers,
drift and SLO burns route through it too, and never escalate either.
"""
from __future__ import annotations

from typing import List, Optional

from ..log import LightGBMError, Log
from .registry import MetricsRegistry, get_registry

# layout of the device health vector (f32[HEALTH_VEC_LEN] per iteration)
HEALTH_NONFINITE = 0        # 1.0 when grad/hess contain NaN/Inf
HEALTH_STUMP = 1            # 1.0 when the iteration grew no split
HEALTH_NONFINITE_GAIN = 2   # 1.0 when a committed frontier gain was NaN/Inf
HEALTH_WAVES = 3            # frontier waves executed (sum over trees)
HEALTH_VEC_LEN = 4

_ACTIONS = ("none", "warn", "abort", "raise")


def health_vec(grad, hess, any_split, grower_health=None):
    """The device health vector of one iteration: float32[HEALTH_VEC_LEN]
    on ``grad``'s device, with no read back to the host.

    ``any_split``: whether the iteration grew a split (a bool or a bool
    tensor). ``grower_health``: optional float32[K, 2] per-class-tree
    (waves, nonfinite_gain) from the frontier grower, or None when the
    grower does not report (exact and batched growth)."""
    import torch

    dev = grad.device
    total = grad.sum(dtype=torch.float32) + hess.sum(dtype=torch.float32)
    nonfinite = (~torch.isfinite(total)).to(torch.float32)
    if isinstance(any_split, torch.Tensor):
        stump = (~any_split.to(dev, torch.bool)).to(torch.float32)
    else:   # a host bool: a fill on the card, no copy to wait for
        stump = torch.full((), 0.0 if any_split else 1.0,
                           dtype=torch.float32, device=dev)
    if grower_health is None:
        waves = torch.zeros((), dtype=torch.float32, device=dev)
        bad_gain = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        grower_health = torch.as_tensor(grower_health, dtype=torch.float32,
                                        device=dev)
        waves = grower_health[..., 0].sum()
        bad_gain = grower_health[..., 1].max()
    return torch.stack([nonfinite, stump, bad_gain, waves])


class HealthReport:
    """One detected anomaly (or stump note) at a concrete iteration."""

    __slots__ = ("iteration", "kind", "message")

    def __init__(self, iteration: int, kind: str, message: str):
        self.iteration = iteration
        self.kind = kind
        self.message = message

    def __repr__(self):
        return "HealthReport(iter=%d, kind=%r)" % (self.iteration, self.kind)


class HealthMonitor:
    """Host-side inspector for fetched health vectors."""

    def __init__(self, action: str = "warn",
                 registry: Optional[MetricsRegistry] = None,
                 events=None, on_abort=None, on_fatal=None):
        if action not in _ACTIONS:
            raise LightGBMError("unknown health_monitor action %r "
                                "(expected one of %s)"
                                % (action, "/".join(_ACTIONS)))
        self.action = action
        self.reports: List[HealthReport] = []
        self._events = events
        self._on_abort = on_abort
        # invoked right before the monitor raises (abort AND raise):
        # TrainingObs hooks the flight-recorder dump + event fsync here
        # so the crash artifacts exist before the exception unwinds
        self._on_fatal = on_fatal
        reg = registry if registry is not None else get_registry()
        self._c_anomaly = reg.counter(
            "lgbm_train_health_anomalies_total",
            "Non-finite grad/hess or gain anomalies detected in training.")
        self._c_stump = reg.counter(
            "lgbm_train_stump_iterations_total",
            "Iterations that grew a tree with no split.")
        self._g_waves = reg.gauge(
            "lgbm_train_frontier_waves_last",
            "Frontier waves executed by the most recent iteration.")
        self._c_straggler = reg.counter(
            "lgbm_train_straggler_reports_total",
            "Straggler-skew reports routed through the health monitor "
            "(warn-only; stragglers never escalate).")
        self._c_drift = reg.counter(
            "lgbm_drift_reports_total",
            "Train/serve drift reports routed through the health monitor "
            "(warn-only; drift never escalates).")
        self._c_slo_burn = reg.counter(
            "lgbm_slo_burn_reports_total",
            "SLO budget-burn reports routed through the health monitor "
            "(warn-only; a burning budget never escalates).")

    def anomaly_count(self) -> int:
        return int(self._c_anomaly.value)

    def note_straggler(self, iteration: int, process: int, skew: float,
                       threshold: float) -> HealthReport:
        """Record a straggler-skew crossing from distributed obs.  Like
        stump iterations, stragglers warn and count but NEVER escalate —
        a slow peer is an infrastructure symptom, not a reason to abort
        an otherwise-healthy optimization."""
        r = HealthReport(
            int(iteration), "straggler_wave",
            "process %d is a straggler at iteration %d: block wall-time "
            "skew %.2fx >= warn threshold %.2fx"
            % (int(process), int(iteration), float(skew), float(threshold)))
        self.reports.append(r)
        self._c_straggler.inc()
        if self._events is not None:
            self._events.write("health", iteration=r.iteration, kind=r.kind,
                               message=r.message, process=int(process),
                               skew=round(float(skew), 4))
        Log.warning("health: %s" % r.message)
        return r

    def note_drift(self, model_id: str, features: str, max_psi: float,
                   threshold: float, rows: int = 0) -> HealthReport:
        """Record a train/serve drift crossing from obs.drift.  Like
        stragglers, drift warns and counts but NEVER escalates — shifted
        traffic is a refit trigger, not a reason to kill a server that is
        still answering correctly for its training distribution."""
        r = HealthReport(
            0, "data_drift",
            "model %s: serving traffic drifted from the training profile "
            "(max PSI %.3f >= warn threshold %.3f over %d rows; %s)"
            % (model_id, float(max_psi), float(threshold), int(rows),
               features))
        self.reports.append(r)
        self._c_drift.inc()
        if self._events is not None:
            self._events.write("health", iteration=0, kind=r.kind,
                               message=r.message, model=str(model_id),
                               max_psi=round(float(max_psi), 4))
        Log.warning("health: %s" % r.message)
        return r

    def note_slo_burn(self, slo: str, fast_burn: float, slow_burn: float,
                      observed: float, objective: float,
                      kind: str = "") -> HealthReport:
        """Record an SLO flipping to burning (obs/slo.py).  Like drift,
        a burning error budget warns and counts but NEVER escalates — it
        is the arming signal for the refit/hot-roll loop, not a reason to
        kill a process that is still serving."""
        r = HealthReport(
            0, "slo_burn",
            "SLO %s is burning its error budget: fast-window burn %.2fx, "
            "slow-window burn %.2fx (observed %.4g vs %s objective %.4g)"
            % (str(slo), float(fast_burn), float(slow_burn),
               float(observed), str(kind) or "the", float(objective)))
        self.reports.append(r)
        self._c_slo_burn.inc()
        if self._events is not None:
            self._events.write("health", iteration=0, kind=r.kind,
                               message=r.message, slo=str(slo),
                               fast_burn=round(float(fast_burn), 4),
                               slow_burn=round(float(slow_burn), 4))
        Log.warning("health: %s" % r.message)
        return r

    def check(self, health_rows, start_iter: int, booster=None
              ) -> List[HealthReport]:
        """Inspect fetched vectors (``[B, HEALTH_VEC_LEN]`` host floats for
        iterations ``start_iter..start_iter+B-1``) and dispatch the
        configured action.  Raises from inside when the action demands."""
        new: List[HealthReport] = []
        for off, row in enumerate(health_rows):
            it = start_iter + off
            self._g_waves.set(float(row[HEALTH_WAVES]))
            if row[HEALTH_STUMP] > 0:
                self._c_stump.inc()
                new.append(HealthReport(
                    it, "zero_gain_wave",
                    "iteration %d grew no split (all gains <= 0)" % it))
            if row[HEALTH_NONFINITE] > 0:
                new.append(HealthReport(
                    it, "nonfinite_gradient",
                    "non-finite gradient/hessian at iteration %d" % it))
            if row[HEALTH_NONFINITE_GAIN] > 0:
                new.append(HealthReport(
                    it, "nonfinite_gain",
                    "non-finite split gain committed at iteration %d" % it))
        self.reports.extend(new)
        anomalies = [r for r in new if r.kind != "zero_gain_wave"]
        for r in new:
            if self._events is not None:
                self._events.write("health", iteration=r.iteration,
                                   kind=r.kind, message=r.message)
            if r.kind == "zero_gain_wave":
                Log.debug("health: %s" % r.message)
            else:
                self._c_anomaly.inc()
                Log.warning("health: %s" % r.message)
        if anomalies and self.action in ("abort", "raise"):
            first = anomalies[0]
            if self.action == "abort" and self._on_abort is not None:
                try:
                    self._on_abort(booster, first)
                except Exception as e:
                    Log.warning("health abort checkpoint failed: %s" % e)
            if self._on_fatal is not None:
                try:
                    self._on_fatal(first)
                except Exception as e:
                    Log.warning("health fatal hook failed: %s" % e)
            raise LightGBMError(
                "training aborted by health monitor: %s" % first.message)
        return new
