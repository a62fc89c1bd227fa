"""Host-side health dispatch: the ``HealthMonitor`` serving builds.

The port's copy of the JAX package's ``HealthMonitor``
(``lightgbm_tpu/obs/health.py``), the part the serving engine's drift
monitors route through (``ServingEngine._drift_health``): a drift report
warns and counts, and never escalates. The device-side ``health_vec``,
its training-side ``check`` and the straggler and SLO notes come with
ROADMAP Queue 1 #15.
"""
from __future__ import annotations

from typing import List, Optional

from ..log import LightGBMError, Log
from .registry import MetricsRegistry, get_registry

_ACTIONS = ("none", "warn", "abort", "raise")


class HealthReport:
    """One detected anomaly (or note) at a concrete iteration."""

    __slots__ = ("iteration", "kind", "message")

    def __init__(self, iteration: int, kind: str, message: str):
        self.iteration = iteration
        self.kind = kind
        self.message = message

    def __repr__(self):
        return "HealthReport(iter=%d, kind=%r)" % (self.iteration, self.kind)


class HealthMonitor:
    """Records warn-only reports and counts them in the metrics registry."""

    def __init__(self, action: str = "warn",
                 registry: Optional[MetricsRegistry] = None, events=None):
        if action not in _ACTIONS:
            raise LightGBMError("unknown health_monitor action %r "
                                "(expected one of %s)"
                                % (action, "/".join(_ACTIONS)))
        self.action = action
        self.reports: List[HealthReport] = []
        self._events = events
        reg = registry if registry is not None else get_registry()
        self._c_drift = reg.counter(
            "lgbm_drift_reports_total",
            "Train/serve drift reports routed through the health monitor "
            "(warn-only; drift never escalates).")

    def note_drift(self, model_id: str, features: str, max_psi: float,
                   threshold: float, rows: int = 0) -> HealthReport:
        """Record a train/serve drift crossing from obs.drift. Drift warns
        and counts but never escalates: shifted traffic is a refit trigger,
        not a reason to kill a server that is still answering correctly
        for its training distribution."""
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
