"""Host observability layers that serving runs on, copied from the JAX
package's ``lightgbm_tpu/obs/``: the process-wide metrics registry
(``registry.py``), train/serve drift (``drift.py``) and the warn-only
``HealthMonitor`` (``health.py``). The rest of the JAX package's ``obs/``
(tracing, SLOs, the stats server, the cost model, the device-side health
vector) is ROADMAP Queue 1 #15."""
from .drift import DataProfile, DriftMonitor, drift_snapshot
from .health import HealthMonitor, HealthReport
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Summary,
                       get_registry)

__all__ = ["Counter", "DataProfile", "DriftMonitor", "Gauge", "HealthMonitor",
           "HealthReport", "Histogram", "MetricsRegistry", "Summary",
           "drift_snapshot", "get_registry"]
