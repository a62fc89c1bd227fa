"""Fault tolerance: deterministic fault injection, supervised training and
serving overload protection, the port of ``lightgbm_tpu/resilience/``.

- ``faults``: a seeded, config-driven fault plan
  (``fault_inject="kill@iter:7,serve_error@req:50"``) with named injection
  points in the training loop, the snapshot writer and the serving
  predict; inert by default;
- ``supervisor``: a watchdog and a restart loop around ``engine.train``
  (``supervise=True``), and a process-level supervisor that survives a
  SIGKILL and a hang inside a kernel;
- ``breaker``: the consecutive-failure circuit breaker of the serving
  front-ends (503 with Retry-After, a half-open probe).

The coordination-service seams (``kv_*`` faults, ``KvHeartbeat``) belong to
the device mesh, ROADMAP Queue 1 #13 slice b, and refuse.
"""
from .breaker import CircuitBreaker
from .faults import (FaultPlan, WatchdogAbort, active_plan, clear_plan,
                     inject, install_plan, parse_plan)
from .supervisor import (ProcessSupervisor, Supervisor, Watchdog,
                         heartbeat_file_callback)

__all__ = [
    "CircuitBreaker", "FaultPlan", "WatchdogAbort", "active_plan",
    "clear_plan", "inject", "install_plan", "parse_plan",
    "ProcessSupervisor", "Supervisor", "Watchdog",
    "heartbeat_file_callback",
]
