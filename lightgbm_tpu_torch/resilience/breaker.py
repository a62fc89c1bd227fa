"""Consecutive-failure circuit breaker for the serving front-ends.

The port's own copy of ``lightgbm_tpu/resilience/breaker.py``.

Classic three-state breaker sized for a model server: CLOSED counts
consecutive dispatch failures (client errors don't count — the caller
classifies); at ``failure_threshold`` it OPENS and every request is
rejected fast with a Retry-After hint for ``cooldown_s``; the first
request after the cooldown is admitted as a HALF-OPEN probe — success
closes the breaker, failure re-opens it for another full cooldown.
Shedding load this way keeps a wedged engine (bad model roll, device
loss) from stacking up threads behind futures that will never resolve.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Thread-safe; ``failure_threshold=0`` disables (always allows)."""

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 5.0):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_out = False
        self._trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def trips(self) -> int:
        with self._lock:
            return self._trips

    def allow(self) -> bool:
        """May this request proceed? While OPEN, the first call after the
        cooldown transitions to HALF_OPEN and is admitted as the single
        probe; further calls are rejected until the probe reports."""
        if self.failure_threshold <= 0:
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown_s:
                    self._state = HALF_OPEN
                    self._probe_out = True
                    return True
                return False
            # HALF_OPEN: exactly one probe in flight
            if not self._probe_out:
                self._probe_out = True
                return True
            return False

    def retry_after_s(self) -> float:
        """Seconds until the next probe would be admitted (the 503
        Retry-After value); 0 when not rejecting."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(self.cooldown_s - (time.monotonic() - self._opened_at),
                       0.0)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_out = False
            self._state = CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN or (
                    self.failure_threshold > 0
                    and self._consecutive >= self.failure_threshold):
                if self._state != OPEN:
                    self._trips += 1
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._probe_out = False

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    "trips": self._trips,
                    "retry_after_s": round(
                        max(self.cooldown_s
                            - (time.monotonic() - self._opened_at), 0.0), 3)
                    if self._state == OPEN else 0.0}
