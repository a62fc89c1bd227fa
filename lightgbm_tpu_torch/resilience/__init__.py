"""Serving overload protection: the consecutive-failure circuit breaker
(``breaker.py``, a copy of the JAX package's). Fault injection and the
training supervisor are not ported yet (ROADMAP Queue 1 #18)."""
from .breaker import CircuitBreaker

__all__ = ["CircuitBreaker"]
