"""Deterministic fault injection: a config-driven plan of named faults.

The port's own copy of ``lightgbm_tpu/resilience/faults.py``. A fault
plan is parsed from the ``fault_inject`` parameter, a comma list of
``kind@unit:match[:arg]`` tokens, e.g.::

    fault_inject="kill@iter:7,serve_error@req:50"

Each token arms one fault ``kind`` at a named injection point, firing when
the trigger counter named ``unit`` reaches ``match`` (an integer, or ``*``
for every occurrence). The seams call :func:`inject` with the counters
they know (``iteration=7``, ``path=...``); a counter a seam does not pass
is counted per point by the plan itself (1-based call index), which is how
``serve_error@req:50`` means "the 50th predict".

The catalog (kind -> injection point -> effect):

====================  ==============  =====================================
``ckpt_torn``         ``ckpt_write``  truncate the just-written state file
                                      (a torn write; the manifest's sha
                                      catches it)
``kill``              ``train_dispatch``  SIGKILL self (``arg=term`` sends
                                      SIGTERM instead)
``hang``              ``train_dispatch``  block for ``arg`` seconds
                                      (default 3600) on the abort event;
                                      a watchdog abort raises WatchdogAbort
``crash``             ``train_dispatch``  raise LightGBMError
``serve_error``       ``serve_predict``   raise LightGBMError
``serve_delay``       ``serve_predict``   sleep ``arg`` ms (default 250)
====================  ==============  =====================================

``train_dispatch`` fires before each boosting iteration is dispatched, in
memory and streamed; ``ckpt_write`` after a snapshot's files are written;
``serve_predict`` at each dispatched serving predict. The JAX package's
``kv_*`` kinds fire at its coordination-service seams, which the port has
not yet (ROADMAP Queue 1 #13 slice b): a plan naming one raises
instead of arming a fault that could never fire.

``hang`` blocks host Python: the in-process ``Supervisor``'s watchdog wakes
it. A CUDA kernel that truly hangs cannot be interrupted from inside its
process; only ``ProcessSupervisor``, which kills and restarts a child, gets
past one.

Determinism: triggers are exact counter matches and the plan's state (fire
counts, call counters) lives in the process, so the same plan against the
same run fires at the same places every time. With no plan installed,
:func:`inject` is two attribute checks.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Optional

from ..log import LightGBMError, Log, outside_slice

# kind -> injection-point name (a seam fires every kind mapped to it)
FAULT_KINDS: Dict[str, str] = {
    "kv_timeout": "kv_get",
    "kv_error": "kv_get",
    "kv_set_error": "kv_set",
    "kv_delay": "kv_get",
    "ckpt_torn": "ckpt_write",
    "kill": "train_dispatch",
    "hang": "train_dispatch",
    "crash": "train_dispatch",
    "serve_error": "serve_predict",
    "serve_delay": "serve_predict",
}

# the injection points that have a seam in the port
PORTED_POINTS = frozenset({"ckpt_write", "train_dispatch", "serve_predict"})

# accepted spellings of the trigger-counter names the seams report
_UNIT_ALIASES = {
    "iter": "iteration", "iterations": "iteration",
    "block": "round", "rounds": "round",
    "req": "request", "requests": "request",
    "snap": "snapshot", "snapshots": "snapshot",
    "call": "calls",
}


class WatchdogAbort(LightGBMError):
    """An injected hang (or another cooperative wait) was aborted by the
    supervisor's watchdog."""


class FaultSpec:
    """One armed fault: ``kind@unit:match[:arg]``."""

    __slots__ = ("kind", "point", "unit", "match", "arg", "fires")

    def __init__(self, kind: str, unit: str, match: Optional[int],
                 arg: Optional[str]):
        self.kind = kind
        self.point = FAULT_KINDS[kind]
        self.unit = unit
        self.match = match          # None == '*' == every occurrence
        self.arg = arg
        self.fires = 0

    def __repr__(self) -> str:
        m = "*" if self.match is None else str(self.match)
        a = ":" + self.arg if self.arg else ""
        return "%s@%s:%s%s" % (self.kind, self.unit, m, a)

    def arg_float(self, default: float) -> float:
        try:
            return float(self.arg) if self.arg else default
        except ValueError:
            return default


class FaultPlan:
    """Parsed ``fault_inject`` plan; owns the per-point call counters."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.faults: List[FaultSpec] = []
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        for token in str(spec).split(","):
            token = token.strip()
            if token:
                self.faults.append(self._parse_token(token))

    @staticmethod
    def _parse_token(token: str) -> FaultSpec:
        if "@" not in token:
            raise LightGBMError(
                "fault_inject token %r: expected kind@unit:match[:arg]"
                % token)
        kind, _, trigger = token.partition("@")
        kind = kind.strip().lower()
        if kind not in FAULT_KINDS:
            raise LightGBMError(
                "fault_inject kind %r unknown (known: %s)"
                % (kind, "/".join(sorted(FAULT_KINDS))))
        if FAULT_KINDS[kind] not in PORTED_POINTS:
            raise outside_slice("fault_inject kind %r (its %s seam is the "
                                "coordination service's)"
                                % (kind, FAULT_KINDS[kind]),
                                "ROADMAP Queue 1 #13 slice b")
        parts = trigger.split(":")
        if len(parts) < 2 or not parts[0]:
            raise LightGBMError(
                "fault_inject token %r: trigger must be unit:match[:arg]"
                % token)
        unit = parts[0].strip().lower()
        unit = _UNIT_ALIASES.get(unit, unit)
        raw = parts[1].strip()
        if raw == "*":
            match: Optional[int] = None
        else:
            try:
                match = int(raw)
            except ValueError:
                raise LightGBMError(
                    "fault_inject token %r: match must be an integer or *"
                    % token)
        arg = ":".join(parts[2:]).strip() or None
        return FaultSpec(kind, unit, match, arg)

    def check(self, point: str, counters: Dict) -> List[FaultSpec]:
        """Faults armed at ``point`` whose trigger matches this call.
        Single-shot faults (integer match) fire at most once; ``*`` faults
        fire every time. The per-point call counter (1-based) backs any
        unit the seam did not pass."""
        with self._lock:
            self._calls[point] = self._calls.get(point, 0) + 1
            ncall = self._calls[point]
            hits = []
            for f in self.faults:
                if f.point != point:
                    continue
                if f.match is not None and f.fires:
                    continue       # single shot, already spent
                value = counters.get(f.unit, ncall)
                if f.match is None or int(value) == f.match:
                    f.fires += 1
                    hits.append(f)
            return hits


_PLAN: Optional[FaultPlan] = None
_ABORT = threading.Event()
_ABORT_REASON: List[str] = []


def parse_plan(spec: str, seed: int = 0) -> FaultPlan:
    """Parse and validate a ``fault_inject`` string; raises LightGBMError
    on a malformed token (config validation calls this)."""
    return FaultPlan(spec, seed)


def install_plan(spec: str, seed: int = 0) -> Optional[FaultPlan]:
    """Install the process-global plan. Re-installing an identical
    (spec, seed) keeps the existing plan: its fire counts survive an
    in-process supervised restart, so a single-shot ``crash@iter:3`` fires
    once, not once an attempt. An empty spec is a no-op (it never clears a
    plan someone else installed; use :func:`clear_plan`)."""
    global _PLAN
    if not str(spec).strip():
        return _PLAN
    if _PLAN is not None and _PLAN.spec == spec and _PLAN.seed == int(seed):
        return _PLAN
    _PLAN = FaultPlan(spec, seed)
    Log.warning("fault injection ARMED: %s (seed=%d)",
                ",".join(repr(f) for f in _PLAN.faults), _PLAN.seed)
    return _PLAN


def clear_plan() -> None:
    global _PLAN
    _PLAN = None
    clear_abort()


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def request_abort(reason: str) -> None:
    """The watchdog's seam: wake any cooperative wait (injected hangs) and
    make the next inject() raise WatchdogAbort."""
    _ABORT_REASON.append(str(reason))
    _ABORT.set()


def clear_abort() -> None:
    _ABORT.clear()
    del _ABORT_REASON[:]


def abort_event() -> threading.Event:
    return _ABORT


def inject(point: str, **counters) -> None:
    """Fire any armed faults at a named injection point. With no plan and
    no abort pending this is two attribute checks."""
    if _ABORT.is_set():
        reason = _ABORT_REASON[-1] if _ABORT_REASON else "watchdog"
        raise WatchdogAbort("aborted at fault point %r: %s" % (point, reason))
    plan = _PLAN
    if plan is None:
        return
    for f in plan.check(point, counters):
        _execute(f, point, counters)


def _execute(f: FaultSpec, point: str, counters: Dict) -> None:
    where = ", ".join("%s=%s" % kv for kv in sorted(counters.items())
                      if kv[0] != "path")
    Log.warning("fault %r firing at %s (%s)", repr(f), point, where)
    if f.kind == "ckpt_torn":
        path = counters.get("path")
        if path and os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                fh.truncate(max(size // 2, 1))
            Log.warning("fault ckpt_torn: truncated %s to %d bytes",
                        path, max(size // 2, 1))
        return
    if f.kind == "kill":
        sig = (signal.SIGTERM if (f.arg or "").lower() == "term"
               else signal.SIGKILL)
        Log.warning("fault kill: sending %s to self", sig.name)
        os.kill(os.getpid(), sig)
        # SIGTERM may be latched (the checkpoint callback) and acted on at
        # the iteration boundary; SIGKILL never returns
        return
    if f.kind == "hang":
        seconds = f.arg_float(3600.0)
        Log.warning("fault hang: blocking up to %.0fs (the abort event "
                    "wakes it)", seconds)
        if _ABORT.wait(timeout=seconds):
            reason = _ABORT_REASON[-1] if _ABORT_REASON else "watchdog"
            raise WatchdogAbort(
                "injected hang at %s aborted: %s" % (point, reason))
        return
    if f.kind == "crash":
        raise LightGBMError("injected crash at %s (%s)" % (point, where))
    if f.kind == "serve_error":
        raise LightGBMError("injected serving fault at %s (%s)"
                            % (point, where))
    if f.kind == "serve_delay":
        time.sleep(f.arg_float(250.0) / 1000.0)
        return
