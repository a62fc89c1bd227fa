"""Supervised training: a watchdog, an in-process restart loop and a
process-level one.

The port's own copy of ``lightgbm_tpu/resilience/supervisor.py``:

- :class:`Watchdog`: a deadline on the per-iteration heartbeat the training
  loop emits (a callback before each iteration). The first deadline adds a
  warm-up grace (the first iteration builds and loads the kernels and
  fills the caches). On expiry it sets the fault-injection abort event,
  which wakes cooperative waits (injected hangs) into a
  :class:`~.faults.WatchdogAbort` and makes the next seam raise.

- :class:`Supervisor`: the in-process restart loop behind
  ``train(supervise=True)``: on a crash or a watchdog abort it records the
  flight-dump path the engine attached to the exception (the booster's
  flight recorder, ``obs_flight_recorder`` beside ``obs_event_file``, when
  observability is on; a run without one carries none and the message
  goes without it), sleeps a bounded exponential backoff and re-runs the
  attempt with ``resume_from=checkpoint_dir``: the resumed run ends where
  the uninterrupted one would. An exhausted budget names the last dump.

- :class:`ProcessSupervisor`: the same loop one level up: the trainer is a
  child process (``ProcessSupervisor.train_cli`` runs the port's own
  ``python -m lightgbm_tpu_torch``), so a SIGKILL and a dispatch that never
  returns are survivable. A CUDA kernel that hangs cannot be interrupted
  from inside its process (a watchdog thread can set a flag, not stop the
  card), so only this class gets past one: hang detection rides a
  heartbeat file the trainer touches each iteration
  (``supervise_heartbeat_file``, :func:`heartbeat_file_callback`); a stale
  heartbeat gets the child SIGKILLed and restarted.

The JAX package's ``KvHeartbeat`` keeps per-rank leases in the
coordination service's key-value store, which belongs to the device mesh
(ROADMAP Queue 1 #13): it refuses here.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

from ..log import LightGBMError, Log, outside_slice
from . import faults

ATTEMPT_ENV = "LGBM_SUPERVISOR_ATTEMPT"


def _registry_counter(name: str, doc: str):
    from ..obs.registry import get_registry
    return get_registry().counter(name, doc)


class Watchdog:
    """Heartbeat deadline with a warm-up-aware first window.

    ``beat()`` is called by the training loop each iteration; until the
    first beat the deadline is ``timeout_s + warmup_grace_s``, after it
    plain ``timeout_s``. On expiry ``on_fire(elapsed_s)`` runs once and the
    fault-injection abort event is set so cooperative waits unwind as
    WatchdogAbort.
    """

    def __init__(self, timeout_s: float, warmup_grace_s: float = 0.0,
                 on_fire: Optional[Callable[[float], None]] = None,
                 name: str = "train"):
        self.timeout_s = float(timeout_s)
        self.warmup_grace_s = max(float(warmup_grace_s), 0.0)
        self.on_fire = on_fire
        self.name = name
        self.fired = False
        self.beats = 0
        self._deadline = 0.0
        self._last = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        now = time.monotonic()
        with self._lock:
            self._last = now
            self._deadline = now + self.timeout_s + self.warmup_grace_s
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="lgbm-watchdog-%s" % self.name,
            daemon=True)
        self._thread.start()
        return self

    def beat(self) -> None:
        now = time.monotonic()
        with self._lock:
            self.beats += 1
            self._last = now
            self._deadline = now + self.timeout_s

    def _loop(self) -> None:
        poll = max(min(self.timeout_s / 4.0, 0.5), 0.01)
        while not self._stop.wait(poll):
            with self._lock:
                expired = time.monotonic() > self._deadline
                elapsed = time.monotonic() - self._last
            if expired and not self.fired:
                self.fired = True
                Log.warning("watchdog %r fired: no heartbeat for %.1fs "
                            "(timeout %.1fs%s)", self.name, elapsed,
                            self.timeout_s,
                            ", warmup grace spent" if not self.beats else "")
                faults.request_abort(
                    "watchdog %r: no heartbeat for %.1fs"
                    % (self.name, elapsed))
                if self.on_fire is not None:
                    try:
                        self.on_fire(elapsed)
                    except Exception:   # noqa: BLE001 - a hook never kills
                        pass
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def callback(self):
        """A callback before each iteration that beats this watchdog."""
        wd = self

        class _Beat:
            before_iteration = True
            order = -100          # first: the beat precedes any work

            def __call__(self, env):
                wd.beat()

        return _Beat()


def heartbeat_file_callback(path: str):
    """A callback before each iteration touching ``path``: the
    cross-process heartbeat a :class:`ProcessSupervisor` watches."""

    class _Touch:
        before_iteration = True
        order = -99
        heartbeat_path = path

        def __call__(self, env):
            with open(path, "w") as fh:
                fh.write("%d %.6f\n" % (env.iteration, time.time()))

    return _Touch()


class Supervisor:
    """In-process restart loop: a crash or watchdog abort -> bounded
    exponential backoff -> resume from the newest valid checkpoint ->
    retry, up to ``max_restarts`` restarts."""

    def __init__(self, checkpoint_dir: str, max_restarts: int = 3,
                 backoff_s: float = 1.0, backoff_max_s: float = 60.0,
                 hang_timeout_s: float = 0.0, warmup_grace_s: float = 120.0):
        if not checkpoint_dir:
            raise LightGBMError(
                "supervised training needs checkpoint_dir: auto-resume "
                "has nowhere to resume from")
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = max(int(max_restarts), 0)
        self.backoff_s = max(float(backoff_s), 0.0)
        self.backoff_max_s = max(float(backoff_max_s), self.backoff_s)
        self.hang_timeout_s = max(float(hang_timeout_s), 0.0)
        self.warmup_grace_s = max(float(warmup_grace_s), 0.0)
        self.restarts = 0
        self.last_flight_dump: Optional[str] = None
        self._c_restarts = _registry_counter(
            "lgbm_supervisor_restarts_total",
            "Supervised-training restarts (crash, watchdog, or SIGTERM).")
        self._c_fires = _registry_counter(
            "lgbm_supervisor_watchdog_fires_total",
            "Watchdog deadline expiries during supervised training.")

    def run(self, attempt: Callable):
        """``attempt(resume_from, watchdog)`` until it returns; the first
        try gets ``resume_from=None`` (the caller's own applies), every
        retry the supervisor's checkpoint directory."""
        delay = self.backoff_s
        resume: Optional[str] = None
        while True:
            wd: Optional[Watchdog] = None
            if self.hang_timeout_s > 0:
                wd = Watchdog(self.hang_timeout_s, self.warmup_grace_s,
                              on_fire=lambda _s: self._c_fires.inc())
                wd.start()
            try:
                return attempt(resume, wd)
            except Exception as e:  # noqa: BLE001 - the restart seam
                dump = getattr(e, "flight_dump_path", None)
                if dump:
                    self.last_flight_dump = dump
                self.restarts += 1
                self._c_restarts.inc()
                if self.restarts > self.max_restarts:
                    suffix = (" (last flight dump: %s)" % self.last_flight_dump
                              if self.last_flight_dump else "")
                    raise LightGBMError(
                        "supervised training failed after %d restart%s: "
                        "%s: %s%s" % (self.max_restarts,
                                      "" if self.max_restarts == 1 else "s",
                                      type(e).__name__, e, suffix)) from e
                Log.warning(
                    "supervisor: attempt %d failed (%s: %s); resuming from "
                    "%s in %.1fs%s", self.restarts, type(e).__name__, e,
                    self.checkpoint_dir, delay,
                    " [flight dump %s]" % dump if dump else "")
                time.sleep(delay)
                delay = min(delay * 2.0, self.backoff_max_s)
                resume = self.checkpoint_dir
            finally:
                if wd is not None:
                    wd.stop()
                faults.clear_abort()


class ProcessSupervisor:
    """Restart loop around a trainer child process: survives a SIGKILL and
    a hang no in-process watchdog can interrupt. The child resumes itself
    (its ``resume``/``checkpoint_dir`` make a rerun continue); the
    supervisor only detects death and hangs, backs off and keeps the
    restart budget. Each attempt's index rides the LGBM_SUPERVISOR_ATTEMPT
    environment variable, so a test child can arm a fault on attempt 0
    only."""

    def __init__(self, argv: List[str], max_restarts: int = 3,
                 backoff_s: float = 0.5, backoff_max_s: float = 30.0,
                 hang_timeout_s: float = 0.0, warmup_grace_s: float = 60.0,
                 heartbeat_file: Optional[str] = None,
                 env: Optional[dict] = None, cwd: Optional[str] = None,
                 poll_s: float = 0.25):
        self.argv = list(argv)
        self.max_restarts = max(int(max_restarts), 0)
        self.backoff_s = max(float(backoff_s), 0.0)
        self.backoff_max_s = max(float(backoff_max_s), self.backoff_s)
        self.hang_timeout_s = max(float(hang_timeout_s), 0.0)
        self.warmup_grace_s = max(float(warmup_grace_s), 0.0)
        self.heartbeat_file = heartbeat_file
        self.env = env
        self.cwd = cwd
        self.poll_s = max(float(poll_s), 0.05)
        self.restarts = 0
        self.hang_kills = 0
        self.attempts: List[int] = []     # exit codes, one an attempt

    @classmethod
    def train_cli(cls, args: List[str], **kwargs) -> "ProcessSupervisor":
        """Supervise the port's command line, ``python -m
        lightgbm_tpu_torch`` with ``args`` (``key=value`` words: give it
        ``checkpoint_dir`` and ``resume`` so that a restart continues, and
        ``supervise_heartbeat_file`` with ``hang_timeout_s`` here to catch
        a hang)."""
        return cls([sys.executable, "-m", "lightgbm_tpu_torch"] + list(args),
                   **kwargs)

    def _heartbeat_age(self, started: float) -> float:
        """Seconds since the last heartbeat (the file's mtime), counted from
        the child's start while no heartbeat exists yet."""
        if self.heartbeat_file and os.path.exists(self.heartbeat_file):
            return time.time() - os.path.getmtime(self.heartbeat_file)
        return time.time() - started

    def _run_once(self, attempt: int) -> int:
        env = dict(self.env if self.env is not None else os.environ)
        env[ATTEMPT_ENV] = str(attempt)
        started = time.time()
        warmed = False
        proc = subprocess.Popen(self.argv, env=env, cwd=self.cwd)
        try:
            while True:
                rc = proc.poll()
                if rc is not None:
                    return rc
                if self.hang_timeout_s > 0:
                    age = self._heartbeat_age(started)
                    budget = self.hang_timeout_s + (
                        0.0 if warmed else self.warmup_grace_s)
                    if self.heartbeat_file and \
                            os.path.exists(self.heartbeat_file) and \
                            os.path.getmtime(self.heartbeat_file) >= started:
                        warmed = True
                        budget = self.hang_timeout_s
                    if age > budget:
                        self.hang_kills += 1
                        Log.warning(
                            "process supervisor: heartbeat stale %.1fs "
                            "(> %.1fs); killing pid %d", age, budget,
                            proc.pid)
                        proc.kill()
                        proc.wait(timeout=30)
                        return -9
                time.sleep(self.poll_s)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)

    def run(self) -> int:
        delay = self.backoff_s
        attempt = 0
        while True:
            rc = self._run_once(attempt)
            self.attempts.append(rc)
            if rc == 0:
                return 0
            self.restarts += 1
            if self.restarts > self.max_restarts:
                raise LightGBMError(
                    "process supervisor: command failed after %d restarts "
                    "(exit codes %s): %s"
                    % (self.max_restarts, self.attempts,
                       " ".join(self.argv[:6])))
            Log.warning("process supervisor: attempt %d exited %s; "
                        "restarting in %.1fs", attempt, rc, delay)
            time.sleep(delay)
            delay = min(delay * 2.0, self.backoff_max_s)
            attempt += 1


class KvHeartbeat:
    """The JAX package's per-rank liveness leases in the coordination
    service's key-value store: not ported (the device mesh)."""

    def __init__(self, *args, **kwargs):
        raise outside_slice("KvHeartbeat (per-rank leases in the "
                            "coordination service)", "ROADMAP Queue 1 #13")
