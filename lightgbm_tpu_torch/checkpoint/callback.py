"""The ``checkpoint(...)`` training callback: periodic and SIGTERM snapshots.

The port's own copy of ``lightgbm_tpu/checkpoint/callback.py``. It runs
after each iteration, between record_evaluation (20) and early_stopping
(30), so a snapshot at iteration *i* already carries *i*'s eval history
but is written before an early stop unwinds the loop.

It does not declare ``only_consumes_evals``: its presence puts the engine
on the per-iteration path instead of ``GBDT.train_many``, whose blocked
key derivation differs. That is what the determinism guarantee rests on:
a checkpointed run and its resumed continuation walk the same key stream.

SIGTERM (a preemption notice) is latched by a signal handler and honoured
at the next iteration boundary, the only point where the training state is
consistent (on the card, the iteration's kernels have finished once its
trees are on the host): the snapshot is written, then the previous handler
is restored and the signal raised again, so the process still dies as a
SIGTERM'd one (exit 143, or -15 seen from a parent).

Each save runs in a ``checkpoint_save`` span of the booster's telemetry
(``obs/trace.py``; a no-op under ``observability=none``) and counts in the
metrics registry. On SIGTERM the latch flushes the booster's event stream
and dumps its flight recorder (``obs.crash_flush("sigterm")``) before it
re-delivers the signal.
"""
from __future__ import annotations

import collections
import signal
import threading
from typing import Any, Dict, Optional

from ..log import Log
from .manager import CheckpointManager


class _Checkpoint:
    before_iteration = False
    order = 25
    is_checkpoint = True

    def __init__(self, directory: str, period: int = 1,
                 keep_last_n: int = 3, on_sigterm: bool = True):
        self.manager = CheckpointManager(directory, keep_last_n=keep_last_n)
        self.period = int(period)
        self.on_sigterm = bool(on_sigterm)
        self.history: Dict[str, Dict[str, list]] = {}
        self._sigterm = False
        self._prev_handler: Any = None
        self._installed = False

    def seed_history(self, history: Dict[str, Dict[str, list]]) -> None:
        """Pre-fill the eval history from a restored snapshot, so later
        snapshots carry the whole record, not just the resumed tail."""
        self.history = {d: collections.OrderedDict(
            (m, list(v)) for m, v in per.items())
            for d, per in (history or {}).items()}

    def _install_sigterm(self) -> None:
        if self._installed or not self.on_sigterm:
            return
        self._installed = True
        if threading.current_thread() is not threading.main_thread():
            Log.warning("checkpoint: not on the main thread; SIGTERM "
                        "snapshotting disabled for this run")
            return
        try:
            self._prev_handler = signal.signal(signal.SIGTERM, self._latch)
        except ValueError:   # no signal support in this context
            self._prev_handler = None

    def _latch(self, signum, frame) -> None:
        # only latch: the training state is mid-iteration here, so the
        # snapshot happens at the next callback after an iteration
        self._sigterm = True

    def _resign(self) -> None:
        """Put the previous handler back and deliver SIGTERM again."""
        try:
            signal.signal(signal.SIGTERM,
                          self._prev_handler or signal.SIG_DFL)
        except ValueError:
            pass
        signal.raise_signal(signal.SIGTERM)

    def _early_stopping_state(self, env) -> Optional[list]:
        for cb in getattr(env.model, "_callbacks", []) or []:
            get_state = getattr(cb, "get_state", None)
            if get_state is not None and hasattr(cb, "stopping_rounds"):
                return get_state()
        return None

    def __call__(self, env) -> None:
        self._install_sigterm()
        if not hasattr(env.model, "_impl"):
            return   # cv's CVBooster: per-fold checkpoints are not kept
        for entry in env.evaluation_result_list or []:
            per = self.history.setdefault(entry[0], collections.OrderedDict())
            per.setdefault(entry[1], []).append(entry[2])

        it = env.iteration + 1
        due = (self.period > 0 and it % self.period == 0) \
            or it == env.end_iteration or self._sigterm
        if due:
            eval_entry = next(
                (e for e in env.evaluation_result_list or []
                 if e[0] not in ("training",
                                 getattr(env.model, "train_set_name",
                                         "training"))),
                None)
            train_loop: Dict[str, Any] = {"eval_history": self.history}
            es = self._early_stopping_state(env)
            if es is not None:
                train_loop["early_stopping"] = es
            with env.model._impl.obs.span("checkpoint_save", iteration=it):
                self.manager.save(env.model, train_loop=train_loop,
                                  eval_entry=eval_entry)
            from ..obs.registry import get_registry
            get_registry().counter(
                "lgbm_checkpoint_saves_total",
                "Training checkpoints written.").inc()
        if self._sigterm:
            Log.warning("checkpoint: SIGTERM received; snapshot saved at "
                        "iteration %d in %s; exiting", it,
                        self.manager.directory)
            # fsync the event stream and dump the flight recorder while the
            # training state is coherent; _resign() re-delivers SIGTERM to
            # the previous handler (the recorder's, whose dump has latched)
            env.model._impl.obs.crash_flush("sigterm")
            self._resign()


def checkpoint(directory: str, period: int = 1, keep_last_n: int = 3,
               on_sigterm: bool = True) -> _Checkpoint:
    """The checkpoint callback: snapshots the complete training state into
    ``directory`` every ``period`` iterations, at the last iteration and on
    SIGTERM (at the next iteration boundary); keeps the newest
    ``keep_last_n`` snapshots and the best so far by validation metric."""
    return _Checkpoint(directory, period=period, keep_last_n=keep_last_n,
                       on_sigterm=on_sigterm)
