"""Training callbacks.

The port's own copy of ``lightgbm_tpu/callback.py`` (the reference's
python-package/lightgbm/callback.py contract): factories return callables
that receive a ``CallbackEnv`` before or after each iteration; ``order``
sequences them, ``before_iteration`` picks the phase, and
``EarlyStopException`` unwinds the training loop. This module has
``print_evaluation``, ``record_evaluation``, ``reset_parameter`` and
``early_stopping``; the JAX package's observability and checkpoint
callbacks raise, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

from .log import Log, outside_slice

# Parameters that would change the model's shape mid-training; resetting
# them is refused (the reference refuses the same set).
_IMMUTABLE_DURING_TRAIN = frozenset({
    "num_class", "num_classes", "boosting", "boost", "boosting_type",
    "metric", "metrics", "metric_types"})


class EarlyStopException(Exception):
    """Raised by early_stopping to unwind the boosting loop."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _eval_text(entry, show_stdv: bool = True) -> str:
    """One evaluation tuple as text: 4 fields for a plain evaluation, 5 for
    a cross-validation mean with its standard deviation."""
    data_name, metric_name, value = entry[0], entry[1], entry[2]
    text = "%s's %s: %g" % (data_name, metric_name, value)
    if len(entry) == 5 and show_stdv:
        text += " + %g" % entry[4]
    elif len(entry) not in (4, 5):
        raise ValueError("evaluation entry must have 4 or 5 fields, got %d"
                         % len(entry))
    return text


class _PrintEvaluation:
    before_iteration = False
    order = 10
    # a no-op on an iteration with no evaluation results, so the engine may
    # take the fused key stream (lightgbm_tpu/callback.py:57)
    only_consumes_evals = True

    def __init__(self, period: int, show_stdv: bool):
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        it = env.iteration + 1
        if it % self.period == 0:
            Log.info("[%d]\t%s", it, "\t".join(
                _eval_text(e, self.show_stdv)
                for e in env.evaluation_result_list))


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log the evaluation results every ``period`` iterations."""
    return _PrintEvaluation(period, show_stdv)


class _RecordEvaluation:
    before_iteration = False
    order = 20
    only_consumes_evals = True

    def __init__(self, store: Dict[str, Dict[str, List[float]]]):
        self.store = store

    def __call__(self, env: CallbackEnv) -> None:
        for entry in env.evaluation_result_list:
            data_name, metric_name, value = entry[0], entry[1], entry[2]
            per_data = self.store.setdefault(data_name,
                                             collections.OrderedDict())
            per_data.setdefault(metric_name, []).append(value)


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    """Append each iteration's evaluation values to ``eval_result`` in
    place."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result must be a dict, got %s"
                        % type(eval_result).__name__)
    eval_result.clear()
    return _RecordEvaluation(eval_result)


class _ResetParameter:
    before_iteration = True
    order = 10

    def __init__(self, schedules: Dict[str, Any]):
        for key in schedules:
            if key in _IMMUTABLE_DURING_TRAIN:
                raise RuntimeError("Cannot reset %r during training" % key)
        self.schedules = schedules

    def _value_at(self, key: str, value, step: int, total: int):
        if callable(value):
            return value(step)
        if len(value) != total:
            raise ValueError(
                "schedule list for %r has %d entries; expected "
                "num_boost_round = %d" % (key, len(value), total))
        return value[step]

    def __call__(self, env: CallbackEnv) -> None:
        step = env.iteration - env.begin_iteration
        total = env.end_iteration - env.begin_iteration
        changed = {}
        for key, value in self.schedules.items():
            new = self._value_at(key, value, step, total)
            if env.params.get(key) != new:
                changed[key] = new
        if changed:
            env.model.reset_parameter(changed)
            env.params.update(changed)


def reset_parameter(**kwargs) -> Callable:
    """Per-iteration parameter schedules: each keyword is a list indexed by
    iteration or a callable ``iteration -> value`` (a learning-rate decay,
    for example)."""
    return _ResetParameter(kwargs)


class _EarlyStopping:
    before_iteration = False
    order = 30

    def __init__(self, stopping_rounds: int, first_metric_only: bool,
                 verbose: bool):
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.enabled: Optional[bool] = None   # decided on the first call
        self.state: List[dict] = []           # one slot per eval entry

    def _start(self, env: CallbackEnv) -> None:
        self.enabled = all(
            env.params.get(a) != "dart"
            for a in ("boosting", "boosting_type", "boost"))
        if not self.enabled:
            Log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("early stopping needs at least one validation "
                             "set with an eval metric")
        if self.verbose:
            Log.info("Training until validation scores don't improve for %d "
                     "rounds.", self.stopping_rounds)
        for entry in env.evaluation_result_list:
            bigger_better = bool(entry[3])
            self.state.append({
                "best": float("-inf") if bigger_better else float("inf"),
                "bigger_better": bigger_better,
                "best_iter": 0,
                "best_entries": None,
            })

    def _finish(self, slot: dict, reason: str) -> None:
        if self.verbose:
            Log.info("%s Best iteration is:\n[%d]\t%s", reason,
                     slot["best_iter"] + 1,
                     "\t".join(_eval_text(e) for e in slot["best_entries"]))
        raise EarlyStopException(slot["best_iter"], slot["best_entries"])

    def __call__(self, env: CallbackEnv) -> None:
        if self.enabled is None:
            self._start(env)
        if not self.enabled:
            return
        for i, entry in enumerate(env.evaluation_result_list):
            slot = self.state[i]
            value = entry[2]
            better = (value > slot["best"] if slot["bigger_better"]
                      else value < slot["best"])
            if slot["best_entries"] is None or better:
                slot.update(best=value, best_iter=env.iteration,
                            best_entries=env.evaluation_result_list)
            # the training set never triggers a stop, only validations do
            is_train = entry[0] in ("training",
                                    getattr(env.model, "train_set_name",
                                            "training"))
            if not is_train:
                if env.iteration - slot["best_iter"] >= self.stopping_rounds:
                    self._finish(slot, "Early stopping.")
                if env.iteration == env.end_iteration - 1:
                    self._finish(slot, "Did not meet early stopping.")
            if self.first_metric_only:
                break


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop when no validation metric improved for ``stopping_rounds``
    iterations in a row; the exception carries the best iteration."""
    return _EarlyStopping(stopping_rounds, first_metric_only, verbose)


def export_eval_metrics(registry=None) -> Callable:
    """The JAX package's metrics-registry export, not ported yet."""
    raise outside_slice("the export_eval_metrics callback (observability)",
                        "ROADMAP Queue 1 #15")


def health_monitor(*args, **kwargs) -> Callable:
    """The JAX package's device health monitor, not ported yet."""
    raise outside_slice("the health_monitor callback (observability)",
                        "ROADMAP Queue 1 #15")


def checkpoint(*args, **kwargs) -> Callable:
    """The JAX package's checkpoint callback, not ported yet."""
    raise outside_slice("the checkpoint callback", "ROADMAP Queue 1 #12")
