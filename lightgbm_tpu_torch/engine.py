"""Training entry point.

The port of ``lightgbm_tpu/engine.py`` ``train`` (:22, its ``_train_once``
:99-290; the reference's python-package/lightgbm/engine.py:19, boost loop
:211-236): train on one device with validation sets, ``feval``, callbacks,
early stopping, learning-rate schedules, continued training from an
``init_model``, custom objectives (``fobj``, which sets
``objective="none"``), categorical features and row sampling (bagging,
GOSS, DART, RF). Where the JAX engine fuses its loop (no valid sets, no
``fobj``, no callback before an iteration, and only callbacks after one
that read evaluation results, which such a run has none of), the port
trains through ``GBDT.train_many``, so that its bagging and GOSS draws
follow the same key stream (engine.py:221-229 there). Callbacks run before and
after each iteration, ``EarlyStopException`` unwinds the loop and sets
``best_iteration``, and ``evals_result`` records the history.
Checkpoints and ``cv`` raise, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, List, Optional, Union

from . import callback
from .basic import Booster, Dataset, _InnerPredictor
from .device import DeviceLike
from .log import outside_slice

_NUM_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                      "num_tree", "num_trees", "num_round", "num_rounds",
                      "n_estimators")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: Union[str, List[str]] = "auto",
          categorical_feature: Union[str, List] = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          learning_rates: Optional[Union[List[float], Callable]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          device: DeviceLike = None) -> Booster:
    """engine.py:19 — train a Booster on ``device`` (CUDA unless the
    caller passes ``device="cpu"``)."""
    params = copy.deepcopy(params) if params else {}
    for alias in _NUM_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in ("early_stopping_round", "early_stopping_rounds",
                  "early_stopping"):
        if params.get(alias) is not None:
            early_stopping_rounds = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    if isinstance(init_model, str):
        init_model = Booster(model_file=init_model, device=device)
    # set on every call, so a Dataset reused without an init model does not
    # keep an earlier run's
    train_set._set_predictor(None if init_model is None
                             else _InnerPredictor(init_model))

    booster = Booster(params=params, train_set=train_set, device=device)
    if booster.config.checkpoint_dir or booster.config.resume:
        raise outside_slice("checkpoints and resume", "ROADMAP Queue 1 #12")
    is_valid_contain_train = False
    fused = valid_sets is None and fobj is None
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        names = valid_names or ["valid_%d" % i for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, names):
            if vs is train_set:
                is_valid_contain_train = True
                booster.train_set_name = name
                continue
            booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback.early_stopping(
            early_stopping_rounds,
            first_metric_only=bool(booster.config.first_metric_only)))
    if verbose_eval is True:
        cbs.append(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.append(callback.print_evaluation(verbose_eval))
    if evals_result is not None:
        cbs.append(callback.record_evaluation(evals_result))
    if learning_rates is not None:
        cbs.append(callback.reset_parameter(learning_rate=learning_rates))
    # sorted stably, so callbacks of equal order run as registered
    cbs_before = sorted((c for c in cbs
                         if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs
                        if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))

    begin = booster.current_iteration()
    end = begin + num_boost_round
    evaluation_result_list = []
    if fused and not cbs_before and all(
            getattr(c, "only_consumes_evals", False) for c in cbs_after):
        # nothing reads the booster between iterations: the JAX engine's
        # fused loop, and its key stream
        booster._impl.train_many(num_boost_round)
        end = begin
    for i in range(begin, end):
        for cb in cbs_before:
            cb(callback.CallbackEnv(model=booster, params=params, iteration=i,
                                    begin_iteration=begin, end_iteration=end,
                                    evaluation_result_list=None))
        stopped = booster.update(fobj=fobj)
        evaluation_result_list = []
        if is_valid_contain_train:
            evaluation_result_list.extend(booster.eval_train(feval))
        evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=begin, end_iteration=end,
                    evaluation_result_list=evaluation_result_list))
        except callback.EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            evaluation_result_list = stop.best_score
            break
        if stopped:
            break

    booster.best_score = collections.defaultdict(dict)
    for data_name, eval_name, score, _ in evaluation_result_list or []:
        booster.best_score[data_name][eval_name] = score
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster
