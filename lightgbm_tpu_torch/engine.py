"""Training entry point.

The port of ``lightgbm_tpu/engine.py`` ``train`` (:22; the reference's
python-package/lightgbm/engine.py:19) for the slice's arguments: train on
one device for ``num_boost_round`` iterations and return the Booster.
Validation sets, custom objectives and metrics, callbacks, early stopping,
continued training and learning-rate schedules are later slices and raise.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Union

from .basic import Booster, Dataset
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
    later = [("valid_sets", valid_sets), ("fobj", fobj), ("feval", feval),
             ("init_model", init_model),
             ("early_stopping_rounds", early_stopping_rounds),
             ("evals_result", evals_result),
             ("learning_rates", learning_rates), ("callbacks", callbacks)]
    for name, value in later:
        if value:
            raise outside_slice(name)
    if categorical_feature not in ("auto", None, []):
        raise outside_slice("categorical features", "ROADMAP Queue 1 #4")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    booster = Booster(params=params, train_set=train_set, device=device)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
