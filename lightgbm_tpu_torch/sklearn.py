"""scikit-learn estimator wrappers.

The port's own copy of ``lightgbm_tpu/sklearn.py`` (the reference's
python-package/lightgbm/sklearn.py: LGBMModel :133, LGBMRegressor,
LGBMClassifier and LGBMRanker :669, :695, :823, and the adapters of
callable objectives and metrics :18-130). It works without scikit-learn
installed, through plain fallback classes (a ``LabelEncoder`` of
``np.unique`` and ``np.searchsorted``), and registers as a real
scikit-learn estimator when scikit-learn is there.

``device`` is a keyword argument like any other parameter that the
constructor does not name: ``get_params`` and ``clone`` carry it, and
``fit`` trains on it (``None``: CUDA, raising when CUDA is absent).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np

from .basic import Booster, Dataset
from .engine import train as _train
from .log import LightGBMError

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder
    _SKLEARN_INSTALLED = True
except ImportError:
    _SKLEARN_INSTALLED = False

    class BaseEstimator:
        pass

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass

    class LabelEncoder:
        def fit(self, y):
            self.classes_ = np.unique(y)
            return self

        def transform(self, y):
            return np.searchsorted(self.classes_, y)

        def fit_transform(self, y):
            return self.fit(y).transform(y)

        def inverse_transform(self, idx):
            return self.classes_[idx]


class _ObjectiveFunctionWrapper:
    """A scikit-learn style objective ``func(y_true, y_pred[, group])`` as
    ``fobj(preds, dataset)`` (sklearn.py:18-80)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_group())
        else:
            raise TypeError("Self-defined objective should have 2 or 3 args")
        return grad, hess


class _EvalFunctionWrapper:
    """A scikit-learn style metric ``func(y_true, y_pred[, weight[,
    group]])`` as ``feval(preds, dataset)`` (sklearn.py:81-130)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError("Self-defined eval function should have 2-4 args")


class LGBMModel(BaseEstimator):
    """Base estimator (sklearn.py:133)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: int = -1, silent: bool = True,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result = None
        self._best_score = None
        self._best_iteration = None
        self._classes = None
        self._n_classes = None
        self._n_features = None
        self._objective = objective
        self.set_params(**kwargs)

    # -------------------------------------------------- scikit-learn plumbing
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {}
        for key in ("boosting_type", "num_leaves", "max_depth",
                    "learning_rate", "n_estimators", "subsample_for_bin",
                    "objective", "class_weight", "min_split_gain",
                    "min_child_weight", "min_child_samples", "subsample",
                    "subsample_freq", "colsample_bytree", "reg_alpha",
                    "reg_lambda", "random_state", "n_jobs", "silent",
                    "importance_type"):
            params[key] = getattr(self, key)
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if not hasattr(type(self), key):
                self._other_params[key] = value
        return self

    # -------------------------------------------------- fitting
    def _default_objective(self) -> str:
        return "regression"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto",
            callbacks=None) -> "LGBMModel":
        objective = self.objective or self._default_objective()
        fobj = None
        if callable(objective):
            fobj = _ObjectiveFunctionWrapper(objective)
            objective = "none"
        params = self.get_params()
        params.pop("objective", None)
        params.pop("class_weight", None)
        params.pop("importance_type", None)
        params.pop("silent", None)
        params.pop("n_jobs", None)
        params.pop("random_state", None)
        params.pop("n_estimators", None)
        device = params.pop("device", None)
        params["objective"] = objective
        params["verbosity"] = -1 if self.silent else 1
        if self.random_state is not None:
            params["seed"] = self.random_state \
                if isinstance(self.random_state, int) else 0
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        if getattr(self, "_fit_eval_at", None):
            # drop every alias so the fit-time value cannot lose the
            # Config alias-resolution race against a constructor param
            for alias in ("eval_at", "ndcg_eval_at", "ndcg_at",
                          "map_eval_at", "map_at"):
                params.pop(alias, None)
            params["ndcg_eval_at"] = self._fit_eval_at
        feval = _EvalFunctionWrapper(eval_metric) if callable(eval_metric) \
            else None

        X = np.asarray(X, dtype=np.float64) if not hasattr(X, "dtypes") else X
        y = np.asarray(y).reshape(-1)
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, np.float64).reshape(-1)
        if self.class_weight is not None and self._n_classes is None:
            sample_weight = self._apply_class_weight(y, sample_weight)

        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=dict(params),
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            free_raw_data=False, device=device)
        valid_sets = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                    continue
                vw = None
                if eval_sample_weight is not None:
                    vw = eval_sample_weight[i]
                vg = eval_group[i] if eval_group is not None else None
                vi = eval_init_score[i] if eval_init_score is not None else None
                vy_arr = np.asarray(vy).reshape(-1)
                if self._classes is not None:
                    vy_arr = self._le.transform(vy_arr)
                valid_sets.append(train_set.create_valid(
                    vx, label=vy_arr, weight=vw, group=vg, init_score=vi))

        evals_result: Dict = {}
        self._Booster = _train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=eval_names,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result,
            verbose_eval=verbose if not self.silent else False,
            callbacks=callbacks, device=device)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self._n_features = X.shape[1] if hasattr(X, "shape") else len(X[0])
        return self

    def _apply_class_weight(self, y, sample_weight):
        if self.class_weight == "balanced":
            classes, counts = np.unique(y, return_counts=True)
            weights = {c: len(y) / (len(classes) * n)
                       for c, n in zip(classes, counts)}
        else:
            weights = dict(self.class_weight)
        w = np.array([weights.get(v, 1.0) for v in y], np.float64)
        if sample_weight is not None:
            w = w * sample_weight
        return w

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit first")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    # -------------------------------------------------- attributes
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found, call fit first")
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(
            importance_type=self.importance_type)


class LGBMRegressor(LGBMModel, RegressorMixin):
    """sklearn.py:669."""

    def _default_objective(self) -> str:
        return "regression"

    def fit(self, X, y, **kwargs):
        return super().fit(X, y, **kwargs)


class LGBMClassifier(LGBMModel, ClassifierMixin):
    """sklearn.py:695."""

    def _default_objective(self) -> str:
        return "binary"

    def fit(self, X, y, **kwargs):
        self._le = LabelEncoder().fit(np.asarray(y).reshape(-1))
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        y_enc = self._le.transform(np.asarray(y).reshape(-1))
        if self._n_classes > 2:
            if not self.objective or self.objective in ("binary",):
                self.objective = "multiclass"
            self._other_params["num_class"] = self._n_classes
        if self.class_weight is not None:
            kwargs.setdefault("sample_weight", None)
            kwargs["sample_weight"] = self._apply_class_weight(
                y_enc, kwargs.get("sample_weight"))
        return super().fit(X, y_enc, **kwargs)

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration, pred_leaf,
                                    pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim > 1:
            idx = np.argmax(result, axis=1)
        else:
            idx = (result > 0.5).astype(np.int64)
        return self._le.inverse_transform(idx)

    def predict_proba(self, X, raw_score: bool = False, num_iteration=None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        result = super().predict(X, raw_score, num_iteration, pred_leaf,
                                 pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result


class LGBMRanker(LGBMModel):
    """sklearn.py:823."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, eval_set=None, eval_group=None,
            eval_at=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not "
                             "None")
        # NDCG/MAP truncation levels (sklearn.py:880): fit-local only — the
        # estimator's constructor params must not change across fit calls,
        # and an explicit constructor ndcg_eval_at wins when eval_at is
        # not passed (config's own default covers the rest)
        self._fit_eval_at = list(eval_at) if eval_at is not None else None
        try:
            return super().fit(X, y, group=group, eval_set=eval_set,
                               eval_group=eval_group, **kwargs)
        finally:
            self._fit_eval_at = None
