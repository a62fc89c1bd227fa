"""User-facing Dataset and Booster.

The port of ``lightgbm_tpu/basic.py`` (``Dataset`` :83, ``Booster`` :441;
the reference's python-package/lightgbm/basic.py) for the slice's
arguments. A ``Dataset`` holds the raw matrix until ``construct()`` bins it
on the host (a validation set with the training set's mappers, through
``reference``); a ``Booster`` trains on, or predicts from, one device, and
evaluates its training and validation sets. A pandas ``DataFrame``'s
``category`` columns are categorical features coded by the training
frame's category order, which the model text keeps in its
``pandas_categorical`` line.

A multiclass booster (``num_class`` K) predicts [N, K] and hands ``fobj``
and ``feval`` its scores as K * N values, class-major, as the reference's
python package does. The JAX package's methods that the port does not
cover yet exist and raise, naming the ROADMAP item that brings them.

Device policy: ``Dataset``, ``Booster`` and ``train`` take ``device``.
``None`` means CUDA; without a CUDA device they raise unless the caller
passes ``device="cpu"``. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .boosting import create_boosting
from .boosting.gbdt import HostTree
from .config import Config, param_dict_to_str
from .device import DeviceLike, resolve_device
from .io import model_text
from .io.dataset import BinnedDataset
from .log import LightGBMError, check, outside_slice
from .metrics import create_metric, default_metric_for_objective
from .objectives import create_objective


def _is_frame(data) -> bool:
    return hasattr(data, "dtypes") and hasattr(data, "columns")


def _pandas_frame_to_array(df, pandas_categorical=None):
    """DataFrame -> (float64 array, its category columns' names, their
    category lists) (basic.py:29-59 of the JAX package; the reference's
    _data_from_pandas, python-package/lightgbm/basic.py:255).

    A ``category`` column becomes its integer codes, NaN where missing or
    unseen. Training records each column's category order; prediction and
    validation sets pass it back, so a raw category maps to the same code
    wherever the model is used. The frame's own methods do the work: this
    module never imports pandas."""
    cat_cols = [c for c in df.columns if str(df[c].dtype) == "category"]
    if pandas_categorical is not None:
        # a frame that lost its category dtypes would be read as raw codes
        check(len(pandas_categorical) == len(cat_cols),
              "train and predict data have different categorical columns")
    if not cat_cols:
        return df.values.astype(np.float64), [], pandas_categorical
    df = df.copy(deep=False)
    if pandas_categorical is None:     # training: record category order
        pandas_categorical = [list(df[c].cat.categories) for c in cat_cols]
    else:                              # prediction: the trained order
        for c, cats in zip(cat_cols, pandas_categorical):
            df[c] = df[c].cat.set_categories(cats)
    for c in cat_cols:
        codes = df[c].cat.codes.astype(np.float64)
        df[c] = codes.where(codes >= 0, np.nan)
    return (df.values.astype(np.float64), [str(c) for c in cat_cols],
            pandas_categorical)


def _to_2d_float(data) -> np.ndarray:
    """Dense ndarray / list / DataFrame -> float64 [N, F]."""
    if hasattr(data, "tocsc") and hasattr(data, "nnz"):
        raise outside_slice("sparse input", "ROADMAP Queue 1 #16")
    if _is_frame(data):
        data = _pandas_frame_to_array(data)[0]
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    check(arr.ndim == 2, "Data must be 2-D")
    return arr


def _to_1d(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if hasattr(x, "values"):
        x = x.values
    return np.asarray(x, dtype=np.float64).reshape(-1)


def _not_ported(name: str, item: str):
    """A method of the JAX package's that the port lacks: it raises
    ``outside_slice``, citing ROADMAP Queue 1 ``item``."""
    def method(self, *args, **kwargs):
        raise outside_slice("%s.%s" % (type(self).__name__, name),
                            "ROADMAP Queue 1 %s" % item)
    method.__name__ = name
    method.__doc__ = "Not ported yet (ROADMAP Queue 1 %s): raises." % item
    return method


def _class_major(scores: np.ndarray) -> np.ndarray:
    """Raw scores as ``fobj`` and ``feval`` take them: [N] for one class,
    K * N values class-major for K (basic.py:611 of the JAX package)."""
    return scores if scores.ndim == 1 else scores.reshape(-1, order="F")


def _category_json(v):
    """A numpy category value as JSON: a numeric category must stay
    numeric, or ``set_categories`` matches nothing when the model is
    loaded."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return str(v)


class Dataset:
    """Dataset in LightGBM (basic.py:656): lazily binned training data."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None, silent=False,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None
        self._predictor: Optional[_InnerPredictor] = None
        self.pandas_categorical = None

    def construct(self) -> "Dataset":
        """Bin the raw matrix on the host (basic.py _lazy_init:693-800); a
        validation set takes its reference's mappers."""
        if self._binned is not None:
            return self
        if isinstance(self.data, str):
            raise outside_slice("loading data from files",
                                "ROADMAP Queue 1 #16")
        ref_binned = (None if self.reference is None
                      else self.reference.construct()._binned)
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        if names is None and hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        data, frame_cats = self.data, []
        if _is_frame(data):
            if self.pandas_categorical is None and self.reference is not None:
                # a valid set codes categories in the training set's order
                self.pandas_categorical = self.reference.pandas_categorical
            data, frame_cats, self.pandas_categorical = \
                _pandas_frame_to_array(data, self.pandas_categorical)
        cat = (None if self.categorical_feature in ("auto", None)
               else self.categorical_feature)
        if frame_cats:
            # a frame's category columns are categorical whether or not
            # they are listed (the reference's auto-detection)
            cat = list(cat) if cat else []
            cat.extend(c for c in frame_cats if c not in cat)
        self._binned = BinnedDataset.from_matrix(
            _to_2d_float(data), Config(self.params),
            label=_to_1d(self.label), weight=_to_1d(self.weight),
            init_score=_to_1d(self.init_score), group=_to_1d(self.group),
            feature_names=names,
            categorical_feature=cat, reference=ref_binned)
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent=False, params=None) -> "Dataset":
        """basic.py:843: a validation set binned with this Dataset's
        mappers, on its device."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, silent=silent,
                       params=params or self.params, device=self.device)

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """basic.py:402 of the JAX package: the categorical features,
        before the data are binned."""
        check(self._binned is None,
              "Cannot set categorical feature after dataset was constructed")
        self.categorical_feature = categorical_feature
        return self

    def _set_predictor(self, predictor: Optional["_InnerPredictor"]
                       ) -> "Dataset":
        self._predictor = predictor
        return self

    def num_data(self) -> int:
        return self.construct()._binned.num_data

    def num_feature(self) -> int:
        return self.construct()._binned.num_total_features

    def get_feature_name(self) -> List[str]:
        return list(self.construct()._binned.feature_names)

    def get_label(self):
        return self.construct()._binned.metadata.label

    def get_weight(self):
        return self.construct()._binned.metadata.weight

    def get_init_score(self):
        return self.construct()._binned.metadata.init_score

    def set_group(self, group) -> "Dataset":
        """basic.py:333-337 of the JAX package: the queries' sizes, kept
        for binning or set on the binned data's metadata."""
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)
        return self

    def get_group(self):
        """The queries' sizes, None without query groups (basic.py:368-371
        of the JAX package)."""
        qb = self.construct()._binned.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    subset = _not_ported("subset", "#17")
    set_label = _not_ported("set_label", "#17")
    set_weight = _not_ported("set_weight", "#17")
    set_init_score = _not_ported("set_init_score", "#17")
    set_reference = _not_ported("set_reference", "#17")
    set_field = _not_ported("set_field", "#17")
    get_field = _not_ported("get_field", "#17")
    save_binary = _not_ported("save_binary", "#16")


class _InnerPredictor:
    """Continued training (basic.py:346): an init model that gives a new
    run its init scores and its first trees."""

    def __init__(self, booster: "Booster"):
        self.booster = booster

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        return self.booster.predict(x, raw_score=True)

    def models(self) -> List:
        """The init model's trees, capped like ``predict_raw``: at its best
        iteration where it has one, so that the merged trees are the ones
        the init scores came from."""
        impl = self.booster._impl
        best = self.booster.best_iteration
        return (impl.models[:best * impl.num_tree_per_iteration] if best > 0
                else impl.models)


class Booster:
    """Booster in LightGBM (basic.py:1578), on one device."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, silent=False,
                 device: DeviceLike = None):
        self.params = copy.deepcopy(params) if params else {}
        self.device = resolve_device(device)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set: Optional[Dataset] = None
        self._valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.train_set_name = "training"
        self._feature_names_loaded: List[str] = []
        self._feature_infos_loaded: List[str] = []
        self.pandas_categorical = None
        if train_set is not None:
            check(isinstance(train_set, Dataset),
                  "Training data should be Dataset instance")
            self._init_from_train_set(train_set)
        elif model_file is not None:
            with open(model_file, "r") as fh:
                self._init_from_string(fh.read())
        elif model_str is not None:
            self._init_from_string(model_str)
        else:
            # a predict-only booster with no trees yet (``from_forest``)
            self._init_from_forest([], [], [])

    @classmethod
    def from_forest(cls, models: List, feature_names: List[str],
                    feature_infos: List[str],
                    params: Optional[Dict[str, Any]] = None,
                    device: DeviceLike = None) -> "Booster":
        """A predict-only booster over host trees (``convert.py``)."""
        booster = cls(params=params or {"objective": "binary"}, device=device)
        booster._init_from_forest(list(models), feature_names, feature_infos)
        return booster

    def _init_from_train_set(self, train_set: Dataset) -> None:
        if train_set.device != self.device:
            raise ValueError("the Dataset is on %s but the Booster on %s"
                             % (train_set.device, self.device))
        if train_set._binned is None:
            train_set.params = {**train_set.params, **self.params}
        predictor = train_set._predictor
        init_raw = None
        if predictor is not None:
            # continued training: the init model's raw predictions seed the
            # scores (basic.py:495-499 of the JAX package)
            check(train_set.data is not None,
                  "continued training needs the training set's raw data: "
                  "pass an unconstructed Dataset or free_raw_data=False")
            init_raw = predictor.predict_raw(train_set.data)
        train_set.construct()
        if init_raw is not None:
            train_set._binned.metadata.set_init_score(_class_major(init_raw))
        self._train_set = train_set
        self.pandas_categorical = train_set.pandas_categorical
        self.config = Config(self.params)
        objective = create_objective(self.config)
        names = list(self.config.metric)
        if not names:
            default = default_metric_for_objective(self.config.objective)
            names = [default] if default else []
        self._metric_names = [n for n in names if n and n != "None"]
        metrics = [m for m in (create_metric(n, self.config)
                               for n in self._metric_names) if m]
        self._impl = create_boosting(self.config, train_set._binned,
                                     objective, metrics, self.device)
        if predictor is not None:
            init_k = predictor.booster.num_model_per_iteration()
            check(init_k == self._impl.num_tree_per_iteration,
                  "init model has %d trees per iteration but the new "
                  "parameters produce %d"
                  % (init_k, self._impl.num_tree_per_iteration))
            # the booster is self-contained: the init model's trees come
            # first (LGBM_BoosterMerge -> GBDT::MergeFrom, gbdt.h:53)
            self._impl.merge_init_models(predictor.models())

    def _init_from_forest(self, models: List, feature_names: List[str],
                          feature_infos: List[str]) -> None:
        """A predict-only booster over host trees, of the class of
        ``boosting`` (an RF averages its trees)."""
        self.config = Config(self.params)
        self._impl = create_boosting(self.config, None,
                                     create_objective(self.config), [],
                                     self.device)
        self._impl.models = models
        self._feature_names_loaded = list(feature_names)
        self._feature_infos_loaded = list(feature_infos)

    def _init_from_string(self, model_str: str) -> None:
        # the pandas_categorical sidecar, 'null' or absent in models that
        # had no category columns (basic.py:526-533 of the JAX package)
        for line in model_str.splitlines()[::-1]:
            if line.startswith("pandas_categorical:"):
                try:
                    self.pandas_categorical = json.loads(
                        line[len("pandas_categorical:"):])
                except ValueError:
                    pass
                break
        parsed = model_text.parse_model_string(model_str)
        tokens = parsed["objective"].split()
        if tokens:
            self.params.setdefault("objective", tokens[0])
            for tok in tokens[1:]:
                if ":" in tok:
                    k, v = tok.split(":", 1)
                    self.params.setdefault(k, v)
                elif tok == "sqrt":
                    self.params.setdefault("reg_sqrt", True)
        if parsed["num_class"] > 1:
            self.params["num_class"] = parsed["num_class"]
        self._init_from_forest(parsed["trees"], parsed["feature_names"],
                               parsed["feature_infos"])
        self._impl.num_tree_per_iteration = parsed["num_tree_per_iteration"]
        # a loaded model is a GBDT that averages where its text says so
        # (basic.py:561 of the JAX package)
        self._impl.average_output = parsed["average_output"]

    # ------------------------------------------------------------ training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """basic.py:1804: evaluate ``data`` (binned with the training set's
        mappers) after every iteration."""
        check(isinstance(data, Dataset), "Validation data should be Dataset")
        if data.device != self.device:
            raise ValueError("the validation Dataset is on %s but the "
                             "Booster on %s" % (data.device, self.device))
        if data.reference is None:
            data.reference = self._train_set
        data.construct()
        metrics = [m for m in (create_metric(n, self.config)
                               for n in self._metric_names) if m]
        self._impl.add_valid_data(data._binned, metrics)
        self._valid_sets.append(data)
        self.name_valid_sets.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting round (basic.py:1843). Returns True if stopped.

        ``fobj(raw training scores, training Dataset)`` returns the
        gradients and hessians of a custom objective in numpy; they take the
        objective's place for this round (basic.py:577-618 of the JAX
        package)."""
        if train_set is not None and train_set is not self._train_set:
            raise outside_slice("resetting the training data",
                                "ROADMAP Queue 1 #20")
        if fobj is None:
            return self._impl.train_one_iter()
        return self._impl.train_one_iter(*self._custom_gradients(fobj))

    def _custom_gradients(self, fobj):
        """``fobj``'s gradients and hessians of the training scores, on
        the booster's device and class-major: the scores' copy to the host,
        the call, and the two copies back, each blocking."""
        grad, hess = fobj(_class_major(self._impl.scores_of(0)),
                          self._train_set)
        return (self._impl.device_gradients(grad, "grad").reshape(-1),
                self._impl.device_gradients(hess, "hess").reshape(-1))

    def rollback_one_iter(self) -> "Booster":
        """basic.py:1934: drop the last iteration's trees, one a class."""
        self._impl.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """basic.py reset_parameter: change parameters between iterations
        (the learning rate of the next trees)."""
        self.params.update(params)
        self.config.set(params)
        self._impl.shrinkage_rate = self.config.learning_rate
        return self

    def current_iteration(self) -> int:
        return self._impl.current_iteration

    def num_trees(self) -> int:
        return len(self._impl.models)

    def num_model_per_iteration(self) -> int:
        """Trees an iteration: K for a K-class multiclass model, else 1."""
        return self._impl.num_tree_per_iteration

    def num_feature(self) -> int:
        return len(self._feature_names())

    def eval_train(self, feval=None):
        return self._inner_eval(self.train_set_name, 0, feval)

    def eval_valid(self, feval=None):
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self._inner_eval(name, i + 1, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None):
        if data is self._train_set:
            return self.eval_train(feval)
        for i, vs in enumerate(self._valid_sets):
            if data is vs:
                return self._inner_eval(name, i + 1, feval)
        raise LightGBMError("Data should be a validation set added via "
                            "add_valid")

    def _inner_eval(self, name: str, data_idx: int, feval=None):
        """(name, metric, value, bigger_better) of the booster's metrics on
        the training set (0) or a valid set, then of ``feval(raw scores,
        Dataset)``, which returns one such triple after the name or a list
        of them."""
        out = [(name, m, v, bb)
               for _, m, v, bb in self._impl.get_eval_at(data_idx)]
        if feval is not None:
            ds = (self._train_set if data_idx == 0
                  else self._valid_sets[data_idx - 1])
            res = feval(_class_major(self._impl.scores_of(data_idx)), ds)
            for r in (res if isinstance(res, list)
                      else [] if res is None else [res]):
                out.append((name, r[0], r[1], r[2]))
        return out

    # ------------------------------------------------------------ prediction
    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Raw scores or probabilities for raw feature rows, on the
        booster's device."""
        if isinstance(data, Dataset):
            raise LightGBMError("Cannot use Dataset instance for prediction, "
                                "please use raw data instead")
        if pred_leaf or pred_contrib or kwargs.get("pred_early_stop"):
            raise outside_slice("pred_leaf, pred_contrib and pred_early_stop",
                                "ROADMAP Queue 1 #8")
        if _is_frame(data) and self.pandas_categorical is not None:
            data = _pandas_frame_to_array(data, self.pandas_categorical)[0]
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        return self._impl.predict(_to_2d_float(data),
                                  num_iteration=num_iteration,
                                  raw_score=raw_score)

    # ------------------------------------------------------------ model IO
    def _feature_names(self) -> List[str]:
        if self._train_set is not None:
            return self._train_set.get_feature_name()
        return list(self._feature_names_loaded)

    def _feature_infos(self) -> List[str]:
        if self._train_set is not None:
            return self._train_set.construct()._binned.get_feature_infos()
        return list(self._feature_infos_loaded)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        out = model_text.model_to_string(
            self._impl, self._feature_names(), self._feature_infos(),
            num_iteration=num_iteration, start_iteration=start_iteration,
            parameters=param_dict_to_str(self.params))
        # the reference's python package appends this sidecar line, so raw
        # pandas categories survive save and load (_dump_pandas_categorical)
        return out + "\npandas_categorical:%s\n" % json.dumps(
            self.pandas_categorical, default=_category_json)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = self._impl.feature_importance(importance_type, iteration)
        return imp.astype(np.int64) if importance_type == "split" else imp

    def feature_name(self) -> List[str]:
        return self._feature_names()

    @property
    def models(self) -> List[HostTree]:
        return self._impl.models

    dump_model = _not_ported("dump_model", "#17")
    get_split_value_histogram = _not_ported("get_split_value_histogram",
                                            "#17")
    get_leaf_output = _not_ported("get_leaf_output", "#17")
    refit = _not_ported("refit", "#15")
    reset_training_data = _not_ported("reset_training_data", "#20")
    as_serving_bundle = _not_ported("as_serving_bundle", "#10")
    set_network = _not_ported("set_network", "#13")
    free_network = _not_ported("free_network", "#13")
