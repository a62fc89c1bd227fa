"""User-facing Dataset and Booster.

The port of ``lightgbm_tpu/basic.py`` (``Dataset`` :83, ``Booster`` :441;
the reference's python-package/lightgbm/basic.py) for the slice's
arguments. A ``Dataset`` holds the raw matrix until ``construct()`` bins it
on the host; a ``Booster`` trains on, or predicts from, one device.

Device policy: ``Dataset``, ``Booster`` and ``train`` take ``device``.
``None`` means CUDA; without a CUDA device they raise unless the caller
passes ``device="cpu"``. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .boosting.gbdt import GBDT, HostTree
from .config import Config, param_dict_to_str
from .device import DeviceLike, resolve_device
from .io import model_text
from .io.dataset import BinnedDataset
from .log import LightGBMError, check, outside_slice
from .metrics import create_metric
from .objectives import create_objective


def _to_2d_float(data) -> np.ndarray:
    """Dense ndarray / list / numeric DataFrame -> float64 [N, F]."""
    if hasattr(data, "tocsc") and hasattr(data, "nnz"):
        raise outside_slice("sparse input", "ROADMAP Queue 1 #16")
    if hasattr(data, "dtypes") and hasattr(data, "columns"):
        if any(str(t) == "category" for t in data.dtypes):
            raise outside_slice("categorical (pandas category) columns")
        data = data.values
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


class Dataset:
    """Dataset in LightGBM (basic.py:656): lazily binned training data."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None, silent=False,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, device: DeviceLike = None):
        if group is not None:
            raise outside_slice("query groups (ranking)")
        if reference is not None:
            raise outside_slice("validation sets (a Dataset with a reference)")
        if categorical_feature not in ("auto", None, []):
            raise outside_slice("categorical features")
        self.device = resolve_device(device)
        self.data = data
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        """Bin the raw matrix on the host (basic.py _lazy_init:693-800)."""
        if self._binned is not None:
            return self
        if isinstance(self.data, str):
            raise outside_slice("loading data from files")
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        if names is None and hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        self._binned = BinnedDataset.from_matrix(
            _to_2d_float(self.data), Config(self.params),
            label=_to_1d(self.label), weight=_to_1d(self.weight),
            init_score=_to_1d(self.init_score), feature_names=names)
        if self.free_raw_data:
            self.data = None
        return self

    def num_data(self) -> int:
        return self.construct()._binned.num_data

    def num_feature(self) -> int:
        return self.construct()._binned.num_total_features

    def get_feature_name(self) -> List[str]:
        return list(self.construct()._binned.feature_names)

    def get_label(self):
        return self.construct()._binned.metadata.label


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
        self._train_set: Optional[Dataset] = None
        self._feature_names_loaded: List[str] = []
        self._feature_infos_loaded: List[str] = []
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
        train_set.construct()
        self._train_set = train_set
        self.config = Config(self.params)
        objective = create_objective(self.config)
        names = list(self.config.metric) or ["binary_logloss"]
        metrics = [m for m in (create_metric(n, self.config) for n in names
                               if n and n != "None") if m]
        self._impl = GBDT(self.config, train_set._binned, objective, metrics,
                          self.device)

    def _init_from_forest(self, models: List, feature_names: List[str],
                          feature_infos: List[str]) -> None:
        """A predict-only booster over host trees."""
        self.config = Config(self.params)
        self._impl = GBDT(self.config, None, create_objective(self.config),
                          [], self.device)
        self._impl.models = models
        self._feature_names_loaded = list(feature_names)
        self._feature_infos_loaded = list(feature_infos)

    def _init_from_string(self, model_str: str) -> None:
        parsed = model_text.parse_model_string(model_str)
        tokens = parsed["objective"].split()
        if parsed["num_tree_per_iteration"] != 1 or parsed["average_output"]:
            raise outside_slice("multiclass or averaged (RF) models")
        if tokens:
            self.params.setdefault("objective", tokens[0])
            for tok in tokens[1:]:
                if ":" in tok:
                    k, v = tok.split(":", 1)
                    self.params.setdefault(k, v)
        self._init_from_forest(parsed["trees"], parsed["feature_names"],
                               parsed["feature_infos"])

    # ------------------------------------------------------------ training
    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting round (basic.py:1843). Returns True if stopped."""
        if fobj is not None:
            raise outside_slice("custom objectives (fobj)")
        if train_set is not None and train_set is not self._train_set:
            raise outside_slice("resetting the training data")
        return self._impl.train_one_iter()

    def current_iteration(self) -> int:
        return self._impl.current_iteration

    def num_trees(self) -> int:
        return len(self._impl.models)

    def num_feature(self) -> int:
        return len(self._feature_names())

    def eval_train(self, feval=None):
        if feval is not None:
            raise outside_slice("feval")
        return [("training", m, v, bb)
                for _, m, v, bb in self._impl.get_eval_at(0)]

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
            raise outside_slice("pred_leaf, pred_contrib and pred_early_stop")
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
        # the reference's python package appends this sidecar line
        return out + "\npandas_categorical:%s\n" % json.dumps(None)

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
