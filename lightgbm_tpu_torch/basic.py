"""User-facing Dataset and Booster.

The port of ``lightgbm_tpu/basic.py`` (``Dataset`` :83, ``Booster`` :441;
the reference's python-package/lightgbm/basic.py) for the slice's
arguments. A ``Dataset`` holds the raw matrix until ``construct()`` bins it
on the host (a validation set with the training set's mappers, through
``reference``); a ``Booster`` trains on, or predicts from, one device (or
trains over the ranks of ``tree_learner``, ``mesh_shape``,
``num_machines`` and ``set_network``), and
evaluates its training and validation sets. A pandas ``DataFrame``'s
``category`` columns are categorical features coded by the training
frame's category order, which the model text keeps in its
``pandas_categorical`` line.

A multiclass booster (``num_class`` K) predicts [N, K] and hands ``fobj``
and ``feval`` its scores as K * N values, class-major, as the reference's
python package does. A booster pickles as its model text; it can swap its
training set for another binned with the same mappers
(``reset_training_data``) and dump its model as JSON. The JAX package's
methods that the port does not cover yet exist and raise, naming the
ROADMAP item that brings them.

Device policy: ``Dataset``, ``Booster`` and ``train`` take ``device``.
``None`` means CUDA; without a CUDA device they raise unless the caller
passes ``device="cpu"``. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .boosting import create_boosting
from .boosting.gbdt import HostTree
from .config import Config, param_dict_to_str
from .core.shap import predict_contrib
from .device import DeviceLike, resolve_device
from .io import model_text
from .io import parser
from .io.dataset import BinnedDataset, _is_sparse
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
    """Dense ndarray / list / DataFrame / scipy sparse -> float64 [N, F]
    (a sparse matrix densified: ``Booster.predict`` passes one row block
    at a time)."""
    if _is_frame(data):
        data = _pandas_frame_to_array(data)[0]
    if _is_sparse(data):
        data = data.toarray()
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
        # the rows a ``subset`` keeps, applied as the data are binned
        self.used_indices: Optional[np.ndarray] = None
        self._binned: Optional[BinnedDataset] = None
        self._predictor: Optional[_InnerPredictor] = None
        self.pandas_categorical = None

    def construct(self) -> "Dataset":
        """Bin the raw matrix on the host (basic.py _lazy_init:693-800); a
        validation set takes its reference's mappers."""
        if self._binned is not None:
            return self
        if (int(Config(self.params).data_stream_chunk_rows) > 0
                and self.reference is None and self.used_indices is None
                and not (isinstance(self.data, str)
                         and self.data.endswith((".npz", ".bin")))):
            # out of core: valid sets (a reference) and subsets bin in
            # memory, as they are bounded
            return self._construct_streamed()
        ref_binned = (None if self.reference is None
                      else self.reference.construct()._binned)
        data, frame_cats = self.data, []
        if isinstance(data, str):
            data = self._from_file(data, ref_binned)
            if data is None:
                return self
        names = self._feature_names()
        if _is_frame(data):
            if self.pandas_categorical is None and self.reference is not None:
                # a valid set codes categories in the training set's order
                self.pandas_categorical = self.reference.pandas_categorical
            data, frame_cats, self.pandas_categorical = \
                _pandas_frame_to_array(data, self.pandas_categorical)
        cat = self._categorical(frame_cats)
        # scipy sparse data are binned without densifying them
        data = data if _is_sparse(data) else _to_2d_float(data)
        label, weight, init_score = (_to_1d(self.label), _to_1d(self.weight),
                                     _to_1d(self.init_score))
        if self.used_indices is not None:
            # a subset's rows (basic.py:209-222 of the JAX package); the
            # query sizes stay the parent's, as there
            idx = self.used_indices
            data = data.tocsr()[idx] if _is_sparse(data) else data[idx]
            label, weight, init_score = (
                None if v is None else v[idx]
                for v in (label, weight, init_score))
        self._binned = BinnedDataset.from_matrix(
            data, Config(self.params), label=label, weight=weight,
            init_score=init_score, group=_to_1d(self.group),
            feature_names=names,
            categorical_feature=cat, reference=ref_binned)
        if self.free_raw_data:
            self.data = None
        return self

    def _feature_names(self) -> Optional[List[str]]:
        """The names given, or a frame's columns, or None."""
        if isinstance(self.feature_name, (list, tuple)):
            return list(self.feature_name)
        if hasattr(self.data, "columns"):
            return [str(c) for c in self.data.columns]
        return None

    def _categorical(self, frame_cats: List[str]):
        """The categorical features given, with a frame's category columns
        added: they are categorical whether or not they are listed (the
        reference's auto-detection)."""
        cat = (None if self.categorical_feature in ("auto", None)
               else self.categorical_feature)
        if frame_cats:
            cat = list(cat) if cat else []
            cat.extend(c for c in frame_cats if c not in cat)
        return cat

    def _construct_streamed(self) -> "Dataset":
        """Out-of-core construction (``data_stream_chunk_rows > 0``;
        basic.py:231-290 of the JAX package): a chunk source by input (a
        ``.npy`` path memory-mapped, another path as delimited text with
        its ``.weight``, ``.query`` and ``.init`` sidecars, an array or
        frame in memory; sparse input refuses), ingested in two rounds
        into a ``StreamedDataset`` whose uint8 chunks stay on the host
        until the booster's pipeline copies them to the card."""
        from .stream import ArraySource, CsvSource, NpyMmapSource, ingest
        cfg = Config(self.params)
        rows = int(cfg.data_stream_chunk_rows)
        data = self.data
        weight, group, init_score = self.weight, self.group, self.init_score
        frame_cats: List[str] = []
        if isinstance(data, str):
            if data.endswith(".npy"):
                src = NpyMmapSource(data, label=self.label, chunk_rows=rows)
            else:
                src = CsvSource(data, chunk_rows=rows, has_header=cfg.header,
                                label_column=cfg.label_column)
            weight = weight if weight is not None \
                else parser.load_weight_file(data)
            group = group if group is not None \
                else parser.load_query_file(data)
            init_score = init_score if init_score is not None \
                else parser.load_init_score_file(data)
        else:
            if _is_frame(data):
                data, frame_cats, self.pandas_categorical = \
                    _pandas_frame_to_array(data, self.pandas_categorical)
            if _is_sparse(data):
                raise LightGBMError(
                    "data_stream_chunk_rows does not support sparse input; "
                    "pass a dense array or stream from .npy/text")
            src = ArraySource(_to_2d_float(data), label=_to_1d(self.label),
                              chunk_rows=rows)
        binned = ingest(src, cfg, feature_names=self._feature_names(),
                        categorical_feature=self._categorical(frame_cats))
        meta = binned.metadata
        if self.label is not None and meta.label is None:
            meta.set_label(_to_1d(self.label))
        for value, store in ((weight, meta.set_weight),
                             (group, meta.set_query),
                             (init_score, meta.set_init_score)):
            if value is not None:
                store(_to_1d(value))
        self._binned = binned
        if self.free_raw_data:
            self.data = None
        return self

    def _from_file(self, path: str, ref_binned: Optional[BinnedDataset]
                   ) -> Optional[np.ndarray]:
        """A data file (basic.py:130-181 of the JAX package): the binary
        cache (``.npz``/``.bin``) and, under ``two_round``, a delimited
        file streamed in chunks are binned here (returns None); any other
        file is parsed into the float64 matrix it returns, its label
        column the label and its header the feature names unless given.
        Weights, query sizes and init scores not given come from the
        sidecar files ``<path>.weight``, ``.query`` and ``.init``."""
        if path.endswith((".npz", ".bin")):
            self._binned = BinnedDataset.load_binary(path)
            return None
        cfg = Config(self.params)
        # a subset takes the one-shot path: its rows are in memory anyway
        if (cfg.two_round and self.used_indices is None
                and not parser.sniff_libsvm(path)):
            self._binned = BinnedDataset.from_file_two_round(
                path, cfg, reference=ref_binned,
                feature_names=(None if self.feature_name == "auto"
                               else self.feature_name),
                categorical_feature=(None if self.categorical_feature
                                     == "auto"
                                     else self.categorical_feature))
            meta = self._binned.metadata
            if self.label is not None:
                meta.set_label(_to_1d(self.label))
            for value, load, store in (
                    (self.weight, parser.load_weight_file, meta.set_weight),
                    (self.group, parser.load_query_file, meta.set_query),
                    (self.init_score, parser.load_init_score_file,
                     meta.set_init_score)):
                value = value if value is not None else load(path)
                if value is not None:
                    store(_to_1d(value))
            return None
        x, y, names = parser.parse_file(path, has_header=cfg.header,
                                        label_column=cfg.label_column)
        if self.label is None:
            self.label = y
        if self.feature_name == "auto" and names:
            self.feature_name = names
        if self.weight is None:
            self.weight = parser.load_weight_file(path)
        if self.group is None:
            self.group = parser.load_query_file(path)
        if self.init_score is None:
            self.init_score = parser.load_init_score_file(path)
        return x

    def save_binary(self, filename: str) -> "Dataset":
        """basic.py:397 of the JAX package (dataset.h:394 SaveBinaryFile):
        the binned data, mappers and metadata as the ``.npz`` cache that
        ``Dataset(filename)`` loads, in either package."""
        self.construct()._binned.save_binary(filename)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent=False, params=None) -> "Dataset":
        """basic.py:843: a validation set binned with this Dataset's
        mappers, on its device."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, silent=silent,
                       params=params or self.params, device=self.device)

    def subset(self, used_indices, params=None) -> "Dataset":
        """basic.py:306 of the JAX package: the rows ``used_indices`` of
        this Dataset's raw data, on its device, binned with its mappers
        when it is binned already."""
        check(self.data is not None,
              "Cannot subset a Dataset whose raw data were freed when it "
              "was constructed; pass free_raw_data=False")
        ds = Dataset(self.data, label=self.label, reference=self.reference,
                     weight=self.weight, group=self.group,
                     init_score=self.init_score,
                     feature_name=self.feature_name,
                     categorical_feature=self.categorical_feature,
                     params=params or self.params,
                     free_raw_data=self.free_raw_data, device=self.device)
        ds.used_indices = np.asarray(sorted(used_indices), dtype=np.int64)
        if self._binned is not None and self.reference is None:
            ds.reference = self
        return ds

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

    # ------------------------------------------------------------ fields
    # basic.py:321-386 of the JAX package: a field set before binning is
    # kept for it, one set after goes to the binned data's metadata
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None:
            self._binned.metadata.set_label(_to_1d(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._binned is not None:
            self._binned.metadata.set_weight(_to_1d(weight))
        return self

    def set_group(self, group) -> "Dataset":
        """The queries' sizes."""
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._binned is not None:
            self._binned.metadata.set_init_score(_to_1d(init_score))
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        check(self._binned is None,
              "Cannot set reference after dataset was constructed")
        self.reference = reference
        return self

    def set_field(self, field_name: str, data) -> "Dataset":
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group, "query": self.set_group,
                  "init_score": self.set_init_score}.get(field_name)
        if setter is None:
            raise LightGBMError("Unknown field name %s" % field_name)
        return setter(data)

    def get_field(self, field_name: str):
        """A field of the binned data's metadata; ``group`` (``query``) is
        the queries' sizes, None without query groups."""
        m = self.construct()._binned.metadata
        if field_name in ("group", "query"):
            qb = m.query_boundaries
            return None if qb is None else np.diff(qb)
        if field_name not in ("label", "weight", "init_score"):
            raise LightGBMError("Unknown field name %s" % field_name)
        return getattr(m, field_name)

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_init_score(self):
        return self.get_field("init_score")

    def get_group(self):
        return self.get_field("group")


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
    """Booster in LightGBM (basic.py:1578), on one device or rank 0 of a
    group of thread ranks, or a process's rank."""

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
        self._impl = create_boosting(self.config, train_set._binned,
                                     objective, self._new_metrics(),
                                     self.device)
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
        self._impl.add_valid_data(data._binned, self._new_metrics())
        self._valid_sets.append(data)
        self.name_valid_sets.append(name)
        return self

    def _new_metrics(self) -> List:
        """A fresh instance of each of the booster's metrics."""
        return [m for m in (create_metric(n, self.config)
                            for n in self._metric_names) if m]

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting round (basic.py:1843). Returns True if stopped.

        A ``train_set`` other than the booster's own replaces it first
        (``reset_training_data``). ``fobj(raw training scores, training
        Dataset)`` returns the gradients and hessians of a custom objective
        in numpy; they take the objective's place for this round
        (basic.py:577-618 of the JAX package)."""
        if train_set is not None and train_set is not self._train_set:
            self.reset_training_data(train_set)
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

    def reset_training_data(self, train_set: Dataset) -> "Booster":
        """Swap the training set under the current model (basic.py:721-777
        of the JAX package; GBDT::ResetTrainingData, gbdt.cpp:622-660): the
        new set must bin with the old one's mappers (CheckAlign), the model
        and the validation sets are kept, and the training scores are every
        tree replayed on the new stored columns (``GBDT.reset_training_data``).

        As in the JAX package the GBDT is built anew, so what it keeps
        between iterations starts over: the bagging and GOSS key and mask,
        the feature-fraction draws, DART's drop draws and tree weights, RF's
        running training sums and the CEGB state (ROADMAP Queue 3)."""
        check(self._train_set is not None,
              "Cannot reset training data: the booster has no training set")
        check(isinstance(train_set, Dataset),
              "Training data should be Dataset instance")
        if train_set.device != self.device:
            raise ValueError("the Dataset is on %s but the Booster on %s"
                             % (train_set.device, self.device))
        old_binned = self._train_set.construct()._binned
        if train_set._binned is None:
            if train_set.reference is None:
                train_set.reference = self._train_set
            train_set.params = {**train_set.params, **self.params}
        train_set.construct()
        # CheckAlign (gbdt.cpp:624-626): the same bin mappers or nothing
        check(train_set._binned.get_feature_infos()
              == old_binned.get_feature_infos(),
              "Cannot reset training data: new training data has different "
              "bin mappers")
        impl = create_boosting(self.config, train_set._binned,
                               create_objective(self.config),
                               self._new_metrics(), self.device)
        impl.reset_from(self._impl)
        # the validation sets survive the swap: add_valid_data replays the
        # model on each
        for vset in self._valid_sets:
            impl.add_valid_data(vset._binned, self._new_metrics())
        self._impl = impl
        self._train_set = train_set
        return self

    def __getstate__(self):
        """Pickle as the model text (basic.py:587-609 of the JAX package),
        with the parameters, the best iteration and score, the pandas
        categories and the device type: the unpickled booster predicts and
        saves; the training state does not survive."""
        return {"params": self.params, "best_iteration": self.best_iteration,
                "best_score": dict(self.best_score),
                "pandas_categorical": self.pandas_categorical,
                "device": self.device.type,
                "model_str": (self.model_to_string(num_iteration=-1)
                              if self._impl.models else None)}

    def __setstate__(self, state):
        """The device is resolved anew: a CUDA booster unpickled where CUDA
        is absent raises, as every entry point does."""
        self.__init__(params=state.get("params"),
                      model_str=state.get("model_str"),
                      device=state.get("device"))
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = state.get("best_score", {})
        if state.get("pandas_categorical") is not None:
            self.pandas_categorical = state["pandas_categorical"]

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
        """Raw scores or probabilities for raw feature rows (a dense
        matrix, a DataFrame or a scipy sparse matrix), on the booster's
        device; with ``pred_leaf`` each tree's leaf index a row, class-major
        for K classes, as the JAX package lays it out (class 0's
        iterations, then class 1's); with ``pred_contrib`` the SHAP values,
        F + 1 columns a class (``core/shap.py``); ``pred_early_stop``
        (``pred_early_stop_freq``, ``pred_early_stop_margin``) stops a row's
        sum once its margin is reached (``GBDT.predict``)."""
        if isinstance(data, Dataset):
            raise LightGBMError("Cannot use Dataset instance for prediction, "
                                "please use raw data instead")
        if _is_frame(data) and self.pandas_categorical is not None:
            data = _pandas_frame_to_array(data, self.pandas_categorical)[0]
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        if _is_sparse(data):
            # densified a row block at a time (~128 MB of float64), never
            # whole (basic.py:689-704 of the JAX package; PredictForCSR)
            block = max(256, (1 << 24) // max(int(data.shape[1]), 1))
            if data.shape[0] > block:
                mat = data.tocsr()
                return np.concatenate([self.predict(
                    mat[lo:lo + block], num_iteration=num_iteration,
                    raw_score=raw_score, pred_leaf=pred_leaf,
                    pred_contrib=pred_contrib, **kwargs)
                    for lo in range(0, mat.shape[0], block)], axis=0)
        x = _to_2d_float(data)
        if pred_contrib:
            return predict_contrib(self._impl, x, num_iteration)
        return self._impl.predict(
            x, num_iteration=num_iteration, raw_score=raw_score,
            pred_leaf=pred_leaf,
            pred_early_stop=kwargs.get("pred_early_stop", False),
            pred_early_stop_freq=kwargs.get("pred_early_stop_freq", 10),
            pred_early_stop_margin=kwargs.get("pred_early_stop_margin",
                                              10.0))

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
        return self._model_text(self._impl, num_iteration, start_iteration)

    def _model_text(self, impl, num_iteration: Optional[int] = None,
                    start_iteration: int = 0) -> str:
        """``model_to_string`` of ``impl``: this booster's GBDT or, under
        thread ranks, a peer rank's."""
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        out = model_text.model_to_string(
            impl, self._feature_names(), self._feature_infos(),
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

    def dump_model(self, num_iteration: Optional[int] = None) -> Dict:
        """The model as JSON (basic.py:932 of the JAX package; GBDT::DumpModel),
        up to the best iteration unless ``num_iteration`` says otherwise."""
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        return json.loads(model_text.model_to_json(
            self._impl, self._feature_names(), self._feature_infos(),
            num_iteration=num_iteration))

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = self._impl.feature_importance(importance_type, iteration)
        return imp.astype(np.int64) if importance_type == "split" else imp

    def feature_name(self) -> List[str]:
        return self._feature_names()

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """The thresholds of the numerical splits on ``feature`` (an index
        or a name) as a histogram (basic.py:952 of the JAX package):
        (counts, edges), or with ``xgboost_style`` the [upper edge, count]
        rows of the nonempty bins."""
        if isinstance(feature, str):
            names = self._feature_names()
            check(feature in names, "Feature %s not found" % feature)
            feature = names.index(feature)
        values = np.asarray(
            [float(ht.threshold[t]) for ht in self._impl.models
             for t in range(max(ht.num_leaves_actual - 1, 0))
             if ht.split_feature[t] == feature and not ht.is_categorical[t]],
            np.float64)
        if bins is None:
            bins = max(min(len(values), 255), 1)
        hist, edges = np.histogram(values, bins=bins)
        if xgboost_style:
            rows = [(edges[i + 1], int(hist[i])) for i in range(len(hist))
                    if hist[i] > 0]
            return np.asarray(rows, np.float64).reshape(-1, 2)
        return hist, edges

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """The value of one leaf (basic.py:978 of the JAX package;
        LGBM_BoosterGetLeafValue)."""
        models = self._impl.models
        if not 0 <= tree_id < len(models):
            raise LightGBMError("tree_id %d out of range" % tree_id)
        t = models[tree_id]
        if not 0 <= leaf_id < int(t.num_leaves_actual):
            raise LightGBMError("leaf_id %d out of range" % leaf_id)
        return float(t.leaf_value[leaf_id])

    @property
    def models(self) -> List[HostTree]:
        return self._impl.models

    def as_serving_bundle(self, model_id: str = "default"):
        """Package this booster for ``lightgbm_tpu_torch.serving`` on its
        device. Register it on a ServingEngine of that device with
        ``engine.registry.register(booster.as_serving_bundle(id))``."""
        from .serving.registry import ModelBundle
        check(self._impl is not None and len(self._impl.models) > 0,
              "Cannot serve: no trained model")
        return ModelBundle.from_booster(model_id, self)

    def refit(self, data, label, decay_rate: float = 0.9, weight=None,
              group=None, **kwargs) -> "Booster":
        """Refit the trees' leaf values to new data (basic.py:789-886 of
        the JAX package; RefitTree, gbdt.cpp:263-286): every split is
        kept, leaf outputs are re-estimated from the new data's gradients
        and blended with the old ones by ``decay_rate``.

        Dense input takes the device path on the booster's device
        (``fleet/refit.py``: one flat-forest routing, then a loop over
        iterations with fixed-order leaf sums); ``refit_device=false``
        forces the host loop below. A scipy sparse matrix takes the host
        loop, densified a row block at a time, never whole. The host loop
        routes each tree's rows with ``predict``'s replay on the device,
        sums each leaf's gradients in float64 with ``np.bincount`` and
        keeps the running scores in float32."""
        from .fleet.refit import (leaf_outputs, refit_booster,
                                  refit_metadata, refit_objective,
                                  refitted_booster)
        from .core import tree as tree_mod

        obj = refit_objective(self)
        sparse_in = _is_sparse(data)
        if not sparse_in and self.config.refit_device:
            return refit_booster(self, data, label, decay_rate=decay_rate,
                                 weight=weight, group=group)
        if sparse_in:
            data = data.tocsr()
            n = int(data.shape[0])
            blk = max(256, (1 << 24) // max(int(data.shape[1]), 1))
            blocks = [(lo, lambda lo=lo: data[lo:lo + blk].toarray())
                      for lo in range(0, n, blk)]
        else:
            x = _to_2d_float(data)
            n = x.shape[0]
            blocks = [(0, lambda: x)]
        k = self._impl.num_tree_per_iteration
        models = self._impl.models
        obj.init(refit_metadata(n, label, weight, group), self.device)
        cfg = self.config
        # every tree's leaf of every row, a row block at a time
        trees = tree_mod.stack_predict_trees(models, self.device)
        leaves = np.empty((n, len(models)), np.int64)
        for lo, block in blocks:
            xb = torch.as_tensor(np.asarray(block(), np.float64),
                                 device=self.device)
            for i in range(len(models)):
                leaves[lo:lo + xb.shape[0], i] = \
                    tree_mod.tree_leaves(trees, i, xb).cpu().numpy()
        scores = np.zeros((n, k), np.float32)
        g = h = None
        new_leaves = []
        for i, ht in enumerate(models):
            c = i % k
            if c == 0:  # gradients refresh once per boosting iteration
                st = torch.as_tensor(scores[:, 0] if k == 1 else scores,
                                     device=self.device)
                gt, hth = obj.get_gradients(st)
                g = gt.cpu().numpy().reshape(n, k)
                h = hth.cpu().numpy().reshape(n, k)
            nl = int(ht.num_leaves_actual)
            sg = np.bincount(leaves[:, i], weights=g[:, c].astype(np.float64),
                             minlength=nl)
            sh = np.bincount(leaves[:, i], weights=h[:, c].astype(np.float64),
                             minlength=nl)
            out = leaf_outputs(sg, sh, cfg.lambda_l1, cfg.lambda_l2,
                               cfg.max_delta_step,
                               float(getattr(ht, "shrinkage", 1.0)))
            old = np.asarray(ht.leaf_value[:nl], np.float64)
            vals = decay_rate * old + (1.0 - decay_rate) * out
            new_leaves.append(vals)
            scores[:, c] += vals.astype(np.float32)[leaves[:, i]]
        return refitted_booster(self.device, self.model_to_string(), models,
                                new_leaves)

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Join this process to a rank group of ``num_machines`` processes
        (basic.py:997-1005 of the JAX package; ``parallel/network.py``
        ``init``): the first entry of ``machines`` is the rendezvous, the
        rank ``LIGHTGBM_TPU_RANK``. A training built after it learns over
        the group."""
        from .parallel import network
        network.init(machines=machines, local_listen_port=local_listen_port,
                     time_out=listen_time_out, num_machines=num_machines,
                     device=self.device)
        return self

    def free_network(self) -> "Booster":
        """Leave the rank group (basic.py:1007-1010 of the JAX package)."""
        from .parallel import network
        network.free()
        return self
