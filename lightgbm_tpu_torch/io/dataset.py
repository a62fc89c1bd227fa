"""Binned Dataset + Metadata on the host.

The port's own copy of the dense path of ``lightgbm_tpu/io/dataset.py``
(the reference Dataset/Metadata, include/LightGBM/dataset.h:36-627): a single
dense ``[num_data, num_columns] uint8`` bin matrix plus the per-feature
mappers. The bin matrix is built on the host with numpy and moved to the
device once, by the boosting driver.

This slice trains on numerical, unbundled columns only. The EFB grouping
and the small-pair packing still run, exactly as in the JAX package, so
that the port can tell when either WOULD change the stored layout; it then
raises ``NotImplementedError`` instead of silently training on a different
layout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..config import Config
from ..log import Log, LightGBMError, check, outside_slice
from .binning import BinMapper
from .bundle import find_bundles


class Metadata:
    """Labels / weights / init scores (dataset.h:36-245)."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        arr = np.ascontiguousarray(label, dtype=np.float32).reshape(-1)
        check(len(arr) == self.num_data or self.num_data == 0,
              "Length of label is not same with #data")
        self.label = arr
        self.num_data = len(arr)

    def set_weight(self, weight: Optional[Sequence[float]]) -> None:
        if weight is None:
            self.weight = None
            return
        arr = np.ascontiguousarray(weight, dtype=np.float32).reshape(-1)
        check(len(arr) == self.num_data, "Length of weight is not same with #data")
        self.weight = arr

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.ascontiguousarray(init_score,
                                               dtype=np.float64).reshape(-1)


def _parse_categorical(categorical_feature, feature_names: List[str]) -> List[int]:
    out: List[int] = []
    if not categorical_feature:
        return out
    if isinstance(categorical_feature, str):
        categorical_feature = [c for c in categorical_feature.split(",") if c]
    for c in categorical_feature:
        if isinstance(c, str) and not c.lstrip("-").isdigit():
            if c in feature_names:
                out.append(feature_names.index(c))
            else:
                raise LightGBMError("Unknown categorical feature name %s" % c)
        else:
            out.append(int(c))
    return sorted(set(out))


def _small_pairs_would_form(mappers: List[BinMapper], used: List[int],
                            col_num_bin: List[int], pair_cap: int) -> bool:
    """Whether ``BinnedDataset._pack_small_pairs`` of the JAX package would
    joint-code any pair of small numerical features into one column (the
    same greedy widest-with-narrowest walk, without building anything)."""
    b_max = int(pair_cap) or max(col_num_bin, default=0)
    cand = sorted((mappers[j].num_bin for j in used
                   if mappers[j].num_bin <= 16), reverse=True)
    while len(cand) >= 2:
        widest = cand.pop(0)
        if widest * cand[-1] <= b_max:
            return True
    return False


class BinnedDataset:
    """The training artifact: bin matrix + mappers + metadata (dataset.h:278)."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.X_binned: Optional[np.ndarray] = None      # [num_data, F] uint8
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_bin: int = 255

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    label: Optional[Sequence[float]] = None,
                    weight: Optional[Sequence[float]] = None,
                    init_score: Optional[Sequence[float]] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_feature: Optional[Union[str, List]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        """Bin a dense raw [N, F] matrix (DatasetLoader::CostructFromSampleData,
        dataset_loader.cpp:700-820), with the JAX package's sampling, so the
        mappers and the bin matrix are byte-identical to its own. A
        validation set passes the training set as ``reference`` and reuses
        its mappers, used features and names (dataset.py:212-219 of the JAX
        package)."""
        if hasattr(data, "tocsc") and hasattr(data, "nnz"):
            raise outside_slice("sparse input", "ROADMAP Queue 1 #16")
        data = np.asarray(data)
        if data.ndim != 2:
            raise LightGBMError("Data should be 2-D, got shape %s"
                                % (data.shape,))
        n, f = data.shape
        data64 = np.asarray(data, dtype=np.float64)
        self = cls()
        self.num_data = n
        self.num_total_features = f
        self.max_bin = config.max_bin
        self.feature_names = feature_names or ["Column_%d" % i for i in range(f)]
        if reference is not None:
            check(f == reference.num_total_features,
                  "The number of features in data (%d) is not the same as "
                  "it was in training data (%d)"
                  % (f, reference.num_total_features))
            self.bin_mappers = reference.bin_mappers
            self.used_features = reference.used_features
            self.feature_names = reference.feature_names
            self._bin_columns(data64)
            self._set_metadata(n, label, weight, init_score)
            return self

        def column_nonzeros(j):
            col = data64[:, j]
            rows = np.flatnonzero(~((col >= -1e-35) & (col <= 1e-35)))
            return rows, col[rows]

        cat_idx = _parse_categorical(
            categorical_feature if categorical_feature is not None
            else config.categorical_feature, self.feature_names)
        if cat_idx:
            raise outside_slice("categorical features", "ROADMAP Queue 1 #4")
        sample_cnt = min(n, config.bin_construct_sample_cnt)
        sample_pos = None
        if sample_cnt < n:
            rng = np.random.RandomState(config.data_random_seed)
            sample_rows = np.sort(rng.choice(n, sample_cnt, replace=False))
            sample_pos = np.full(n, -1, np.int64)
            sample_pos[sample_rows] = np.arange(sample_cnt)

        nz_sample: List[np.ndarray] = []
        for j in range(f):
            rows, vals = column_nonzeros(j)
            if sample_pos is not None:
                pos = sample_pos[rows]
                keep = pos >= 0
                rows, vals = pos[keep], vals[keep]
            nz_sample.append(rows.astype(np.int64))
            mapper = BinMapper()
            mapper.find_bin(
                vals, total_sample_cnt=sample_cnt,
                max_bin=config.max_bin,
                min_data_in_bin=config.min_data_in_bin,
                min_split_data=config.min_data_in_leaf,
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing)
            self.bin_mappers.append(mapper)
        self.used_features = [j for j in range(f)
                              if not self.bin_mappers[j].is_trivial]
        if not self.used_features:
            Log.warning("There are no meaningful features, as all feature "
                        "values are constant.")
        num_bins = [self.bin_mappers[j].num_bin for j in self.used_features]
        if config.enable_bundle and len(self.used_features) > 1:
            bundles = find_bundles(
                [nz_sample[j] for j in self.used_features], sample_cnt,
                num_bins, config.max_conflict_rate,
                sparse_threshold=config.sparse_threshold)
            if any(len(b) > 1 for b in bundles):
                raise outside_slice(
                    "training on EFB bundles (they form on this data; "
                    "enable_bundle=false keeps the columns apart)",
                    "ROADMAP Queue 1 #4")
        if config.enable_nbit_packing and config.tree_learner == "serial" \
                and not config.mesh_shape and _small_pairs_would_form(
                    self.bin_mappers, self.used_features, num_bins,
                    256 if config.tpu_bin_packing == "nibble" else 0):
            raise outside_slice(
                "training on packed small-feature pairs (they form on this "
                "data; enable_nbit_packing=false keeps them apart)",
                "ROADMAP Queue 1 #4")

        self._bin_columns(data64)
        self._set_metadata(n, label, weight, init_score)
        return self

    def _bin_columns(self, data64: np.ndarray) -> None:
        """The uint8 bin matrix of the used features' columns."""
        cols = [self.bin_mappers[j].values_to_bins(data64[:, j]).astype(np.uint8)
                for j in self.used_features]
        self.X_binned = (np.ascontiguousarray(np.stack(cols, axis=1)) if cols
                         else np.zeros((len(data64), 0), dtype=np.uint8))

    def _set_metadata(self, n, label, weight, init_score) -> None:
        self.metadata = Metadata(n)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_init_score(init_score)

    # ------------------------------------------------------------ accessors
    @property
    def num_features(self) -> int:
        """Number of stored (non-trivial) features."""
        return len(self.used_features)

    def feature_num_bin(self, used_idx: int) -> int:
        return self.bin_mappers[self.used_features[used_idx]].num_bin

    def real_feature_index(self, used_idx: int) -> int:
        """Inner (stored) -> original feature index (dataset.h:613)."""
        return self.used_features[used_idx]

    def inner_feature_index(self, real_idx: int) -> int:
        try:
            return self.used_features.index(real_idx)
        except ValueError:
            return -1

    def max_num_bin(self) -> int:
        return max((self.feature_num_bin(i) for i in range(self.num_features)),
                   default=1)

    def get_feature_infos(self) -> List[str]:
        """Model-file ``feature_infos`` strings ([min:max] per feature)."""
        infos = []
        for j in range(self.num_total_features):
            m = self.bin_mappers[j] if j < len(self.bin_mappers) else None
            if m is None or m.is_trivial:
                infos.append("none")
            else:
                infos.append("[%s:%s]" % (repr(m.min_val), repr(m.max_val)))
        return infos
