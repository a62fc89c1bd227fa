"""Binned Dataset + Metadata on the host.

The port's own copy of the dense path of ``lightgbm_tpu/io/dataset.py``
(the reference Dataset/Metadata, include/LightGBM/dataset.h:36-627): a single
dense ``[num_data, num_columns] uint8`` bin matrix plus the per-feature
mappers. The bin matrix is built on the host with numpy and moved to the
device once, by the boosting driver.

The stored columns are the JAX package's layout, byte for byte: EFB
(``io/bundle.py``) packs mutually-exclusive sparse features into shared
columns, and small-feature pairs (``_pack_small_pairs``, the
Dense4bitsBin idea) share a joint-coded column where that does not widen
the histogram. ``col_features`` / ``col_offsets`` / ``col_num_bin`` /
``col_packed`` record the layout (feature_group.h:35-50 bin_offsets_
analog) and ``feature_layout`` gives the per-feature view the growers
decode with. ``tpu_bin_packing=nibble`` (dataset-wide pairing) is outside
the slice. Categorical features (``categorical_feature``) are binned by
category; they never join a small-feature pair, and join an EFB bundle by
the JAX package's rule, as any feature sparse enough does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..config import Config
from ..log import Log, LightGBMError, check, outside_slice
from .binning import BinMapper, BinType
from .bundle import bundle_offsets, find_bundles


class Metadata:
    """Labels / weights / query boundaries / init scores
    (dataset.h:36-245)."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # [queries + 1]
        self.init_score: Optional[np.ndarray] = None
        self._query_weights: Optional[np.ndarray] = None    # lazy cache

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
        self._query_weights = None

    def set_query(self, group: Optional[Sequence[int]]) -> None:
        """Per-query sizes (LightGBM's group format) -> boundaries
        (dataset.py:66-76 of the JAX package)."""
        if group is None:
            self.query_boundaries = None
            return
        arr = np.ascontiguousarray(group, dtype=np.int64).reshape(-1)
        boundaries = np.concatenate([[0], np.cumsum(arr)])
        check(boundaries[-1] == self.num_data,
              "Sum of query counts is not same with #data")
        self.query_boundaries = boundaries.astype(np.int32)
        self._query_weights = None

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.ascontiguousarray(init_score,
                                               dtype=np.float64).reshape(-1)

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

    @property
    def query_weights(self) -> Optional[np.ndarray]:
        """Each query's weight, the mean of its docs' weights (metadata.cpp
        LoadQueryWeights; dataset.py:89-103 of the JAX package); None unless
        both row weights and query boundaries are set."""
        if self.weight is None or self.query_boundaries is None:
            return None
        if self._query_weights is None \
                or len(self._query_weights) != self.num_queries:
            qb = np.asarray(self.query_boundaries, np.int64)
            sums = np.add.reduceat(self.weight.astype(np.float64), qb[:-1])
            counts = np.maximum(np.diff(qb), 1)
            self._query_weights = (sums / counts).astype(np.float32)
        return self._query_weights


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


class BinnedDataset:
    """The training artifact: bin matrix + mappers + metadata (dataset.h:278)."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.X_binned: Optional[np.ndarray] = None      # [num_data, C] uint8
        # EFB layout (feature_group.h:35-50): stored column -> member
        # original features + their bin offsets; singletons have offsets
        # == [0] (raw encoding). With no bundling these mirror
        # used_features 1:1. Joint-coded pairs of small features
        # (Dense4bitsBin analog) store bin_a * num_bin_b + bin_b.
        self.col_features: List[List[int]] = []
        self.col_offsets: List[List[int]] = []
        self.col_num_bin: List[int] = []
        self.col_packed: List[bool] = []
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_bin: int = 255

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    label: Optional[Sequence[float]] = None,
                    weight: Optional[Sequence[float]] = None,
                    init_score: Optional[Sequence[float]] = None,
                    group: Optional[Sequence[int]] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_feature: Optional[Union[str, List]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        """Bin a dense raw [N, F] matrix (DatasetLoader::CostructFromSampleData,
        dataset_loader.cpp:700-820), with the JAX package's sampling, so the
        mappers and the bin matrix are byte-identical to its own. A
        validation set passes the training set as ``reference`` and reuses
        its mappers, used features, names and stored layout (dataset.py:
        212-219 of the JAX package)."""
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
            self.col_features = reference.col_features
            self.col_offsets = reference.col_offsets
            self.col_num_bin = reference.col_num_bin
            self.col_packed = reference.col_packed
            self._bin_columns(data64)
            self._set_metadata(n, label, weight, init_score, group)
            return self

        def column_nonzeros(j):
            col = data64[:, j]
            rows = np.flatnonzero(~((col >= -1e-35) & (col <= 1e-35)))
            return rows, col[rows]

        cat_idx = set(_parse_categorical(
            categorical_feature if categorical_feature is not None
            else config.categorical_feature, self.feature_names))
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
                bin_type=(BinType.CATEGORICAL if j in cat_idx
                          else BinType.NUMERICAL),
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing)
            self.bin_mappers.append(mapper)
        self.used_features = [j for j in range(f)
                              if not self.bin_mappers[j].is_trivial]
        if not self.used_features:
            Log.warning("There are no meaningful features, as all feature "
                        "values are constant.")
        # ---- EFB grouping (dataset.cpp:67-177 analog) --------------------
        if config.enable_bundle and len(self.used_features) > 1:
            bundles = find_bundles(
                [nz_sample[j] for j in self.used_features], sample_cnt,
                [self.bin_mappers[j].num_bin for j in self.used_features],
                config.max_conflict_rate,
                sparse_threshold=config.sparse_threshold)
            # bundle entries index into used_features; map back
            bundles = [[self.used_features[i] for i in b] for b in bundles]
        else:
            bundles = [[j] for j in self.used_features]
        self.col_features = bundles
        self.col_offsets, self.col_num_bin = [], []
        num_bin_of = {j: self.bin_mappers[j].num_bin
                      for j in self.used_features}
        for b in bundles:
            offs, total = bundle_offsets(b, num_bin_of)
            self.col_offsets.append(offs)
            self.col_num_bin.append(total)
        n_bundled = sum(1 for b in bundles if len(b) > 1)
        if n_bundled:
            Log.info("EFB: %d features bundled into %d columns "
                     "(%d multi-feature bundles)",
                     len(self.used_features), len(bundles), n_bundled)
        self.col_packed = [False] * len(self.col_features)
        # the JAX package pairs on one device with the serial learner only
        # (a mesh shards the feature axis assuming an identity layout)
        if config.enable_nbit_packing and \
                config.tree_learner == "serial" and not config.mesh_shape:
            if config.tpu_bin_packing == "nibble":
                raise outside_slice(
                    "tpu_bin_packing=nibble (small-feature pairs coded "
                    "dataset-wide, widening the histogram)",
                    "ROADMAP Queue 1 #9")
            # auto and none resolve to plain uint8 columns off a TPU, as
            # does byte (core/binpack.py:97-117 of the JAX package): the
            # conservative cap, B never grows past the widest column
            self._pack_small_pairs()

        self._bin_columns(data64)
        self._set_metadata(n, label, weight, init_score, group)
        return self

    def _bin_columns(self, data64: np.ndarray) -> None:
        """The uint8 stored columns (dataset.py:316-350 of the JAX
        package): a feature's own bins in a singleton column, ``offset +
        bin`` of the non-default bins in a bundle (features in bundle
        order, so a later feature wins a conflicting row), ``bin_a *
        num_bin_b + bin_b`` in a packed pair."""
        n = len(data64)

        def full_bin_column(j):
            return self.bin_mappers[j].values_to_bins(
                data64[:, j]).astype(np.uint8)

        cols = []
        for ci, (feats, offs) in enumerate(zip(self.col_features,
                                               self.col_offsets)):
            if self._col_is_packed(ci):
                ja, jb = feats
                nb_b = self.bin_mappers[jb].num_bin
                colb = (full_bin_column(ja).astype(np.uint16) * nb_b
                        + full_bin_column(jb)).astype(np.uint8)
            elif len(feats) == 1 and offs[0] == 0:
                colb = full_bin_column(feats[0])
            else:
                colb = np.zeros(n, np.uint8)
                for off, j in zip(offs, feats):
                    m = self.bin_mappers[j]
                    col = data64[:, j]
                    rows = np.flatnonzero(~((col >= -1e-35)
                                            & (col <= 1e-35)))
                    bins = m.values_to_bins(col[rows])
                    sel = bins != m.default_bin
                    colb[rows[sel]] = (off + bins[sel]).astype(np.uint8)
            cols.append(colb)
        self.X_binned = (np.ascontiguousarray(np.stack(cols, axis=1)) if cols
                         else np.zeros((n, 0), dtype=np.uint8))

    def _set_metadata(self, n, label, weight, init_score, group) -> None:
        self.metadata = Metadata(n)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_query(group)
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

    # ------------------------------------------------------------ EFB layout
    @property
    def num_columns(self) -> int:
        """Stored bin-matrix columns (== num_features when nothing is
        bundled or packed)."""
        return len(self.col_features)

    def max_col_bins(self) -> int:
        """Largest encoded bin count of any stored column (histogram B)."""
        return max(self.col_num_bin, default=1)

    @property
    def has_bundles(self) -> bool:
        return any(len(b) > 1 and not self._col_is_packed(ci)
                   for ci, b in enumerate(self.col_features))

    def _col_is_packed(self, ci: int) -> bool:
        return ci < len(self.col_packed) and self.col_packed[ci]

    @property
    def has_packed(self) -> bool:
        return any(self.col_packed)

    def _pack_small_pairs(self) -> None:
        """Joint-code pairs of small singleton numerical features into one
        stored column (value = bin_a * num_bin_b + bin_b), the
        Dense4bitsBin idea (dense_nbits_bin.hpp:38-82) re-shaped for the
        [N, C] uint8 matrix: two features share a column whose joint
        histogram is marginalised per feature at split-search time. A pair
        forms only when it fits the dataset's existing histogram width, so
        B never grows (the JAX package's ``pair_cap`` 0)."""
        b_max = max(self.col_num_bin, default=0)
        cand = [ci for ci in range(len(self.col_features))
                if len(self.col_features[ci]) == 1
                and not self.col_packed[ci]
                and self.bin_mappers[self.col_features[ci][0]].bin_type
                != BinType.CATEGORICAL
                and self.bin_mappers[self.col_features[ci][0]].num_bin <= 16]
        # widest first, paired greedily while the product fits b_max
        cand.sort(key=lambda ci:
                  -self.bin_mappers[self.col_features[ci][0]].num_bin)
        drop = set()
        pairs = 0
        while len(cand) >= 2:
            ca = cand.pop(0)
            cb = cand.pop()          # widest with narrowest
            ja = self.col_features[ca][0]
            jb = self.col_features[cb][0]
            nb_a = self.bin_mappers[ja].num_bin
            nb_b = self.bin_mappers[jb].num_bin
            if nb_a * nb_b > b_max:
                # the widest can pair with no one (cb is the narrowest);
                # drop it and keep pairing the rest
                cand.append(cb)
                continue
            self.col_features[ca] = [ja, jb]
            self.col_offsets[ca] = [0, 0]
            self.col_num_bin[ca] = nb_a * nb_b
            self.col_packed[ca] = True
            drop.add(cb)
            pairs += 1
        if drop:
            keep = [i for i in range(len(self.col_features))
                    if i not in drop]
            self.col_features = [self.col_features[i] for i in keep]
            self.col_offsets = [self.col_offsets[i] for i in keep]
            self.col_num_bin = [self.col_num_bin[i] for i in keep]
            self.col_packed = [self.col_packed[i] for i in keep]
            Log.info("nbit packing: %d small-feature pairs share a column "
                     "(%d stored columns)", pairs, len(self.col_features))

    def feature_layout(self):
        """Per used-feature (inner index) storage arrays:
        (feat_col, feat_offset, feat_bundled, pack_div, pack_mod,
        pack_partner): where each feature lives in the stored matrix, at
        which bin offset (EFB), and how to extract it from a joint-coded
        pair column: feature bin = (value // div) % mod, with ``partner``
        the other feature's bin count (the marginalisation width).
        div/mod are 1/0 for unpacked features."""
        fcount = self.num_features
        feat_col = np.zeros(fcount, np.int32)
        feat_offset = np.zeros(fcount, np.int32)
        feat_bundled = np.zeros(fcount, bool)
        pack_div = np.ones(fcount, np.int32)
        pack_mod = np.zeros(fcount, np.int32)
        pack_partner = np.ones(fcount, np.int32)
        inner = {j: i for i, j in enumerate(self.used_features)}
        for ci, (feats, offs) in enumerate(zip(self.col_features,
                                               self.col_offsets)):
            if self._col_is_packed(ci):
                ja, jb = feats
                nb_a = self.bin_mappers[ja].num_bin
                nb_b = self.bin_mappers[jb].num_bin
                ia, ib = inner[ja], inner[jb]
                feat_col[ia] = feat_col[ib] = ci
                pack_div[ia], pack_mod[ia] = nb_b, nb_a
                pack_partner[ia] = nb_b
                pack_div[ib], pack_mod[ib] = 1, nb_b
                pack_partner[ib] = nb_a
                continue
            for off, j in zip(offs, feats):
                i = inner[j]
                feat_col[i] = ci
                feat_offset[i] = off
                feat_bundled[i] = len(feats) > 1
        return (feat_col, feat_offset, feat_bundled, pack_div, pack_mod,
                pack_partner)

    def get_feature_infos(self) -> List[str]:
        """Model-file ``feature_infos`` strings: [min:max] of a numerical
        feature, the sorted categories of a categorical one."""
        infos = []
        for j in range(self.num_total_features):
            m = self.bin_mappers[j] if j < len(self.bin_mappers) else None
            if m is None or m.is_trivial:
                infos.append("none")
            elif m.bin_type == BinType.CATEGORICAL:
                infos.append(":".join(str(c)
                                      for c in sorted(m.bin_2_categorical)))
            else:
                infos.append("[%s:%s]" % (repr(m.min_val), repr(m.max_val)))
        return infos
