"""GBDT training driver.

The port of ``lightgbm_tpu/boosting/gbdt.py`` (gbdt.cpp Init :45-115,
TrainOneIter :333-412, UpdateScore :451-470, RollbackOneIter :414-430 of
the reference) for the slice the port covers: the regression family,
binary, multiclass, cross-entropy and lambdarank objectives or a custom
objective's gradients (``fobj``; the training set and each valid set
carry their query groups in their metadata, which lambdarank and the
ranking metrics read), numerical and categorical features stored as the
JAX package stores them (EFB bundles and packed small-feature pairs share
columns),
one device, and the growth modes of ``tree_growth``: leaf-wise ``exact``
(``core/grow.py``), ``frontier`` waves (``core/grow_frontier.py``) and
top-K ``batched`` steps (``core/grow_batched.py``, or
``core/grow_batched_part.py`` over rows kept grouped by leaf with
``tpu_batched_part=true``). Each iteration computes
gradients on the device, samples rows where bagging asks for it (the JAX
package's threefry draws, ``random.py``: a mask refreshed every
``bagging_freq`` iterations, under lambdarank one draw a query), grows one
tree a class on the in-bag rows, renews its leaf values
where the objective asks for it (L1, quantile, MAPE: ``core/renew.py``),
adds its shrunk leaf values to the class's training scores through the
per-row leaf ids and to each validation set's scores through a binned
replay of the tree (``core/tree.py``), and keeps the tree on the host as a
``HostTree`` with real-valued thresholds and, for a categorical split, a
bitset of raw category values as wide as the data's largest category
needs.

Scores are [N, K] on the device, K = ``num_tree_per_iteration`` (the
objective's ``num_model_per_iteration``: ``num_class`` for multiclass, 1
otherwise), and gradients [K, N], a class's row contiguous. The classes'
trees grow in turn, in class order, each through the selected grower on
its class's gradients, as the JAX package grows them on its accelerator
(gbdt.py:576-600 there; it vmaps them only on the CPU, where each class's
tree is the one sequential growth gives). The model lists the K trees of
an iteration together: tree ``i`` is class ``i % K``.

The bagging key follows the JAX package's two key streams: an iteration
of ``train_one_iter`` splits the key for a refresh and once more for GOSS
(gbdt.py:1031-1046, :2211 there); ``train_many``, which ``engine.train``
calls where the JAX engine fuses its loop, splits it into blocks of at most
64 iterations and each block key in two (gbdt.py:1622-1647, :1862-1930).
GOSS, DART and RF (``goss.py``, ``dart.py``, ``rf.py``) are subclasses that
amend the gradients and mask, move the trees already in the model, or
average the forest; ``boosting.create_boosting`` picks the class.

Every option outside the slice raises ``NotImplementedError`` from
``check_slice`` before anything is built, naming the ROADMAP item that
brings it: the port never builds a different tree than the one asked for.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core import tree as tree_mod
from ..core.grow import GrowParams, TreeArrays, grow_tree
from ..core.grow_batched import grow_tree_batched
from ..core.grow_batched_part import grow_tree_batched_part
from ..core.grow_frontier import grow_tree_frontier
from ..core.histogram import HIST_IMPLS
from ..core.renew import renew_leaf_values
from ..core.split import FeatureMeta, SplitParams
from .. import random as threefry
from ..io.binning import BinType
from ..io.dataset import BinnedDataset
from ..log import LightGBMError, Log, outside_slice
from ..metrics import Metric
from ..objectives import ObjectiveFunction

# the grower of each tree_growth (config.TREE_GROW_MODES)
GROWERS = {"exact": grow_tree, "frontier": grow_tree_frontier,
           "batched": grow_tree_batched}


class HostTree:
    """One trained tree on the host: numpy arrays plus real thresholds, the
    fields of the JAX package's HostTree (tree.h:404-517)."""

    def __init__(self, num_leaves: int):
        n = max(num_leaves - 1, 1)
        self.num_leaves = num_leaves
        self.num_leaves_actual = 1
        self.split_feature = np.zeros(n, np.int32)       # real feature index
        self.split_gain = np.zeros(n, np.float32)
        self.threshold = np.zeros(n, np.float64)         # real-value threshold
        self.threshold_bin = np.zeros(n, np.int32)
        self.default_left = np.zeros(n, bool)
        self.missing_type = np.zeros(n, np.int32)
        self.is_categorical = np.zeros(n, bool)
        # the categories going left: raw category values (words of 32 bits,
        # as many as the largest category needs) and bins (the replay's)
        self.cat_bitset = np.zeros((n, 8), np.uint32)
        self.cat_bitset_bin = np.zeros((n, 8), np.uint32)
        self.left_child = np.full(n, -1, np.int32)
        self.right_child = np.full(n, -1, np.int32)
        self.split_leaf = np.full(n, -1, np.int32)
        self.internal_value = np.zeros(n, np.float64)
        self.internal_weight = np.zeros(n, np.float64)
        self.internal_count = np.zeros(n, np.int64)
        self.leaf_value = np.zeros(num_leaves, np.float64)
        self.leaf_weight = np.zeros(num_leaves, np.float64)
        self.leaf_count = np.zeros(num_leaves, np.int64)
        self.shrinkage = 1.0

    @property
    def num_nodes(self) -> int:
        return self.num_leaves - 1

    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:139-147)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate


def check_slice(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for any option outside the slice."""
    rules = [
        (bool(cfg.monotone_constraints)
         and any(int(v) != 0 for v in cfg.monotone_constraints),
         "monotone_constraints", "ROADMAP Queue 1 #4"),
        (bool(cfg.forcedsplits_filename), "forced splits",
         "ROADMAP Queue 1 #6"),
        (cfg.cegb_penalty_split > 0
         or bool(cfg.cegb_penalty_feature_coupled)
         or bool(cfg.cegb_penalty_feature_lazy), "CEGB",
         "ROADMAP Queue 1 #6"),
        (cfg.gpu_use_dp or str(cfg.tpu_hist_dtype).lower()
         in ("float64", "f64", "double"), "f64 histograms (gpu_use_dp)",
         "ROADMAP Queue 1 #3"),
        # the JAX package packs bins for frontier growth only, and its auto
        # resolves to none off a TPU (core/binpack.py:97-117)
        (cfg.tree_growth == "frontier"
         and cfg.tpu_bin_packing not in ("auto", "none"),
         "tpu_bin_packing=%s (packed bin words)" % cfg.tpu_bin_packing,
         "ROADMAP Queue 1 #9"),
        (bool(cfg.obs_modelstats), "obs_modelstats (model statistics)",
         "ROADMAP Queue 1 #15"),
        (cfg.tree_learner != "serial" or bool(cfg.mesh_shape)
         or cfg.num_machines > 1, "a device mesh (tree_learner=%s)"
         % cfg.tree_learner, "ROADMAP Queue 1 #13"),
        (int(cfg.data_stream_chunk_rows) > 0, "out-of-core streaming",
         "ROADMAP Queue 1 #11"),
    ]
    for bad, what, where in rules:
        if bad:
            raise outside_slice(what, where)


def batched_part_on(cfg: Config) -> bool:
    """The JAX package's policy for partitioned batched growth
    (gbdt.py:587-609 there, one device): ``true`` turns it on under
    ``tree_growth=batched``; ``auto`` and ``false`` leave it off; under
    ``exact`` or ``frontier`` the option is ignored."""
    return cfg.tree_growth == "batched" and cfg.tpu_batched_part in ("true",
                                                                     "1")


def resolve_hist_impl(cfg: Config) -> str:
    """The port's ``tpu_hist_impl`` spellings: auto | plain."""
    impl = cfg.tpu_hist_impl
    if impl not in HIST_IMPLS:
        raise outside_slice("tpu_hist_impl=%s (the port takes %s)"
                     % (impl, "/".join(HIST_IMPLS)), "ROADMAP Queue 2")
    return impl


def _feature_meta(ds: BinnedDataset, cfg: Config,
                  device: torch.device) -> FeatureMeta:
    """Per-feature metadata and stored layout on the device
    (``_feature_meta_from_dataset``, gbdt.py:127-170 of the JAX
    package)."""
    mappers = [ds.bin_mappers[j] for j in ds.used_features]
    penalty = np.ones(len(mappers), np.float32)
    if cfg.feature_contri:
        fc = np.asarray(cfg.feature_contri, np.float32)
        for i, rj in enumerate(ds.used_features):
            if rj < len(fc):
                penalty[i] = fc[rj]

    def as_long(vals):
        return torch.as_tensor(np.asarray(vals, np.int64), device=device)

    (feat_col, feat_offset, feat_bundled, pack_div, pack_mod,
     pack_partner) = ds.feature_layout()
    is_cat = [m.bin_type == BinType.CATEGORICAL for m in mappers]
    return FeatureMeta(
        num_bin=as_long([m.num_bin for m in mappers]),
        missing_type=as_long([m.missing_type for m in mappers]),
        default_bin=as_long([m.default_bin for m in mappers]),
        penalty=torch.as_tensor(penalty, device=device),
        col=as_long(feat_col), offset=as_long(feat_offset),
        bundled=torch.as_tensor(feat_bundled, device=device),
        pack_div=as_long(pack_div), pack_mod=as_long(pack_mod),
        pack_partner=as_long(pack_partner),
        is_categorical=(torch.as_tensor(is_cat, device=device)
                        if any(is_cat) else None))


def categorical_features(ds: BinnedDataset) -> tuple:
    """The inner indices of the dataset's categorical features, which the
    split search runs the categorical finder over (``with_categorical``,
    gbdt.py:683 of the JAX package)."""
    return tuple(i for i, j in enumerate(ds.used_features)
                 if ds.bin_mappers[j].bin_type == BinType.CATEGORICAL)


def category_words(ds: BinnedDataset) -> int:
    """Words of a raw-category bitset: at least 8, and enough for the
    largest category any categorical mapper keeps (gbdt.py:2365-2369 of the
    JAX package)."""
    max_cat = max((max(m.bin_2_categorical) for m in ds.bin_mappers
                   if m.bin_type == BinType.CATEGORICAL
                   and m.bin_2_categorical), default=0)
    return max(8, (max_cat + 32) // 32)


# iterations a block of ``train_many`` draws its keys for, as the JAX
# package fuses at most 64 into one device program (gbdt.py:1896 there)
TRAIN_BLOCK = 64


def as_f32(value: float) -> float:
    """``value`` rounded to float32: a Python float compared with a float32
    array in the JAX package is weakly typed and compares as float32."""
    return float(np.float32(value))


class GBDT:
    """Boosting driver (boosting.h:22-294, gbdt.{h,cpp})."""

    boosting_type = "gbdt"
    average_output = False

    def __init__(self, config: Config, train_data: Optional[BinnedDataset],
                 objective: Optional[ObjectiveFunction],
                 metrics: Optional[List[Metric]] = None,
                 device: torch.device = torch.device("cpu")):
        self.config = config
        self.device = device
        self.train_data = train_data
        self.objective = objective
        self.train_metrics = metrics or []
        self.models: List[HostTree] = []
        self.iter_ = 0
        self.shrinkage_rate = config.learning_rate
        self._stopped = False
        self.num_class = config.num_class
        self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None
            else max(1, config.num_class))
        # each class's init score, folded into its first tree
        self.init_score_offsets = np.zeros(self.num_tree_per_iteration,
                                           np.float32)
        self.valid_metrics: List[List[Metric]] = []
        # each valid set's binned matrix and running scores on the device
        self._valid: List[Dict[str, torch.Tensor]] = []
        if train_data is not None:
            self._setup_train(train_data)

    def _setup_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        check_slice(cfg)
        dev = self.device
        self.num_data = ds.num_data
        self.xb = torch.as_tensor(ds.X_binned, device=dev)     # [N, C]
        self.feature_meta = _feature_meta(ds, cfg, dev)
        # histograms span the stored columns' bins, the split search the
        # features' (gbdt.py:482-483 of the JAX package)
        self.num_bins = max(ds.max_col_bins(), 2)
        num_feat_bins = max(ds.max_num_bin(), 2)
        _, _, _, _, pack_mod, pack_partner = ds.feature_layout()
        self._cat_words = category_words(ds)
        if self.objective is not None:
            self.objective.init(ds.metadata, dev)
        for m in self.train_metrics:
            m.init(ds.metadata, ds.num_data)
        self.grow_params = GrowParams(
            num_leaves=cfg.num_leaves, num_bins=self.num_bins,
            max_depth=cfg.max_depth,
            split=SplitParams(
                lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
                max_delta_step=cfg.max_delta_step,
                min_data_in_leaf=cfg.min_data_in_leaf,
                min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
                min_gain_to_split=cfg.min_gain_to_split,
                max_cat_threshold=cfg.max_cat_threshold,
                cat_smooth=cfg.cat_smooth, cat_l2=cfg.cat_l2,
                max_cat_to_onehot=cfg.max_cat_to_onehot,
                min_data_per_group=cfg.min_data_per_group,
                cat_features=categorical_features(ds)),
            hist_impl=resolve_hist_impl(cfg),
            batch_splits=cfg.tree_batch_splits,
            batched_pack=bool(cfg.tpu_batched_pack),
            batched_part=batched_part_on(cfg),
            with_efb=ds.has_bundles or ds.has_packed,
            num_feat_bins=num_feat_bins,
            pack_j=int(pack_partner.max(initial=1)),
            packed_features=tuple(int(i) for i in np.nonzero(pack_mod)[0]))
        # one place decides which grower runs (gbdt.py:1150-1160 of the
        # JAX package)
        self._grow = (grow_tree_batched_part if self.grow_params.batched_part
                      else GROWERS[cfg.tree_growth])
        self._init_scores_provided = ds.metadata.init_score is not None
        self.scores = torch.as_tensor(self._initial_scores(ds), device=dev)
        self.boost_from_average_done = False
        self._rng = np.random.RandomState(cfg.feature_fraction_seed)
        # bagging (gbdt.py:786-807 of the JAX package): the threefry key and
        # the mask it last drew, kept between refreshes; under lambdarank
        # one draw a query (and one for the padding group the JAX package
        # counts in), broadcast to its rows
        self._bag_key = threefry.prng_key(cfg.bagging_seed)
        self._bag_mask = torch.ones(ds.num_data, dtype=torch.float32,
                                    device=dev)
        self._row_group, self._num_groups = None, 0
        qb = ds.metadata.query_boundaries
        if qb is not None and getattr(self.objective, "name",
                                      "") == "lambdarank":
            qb = np.asarray(qb, np.int64)
            self._row_group = torch.as_tensor(
                np.repeat(np.arange(len(qb) - 1), np.diff(qb)), device=dev)
            self._num_groups = len(qb)
        # RenewTreeOutput (L1, quantile, MAPE): the percentile, the label
        # space the gradients see and the weights of the refit
        obj = self.objective
        self._renew_alpha = (float(obj.renew_percentile())
                             if hasattr(obj, "renew_percentile") else None)
        if self._renew_alpha is not None:
            self._renew_label = getattr(obj, "trans_label", obj.label)
            rw = obj.label_weight if obj.name == "mape" else obj.weights
            self._renew_weight = (torch.ones_like(obj.label) if rw is None
                                  else rw)

    def _initial_scores(self, ds: BinnedDataset) -> np.ndarray:
        """[N, K] float32 scores from the data's init score, zeros without
        one (ScoreUpdater, score_updater.hpp:32-51): N * K values are
        class-major, N values serve every class (gbdt.py:766-778 of the
        JAX package)."""
        n, k = ds.num_data, self.num_tree_per_iteration
        scores = np.zeros((n, k), np.float32)
        if ds.metadata.init_score is not None:
            isc = np.asarray(ds.metadata.init_score, np.float32).reshape(-1)
            scores[:] = (isc.reshape(k, n).T if len(isc) == n * k
                         else isc[:n, None])
        return scores

    def add_valid_data(self, ds: BinnedDataset,
                       metrics: List[Metric]) -> None:
        """A validation set binned with the training set's mappers, with its
        scores held on the device (gbdt.cpp AddValidDataset)."""
        for m in metrics:
            m.init(ds.metadata, ds.num_data)
        cache = {"xb": torch.as_tensor(ds.X_binned, device=self.device),
                 "scores": torch.as_tensor(self._initial_scores(ds),
                                           device=self.device)}
        if self.models and ds.metadata.init_score is None:
            # the trees so far, merged init-model trees included; each
            # class's first one carries its folded init score
            # (score_updater.hpp:32-51)
            k = self.num_tree_per_iteration
            for i, ht in enumerate(self.models):
                cache["scores"][:, i % k] += self._tree_output(
                    ht, self._binned_tree(ht), cache["xb"])
        self.valid_metrics.append(metrics)
        self._valid.append(cache)

    def merge_init_models(self, models: List) -> None:
        """Continued training: start from copies of an init model's trees
        (GBDT::MergeFrom, gbdt.h:53). Their bins are taken anew from their
        real thresholds and raw category bitsets with this training set's
        mappers, which gives back a tree's own bins when it was trained on
        these mappers, and the bins of a loaded tree, whose model text has
        none. They are feature bins: ``_binned_tree`` places them in the
        stored columns.

        A category that this training set's mapper does not know has no
        bin of its own: it bins to 0, the catch-all that never goes left.
        So the replay of a categorical node sends such a category right
        where raw prediction follows the tree's bitset; for every category
        the mapper knows, the two agree."""
        ds = self.train_data
        merged = copy.deepcopy(list(models))
        for ht in merged:
            nn = max(int(ht.num_leaves_actual) - 1, 0)
            ht.cat_bitset_bin = np.zeros((max(nn, 1), 8), np.uint32)
            for i in range(nn):
                mapper = ds.bin_mappers[int(ht.split_feature[i])]
                if not ht.is_categorical[i]:
                    ht.threshold_bin[i] = mapper.values_to_bins(
                        np.array([ht.threshold[i]]))[0]
                    continue
                cats = np.flatnonzero(np.unpackbits(
                    np.ascontiguousarray(ht.cat_bitset[i], "<u4")
                    .view(np.uint8), bitorder="little"))
                bins = np.array([mapper.categorical_2_bin.get(int(v), 0)
                                 for v in cats], np.int64)
                bins = bins[bins > 0]
                np.bitwise_or.at(ht.cat_bitset_bin[i], bins >> 5,
                                 (np.uint32(1) << (bins & 31)
                                  .astype(np.uint32)))
        self.models = merged
        self.iter_ = len(merged) // self.num_tree_per_iteration

    # ------------------------------------------------------------ training
    def _boost_from_average(self) -> None:
        """gbdt.cpp:298-331: seed each class's scores with the objective's
        init score for that class (gbdt.py:861-878 of the JAX package)."""
        if (self.boost_from_average_done or self.objective is None
                or not self.config.boost_from_average
                or self._init_scores_provided):
            self.boost_from_average_done = True
            return
        inits = np.array([self.objective.boost_from_score(c)
                          for c in range(self.num_tree_per_iteration)],
                         np.float32)
        if np.any(inits != 0):
            add = torch.as_tensor(inits, device=self.device)
            self.scores = self.scores + add
            for cache in self._valid:
                cache["scores"] = cache["scores"] + add
        self.init_score_offsets = inits
        self.boost_from_average_done = True

    def _sample_feature_mask(self) -> torch.Tensor:
        """Per-tree column sampling (serial_tree_learner.cpp:271-292), the
        JAX package's numpy draw."""
        f = self.train_data.num_features
        frac = self.config.feature_fraction
        mask = np.ones(f, bool)
        if frac < 1.0 and f > 0:
            mask[:] = False
            mask[self._rng.choice(f, max(1, int(f * frac)),
                                  replace=False)] = True
        return torch.as_tensor(mask, device=self.device)

    def _draw_bag_mask(self, key) -> None:
        """A new bagging mask from ``key``: each row (under lambdarank each
        query) in the bag where its uniform is below ``bagging_fraction``
        (gbdt.cpp:180-241)."""
        n = (self._num_groups if self._row_group is not None
             else self.num_data)
        u = threefry.uniform(key, n, self.device)
        if self._row_group is not None:
            u = u[self._row_group]
        self._bag_mask = (u < as_f32(self.config.bagging_fraction)).to(
            torch.float32)

    def _sample_bagging_mask(self, iter_idx: int) -> torch.Tensor:
        """The bagging mask of iteration ``iter_idx`` on the per-iteration
        key stream: a new one from a split of the key every
        ``bagging_freq`` iterations, else the last (gbdt.py:1031-1046 of
        the JAX package)."""
        cfg = self.config
        if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0 \
                and iter_idx % cfg.bagging_freq == 0:
            self._bag_key, sub = threefry.split(self._bag_key)
            self._draw_bag_mask(sub)
        return self._bag_mask

    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration on the per-iteration key stream: the
        bagging mask of this iteration, then a split of the key whose
        second half is GOSS's (gbdt.py:2208-2211 of the JAX package), taken
        whether or not GOSS is on. See ``_train_iteration``."""
        if self._stopped:
            return True
        sample_mask = self._sample_bagging_mask(self.iter_)
        self._bag_key, goss_key = threefry.split(self._bag_key)
        return self._train_iteration(grad, hess, sample_mask, goss_key)

    def train_many(self, num_iters: int) -> bool:
        """``num_iters`` iterations with the keys of the JAX package's fused
        loop (``GBDT.train_many``, gbdt.py:1862-1930 and the block's
        :1622-1647 there): a block of at most TRAIN_BLOCK iterations splits
        the key into ``block + 1``, keeps the first, and iteration i splits
        key ``i + 1`` into its bagging key and its GOSS key; the mask
        refreshes inside the block on the bagging schedule. The host still
        grows one iteration at a time. DART and RF, whose iterations need
        the host in between, take the per-iteration stream. Returns True
        when training has stopped."""
        if self.boosting_type not in ("gbdt", "goss"):
            for _ in range(num_iters):
                if self.train_one_iter():
                    return True
            return False
        cfg = self.config
        bagging = cfg.bagging_freq > 0 and 0.0 < cfg.bagging_fraction < 1.0
        done = 0
        while done < num_iters and not self._stopped:
            block = min(num_iters - done, TRAIN_BLOCK)
            keys = threefry.split(self._bag_key, block + 1)
            self._bag_key = keys[0]
            for key in keys[1:]:
                bag_key, goss_key = threefry.split(key)
                if bagging and self.iter_ % cfg.bagging_freq == 0:
                    self._draw_bag_mask(bag_key)
                if self._train_iteration(None, None, self._bag_mask,
                                         goss_key):
                    return True
            done += block
        return self._stopped

    def _objective_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, N] gradients and hessians of the objective at the current
        scores (0 and 1 without an objective)."""
        k = self.num_tree_per_iteration
        if self.objective is None:
            return (torch.zeros((k, self.num_data), device=self.device),
                    torch.ones((k, self.num_data), device=self.device))
        if k == 1:
            return tuple(a.unsqueeze(0) for a in
                         self.objective.get_gradients(self.scores[:, 0]))
        return tuple(a.t().contiguous() for a in
                     self.objective.get_gradients(self.scores))

    def _row_sample(self, grad: torch.Tensor, hess: torch.Tensor,
                    sample_mask: torch.Tensor, goss_key
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The gradients, hessians and row mask the trees grow on: the
        bagging mask as it is here; GOSS amends all three."""
        return grad, hess, sample_mask

    def _train_iteration(self, grad, hess, sample_mask: torch.Tensor,
                         goss_key) -> bool:
        """One boosting iteration (gbdt.cpp TrainOneIter:333-412): one tree
        a class, grown in class order from the gradients of the scores at
        the iteration's start, on the rows of ``sample_mask`` (their count
        channel; renewal refits on them too). Returns True when training
        has stopped (no class's tree could split).

        ``grad`` and ``hess`` (K * N values of a custom objective,
        class-major, on the host or the device) take the objective's place
        (gbdt.py:2165-2206 of the JAX package): they go to the device as
        float32 once, before the trees' kernels, and neither boost from
        average nor leaf renewal runs on this path. Without an objective
        and without them, the gradients are 0 and the hessians 1, as in the
        JAX package.

        A class tree that does not split while another class's does is kept
        as the JAX package keeps it: its one leaf's value, the root's
        output, joins the scores and the model (gbdt.py:1354-1360 there);
        only an iteration in which no class's tree splits stops training,
        and the first iteration then keeps constant trees that reproduce
        the init scores (AsConstantTree, gbdt.cpp:379-396)."""
        external = grad is not None
        if external:
            # given gradients: no boost from average, now or later
            # (gbdt.cpp TrainOneIter boosts from the average only on its
            # objective's path, and only before the first tree)
            self.boost_from_average_done = True
        self._boost_from_average()
        k = self.num_tree_per_iteration
        if external:
            grad, hess = (self.device_gradients(a, name)
                          for a, name in ((grad, "grad"), (hess, "hess")))
        else:
            grad, hess = self._objective_gradients()
        grad, hess, sample_mask = self._row_sample(grad, hess, sample_mask,
                                                   goss_key)
        feature_mask = self._sample_feature_mask()
        grown = [self._grow(self.xb, grad[c], hess[c], sample_mask,
                            self.feature_meta, feature_mask,
                            self.grow_params) for c in range(k)]
        if all(tree.num_leaves <= 1 for tree, _ in grown):
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if not self.models:
                # constant trees reproduce the init scores
                # (AsConstantTree, gbdt.cpp:379-396)
                for c in range(k):
                    ht = HostTree(self.config.num_leaves)
                    ht.leaf_value[0] = self.init_score_offsets[c]
                    self.models.append(ht)
            self._stopped = True
            return True
        deltas, host_trees = [], []
        for tree, leaf_id in grown:
            leaf_value = torch.as_tensor(tree.leaf_value, device=self.device)
            if self._renew_alpha is not None and not external:
                # refit the leaves to the weighted percentile of the
                # residuals against the pre-update scores (gbdt.py:1330-1351
                # of the JAX package); only leaf_value changes
                leaf_value = renew_leaf_values(
                    self._renew_label - self.scores[:, 0], self._renew_weight,
                    leaf_id, sample_mask, self.config.num_leaves,
                    self._renew_alpha, leaf_value)
                tree = tree._replace(leaf_value=leaf_value.cpu().numpy())
            deltas.append(leaf_value[leaf_id] * float(self.shrinkage_rate))
            ht = self._extract_host_tree(tree)
            ht.shrink(self.shrinkage_rate)
            host_trees.append(ht)
        self.scores = self.scores + torch.stack(deltas, dim=1)
        # valid scores take the shrunk trees before the init-score fold:
        # _boost_from_average added the init scores to them already
        self._update_valid_scores(host_trees)
        if not self.models:
            # fold each class's init score into its first tree so the saved
            # model is self-contained (AddBias, gbdt.cpp:374-376)
            for ht, init in zip(host_trees, self.init_score_offsets):
                if abs(float(init)) > 1e-15:
                    ht.leaf_value += float(init)
                    ht.internal_value += float(init)
        self.models.extend(host_trees)
        self.iter_ += 1
        return False

    def device_gradients(self, values, name: str) -> torch.Tensor:
        """A custom objective's values as [K, N] float32 on the booster's
        device: K * N values class-major (the layout ``fobj`` returns, as
        the reference's python package takes it) or an [N, K] array, one
        blocking copy from the host, none for a tensor there already
        (gbdt.py:2197-2205 of the JAX package)."""
        n, k = self.num_data, self.num_tree_per_iteration
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.ascontiguousarray(values,
                                                           np.float32))
        if values.numel() != n * k:
            raise LightGBMError("%s has %d values; the training set has %d "
                                "rows and %d classes" % (
                                    name, values.numel(), n, k))
        values = values.to(self.device, torch.float32, non_blocking=False)
        if values.dim() == 1 or k == 1:
            return values.reshape(k, n)
        return values.reshape(n, k).t().contiguous()

    def _extract_host_tree(self, t: TreeArrays) -> HostTree:
        """Tree arrays -> HostTree with real thresholds, and the bin-space
        bitset of each categorical node turned into raw category values
        (the reference stores cat_threshold in value space, tree.cpp; JAX
        gbdt.py:2364-2388)."""
        ds = self.train_data
        ht = HostTree(self.config.num_leaves)
        nl = t.num_leaves
        nn = nl - 1
        ht.num_leaves_actual = nl
        inner = t.split_feature[:nn]
        ht.split_feature[:nn] = [ds.real_feature_index(int(j)) for j in inner]
        ht.split_gain[:nn] = t.split_gain[:nn]
        ht.threshold_bin[:nn] = t.threshold_bin[:nn]
        ht.threshold[:nn] = [
            0.0 if is_cat else ds.bin_mappers[int(f)].bin_to_value(int(b))
            for f, b, is_cat in zip(ht.split_feature[:nn],
                                    t.threshold_bin[:nn],
                                    t.is_categorical[:nn])]
        ht.default_left[:nn] = t.default_left[:nn]
        ht.missing_type[:nn] = t.missing_type[:nn]
        ht.is_categorical[:nn] = t.is_categorical[:nn]
        ht.cat_bitset_bin[:nn] = t.cat_bitset[:nn]
        ht.cat_bitset = np.zeros((max(nn, 1), self._cat_words), np.uint32)
        for i in np.flatnonzero(t.is_categorical[:nn]):
            mapper = ds.bin_mappers[int(ht.split_feature[i])]
            bits = np.unpackbits(np.ascontiguousarray(t.cat_bitset[i], "<u4")
                                 .view(np.uint8), bitorder="little")
            bins = np.flatnonzero(bits[1:mapper.num_bin]) + 1
            cats = np.asarray(mapper.bin_2_categorical, np.int64)[bins - 1]
            np.bitwise_or.at(ht.cat_bitset[i], cats >> 5,
                             np.uint32(1) << (cats & 31).astype(np.uint32))
        ht.left_child[:nn] = t.left_child[:nn]
        ht.right_child[:nn] = t.right_child[:nn]
        ht.split_leaf[:nn] = t.split_leaf[:nn]
        ht.internal_value[:nn] = t.internal_value[:nn]
        ht.internal_weight[:nn] = t.internal_weight[:nn]
        ht.internal_count[:nn] = np.round(t.internal_count[:nn])
        ht.leaf_value[:] = t.leaf_value
        ht.leaf_weight[:] = t.leaf_weight
        ht.leaf_count[:] = np.round(t.leaf_count)
        return ht

    # ------------------------------------------------------------ scoring
    def _binned_tree(self, ht) -> tree_mod.BinnedTree:
        """Host tree -> its bin-space table for the training set's stored
        layout, which every valid set shares: each node's stored column
        and how to decode it (gbdt.py:2454-2468 of the JAX package)."""
        ds = self.train_data
        feats = [int(f) for f in
                 ht.split_feature[:max(int(ht.num_leaves_actual) - 1, 0)]]
        inner = np.array([max(ds.inner_feature_index(f), 0) for f in feats],
                         np.int64)
        feat_col, feat_offset, _, pack_div, pack_mod, _ = \
            ds.feature_layout()
        return tree_mod.binned_tree(
            ht, feat_col[inner], feat_offset[inner], pack_div[inner],
            pack_mod[inner],
            np.array([ds.bin_mappers[f].num_bin for f in feats], np.int64),
            np.array([ds.bin_mappers[f].default_bin for f in feats],
                     np.int64), self.device)

    def _tree_output(self, ht, binned: tree_mod.BinnedTree,
                     xb: torch.Tensor) -> torch.Tensor:
        """[N] float32 output of host tree ``ht`` (``binned`` its bin-space
        table) for every row of the binned matrix ``xb``."""
        leaf = tree_mod.replay_leaves_binned(binned, xb)
        lv = torch.as_tensor(ht.leaf_value.astype(np.float32),
                             device=self.device)
        return lv[leaf]

    def _iteration_output(self, host_trees: List[HostTree], binned: List,
                          xb: torch.Tensor) -> torch.Tensor:
        """[N, K] float32 output of one iteration's trees, one a class."""
        return torch.stack([self._tree_output(ht, b, xb)
                            for ht, b in zip(host_trees, binned)], dim=1)

    def _update_valid_scores(self, host_trees: List[HostTree]) -> None:
        """Add an iteration's trees, one a class, to each valid set's
        scores of their class (ScoreUpdater::AddScore)."""
        if not self._valid:
            return
        binned = [self._binned_tree(ht) for ht in host_trees]
        for cache in self._valid:
            cache["scores"] = cache["scores"] + self._iteration_output(
                host_trees, binned, cache["xb"])

    def rollback_one_iter(self) -> None:
        """GBDT::RollbackOneIter (gbdt.cpp:414-430): drop the last
        iteration's trees, one a class, and take their output back out of
        the training and valid scores."""
        if not self.models:
            return
        k = self.num_tree_per_iteration
        dropped = self.models[-k:]
        del self.models[-k:]
        binned = [self._binned_tree(ht) for ht in dropped]
        self.scores = self.scores - self._iteration_output(dropped, binned,
                                                           self.xb)
        for cache in self._valid:
            cache["scores"] = cache["scores"] - self._iteration_output(
                dropped, binned, cache["xb"])
        self.iter_ -= 1

    # ------------------------------------------------------------ evaluation
    def scores_of(self, data_idx: int) -> np.ndarray:
        """Raw scores on the host, [N] for one class and [N, K] for K: the
        training set's (0) or valid set ``data_idx - 1``'s."""
        scores = (self.scores if data_idx == 0
                  else self._valid[data_idx - 1]["scores"])
        if self.num_tree_per_iteration == 1:
            scores = scores[:, 0]
        return scores.cpu().numpy()

    def get_eval_at(self, data_idx: int) -> List[Tuple[str, str, float,
                                                       bool]]:
        """Metrics of the training set (0) or a valid set (1..) as
        (data_name, metric_name, value, bigger_better) (gbdt.cpp
        OutputMetric:476-533)."""
        scores = self.scores_of(data_idx)
        if data_idx == 0:
            name, metrics = "training", self.train_metrics
        else:
            name = "valid_%d" % (data_idx - 1)
            metrics = self.valid_metrics[data_idx - 1]
        out = []
        convert = (None if self.objective is None
                   else self.objective.convert_output)
        for m in metrics:
            for mname, v in zip(m.names, m.eval(scores, convert)):
                out.append((name, mname, v, m.factor_to_bigger_better > 0))
        return out

    # ------------------------------------------------------------ prediction
    def predict(self, data: np.ndarray, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        """Batch prediction on raw feature values (GBDT::Predict,
        gbdt_prediction.cpp:49-83): [N] for one class, [N, K] for K, each
        class the sum of its trees (tree ``i`` is class ``i % K``) over the
        first ``num_iteration`` iterations, divided by their number in an
        averaged (RF) model (gbdt.py:2579-2580 of the JAX package)."""
        data = np.asarray(data, np.float64)
        if data.ndim == 1:
            data = data.reshape(1, -1)
        k = self.num_tree_per_iteration
        total = len(self.models) // k
        use = total if num_iteration is None or num_iteration <= 0 \
            else min(num_iteration, total)
        if use == 0:
            out = np.zeros((data.shape[0], k), np.float64)
        else:
            x = torch.as_tensor(data, device=self.device)
            out = torch.stack([tree_mod.predict_forest_scores(
                tree_mod.stack_predict_trees(self.models[c:use * k:k],
                                             self.device), x)
                for c in range(k)], dim=1).cpu().numpy().astype(np.float64)
        if self.average_output and use > 0:
            out = out / use
        if k == 1:
            out = out[:, 0]
        if not raw_score and self.objective is not None:
            out = np.asarray(self.objective.convert_output(out))
        return out

    @property
    def current_iteration(self) -> int:
        return len(self.models) // self.num_tree_per_iteration

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """GBDT::FeatureImportance: split counts or summed gains."""
        if self.train_data is not None:
            num_feat = self.train_data.num_total_features
        else:
            num_feat = int(max((t.split_feature.max(initial=-1)
                                for t in self.models), default=-1)) + 1
        imp = np.zeros(num_feat, np.float64)
        n_models = (len(self.models) if iteration is None or iteration <= 0
                    else min(iteration * self.num_tree_per_iteration,
                             len(self.models)))
        for t in self.models[:n_models]:
            for i in range(t.num_leaves_actual - 1):
                if importance_type == "split":
                    imp[t.split_feature[i]] += 1
                else:
                    imp[t.split_feature[i]] += t.split_gain[i]
        return imp
