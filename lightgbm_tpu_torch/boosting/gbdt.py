"""GBDT training driver.

The port of ``lightgbm_tpu/boosting/gbdt.py`` (gbdt.cpp Init :45-115,
TrainOneIter :333-412, UpdateScore :451-470 of the reference) for the slice
the port covers: binary objective, dense numerical features, one device,
and the three growth modes of ``tree_growth``: leaf-wise ``exact``
(``core/grow.py``), ``frontier`` waves (``core/grow_frontier.py``) and
top-K ``batched`` steps (``core/grow_batched.py``, or
``core/grow_batched_part.py`` over rows kept grouped by leaf with
``tpu_batched_part=true``). Each iteration
computes gradients on the device, grows one tree, adds its shrunk leaf
values to the training scores through the per-row leaf ids, and keeps the
tree on the host as a ``HostTree`` with real-valued thresholds.

Every option outside the slice raises ``NotImplementedError`` from
``check_slice`` before anything is built, naming the later slice of the
port that brings it: the port never builds a different tree than the one
asked for.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core import tree as tree_mod
from ..core.grow import GrowParams, TreeArrays, grow_tree
from ..core.grow_batched import grow_tree_batched
from ..core.grow_batched_part import grow_tree_batched_part
from ..core.grow_frontier import grow_tree_frontier
from ..core.histogram import HIST_IMPLS
from ..core.split import FeatureMeta, SplitParams
from ..io.dataset import BinnedDataset
from ..log import Log, outside_slice
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
        (cfg.objective != "binary" or cfg.num_class > 1,
         "objective=%s num_class=%d" % (cfg.objective, cfg.num_class),
         "ROADMAP Queue 1 #2: other objectives and multiclass"),
        (cfg.boosting == "goss", "boosting=goss",
         "ROADMAP Queue 1 #7: GOSS"),
        (cfg.boosting == "dart", "boosting=dart",
         "ROADMAP Queue 1 #7: DART"),
        (cfg.boosting == "rf", "boosting=rf", "ROADMAP Queue 1 #7: RF"),
        (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0, "bagging",
         "ROADMAP Queue 1 #7: bagging"),
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
    mappers = [ds.bin_mappers[j] for j in ds.used_features]
    penalty = np.ones(len(mappers), np.float32)
    if cfg.feature_contri:
        fc = np.asarray(cfg.feature_contri, np.float32)
        for i, rj in enumerate(ds.used_features):
            if rj < len(fc):
                penalty[i] = fc[rj]

    def as_long(vals):
        return torch.as_tensor(np.asarray(vals, np.int64), device=device)

    return FeatureMeta(
        num_bin=as_long([m.num_bin for m in mappers]),
        missing_type=as_long([m.missing_type for m in mappers]),
        default_bin=as_long([m.default_bin for m in mappers]),
        penalty=torch.as_tensor(penalty, device=device))


class GBDT:
    """Boosting driver (boosting.h:22-294, gbdt.{h,cpp})."""

    num_class = 1
    num_tree_per_iteration = 1
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
        self.init_score_offset = 0.0
        if train_data is not None:
            self._setup_train(train_data)

    def _setup_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        check_slice(cfg)
        dev = self.device
        self.num_data = ds.num_data
        self.xb = torch.as_tensor(ds.X_binned, device=dev)
        self.feature_meta = _feature_meta(ds, cfg, dev)
        self.num_bins = max(ds.max_num_bin(), 2)
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
                min_gain_to_split=cfg.min_gain_to_split),
            hist_impl=resolve_hist_impl(cfg),
            batch_splits=cfg.tree_batch_splits,
            batched_pack=bool(cfg.tpu_batched_pack),
            batched_part=batched_part_on(cfg))
        # one place decides which grower runs (gbdt.py:1150-1160 of the
        # JAX package)
        self._grow = (grow_tree_batched_part if self.grow_params.batched_part
                      else GROWERS[cfg.tree_growth])
        scores = np.zeros(ds.num_data, np.float32)
        self._init_scores_provided = ds.metadata.init_score is not None
        if self._init_scores_provided:
            scores[:] = np.asarray(ds.metadata.init_score,
                                   np.float32).reshape(-1)[:ds.num_data]
        self.scores = torch.as_tensor(scores, device=dev)
        self.boost_from_average_done = False
        self._rng = np.random.RandomState(cfg.feature_fraction_seed)
        self._sample_mask = torch.ones(ds.num_data, dtype=torch.float32,
                                       device=dev)

    # ------------------------------------------------------------ training
    def _boost_from_average(self) -> None:
        """gbdt.cpp:298-331: seed the scores with the objective's init."""
        if (self.boost_from_average_done
                or not self.config.boost_from_average
                or self._init_scores_provided):
            self.boost_from_average_done = True
            return
        init = np.float32(self.objective.boost_from_score(0))
        if init != 0:
            self.scores = self.scores + torch.tensor(init, device=self.device)
        self.init_score_offset = float(init)
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

    def train_one_iter(self) -> bool:
        """One boosting iteration (gbdt.cpp TrainOneIter:333-412). Returns
        True when training has stopped (no tree could split)."""
        if self._stopped:
            return True
        self._boost_from_average()
        grad, hess = self.objective.get_gradients(self.scores)
        tree, leaf_id = self._grow(self.xb, grad, hess, self._sample_mask,
                                   self.feature_meta,
                                   self._sample_feature_mask(),
                                   self.grow_params)
        if tree.num_leaves <= 1:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if not self.models:
                # a constant tree reproduces the init score
                # (AsConstantTree, gbdt.cpp:379-396)
                ht = HostTree(self.config.num_leaves)
                ht.leaf_value[0] = self.init_score_offset
                self.models.append(ht)
            self._stopped = True
            return True
        leaf_value = torch.as_tensor(tree.leaf_value, device=self.device)
        self.scores = self.scores + leaf_value[leaf_id] * float(
            self.shrinkage_rate)
        ht = self._extract_host_tree(tree)
        ht.shrink(self.shrinkage_rate)
        if not self.models and abs(self.init_score_offset) > 1e-15:
            # fold the init score into the first tree so the saved model is
            # self-contained (AddBias, gbdt.cpp:374-376)
            ht.leaf_value += self.init_score_offset
            ht.internal_value += self.init_score_offset
        self.models.append(ht)
        self.iter_ += 1
        return False

    def _extract_host_tree(self, t: TreeArrays) -> HostTree:
        """Tree arrays -> HostTree with real thresholds."""
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
            ds.bin_mappers[int(f)].bin_to_value(int(b))
            for f, b in zip(ht.split_feature[:nn], t.threshold_bin[:nn])]
        ht.default_left[:nn] = t.default_left[:nn]
        ht.missing_type[:nn] = t.missing_type[:nn]
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

    # ------------------------------------------------------------ evaluation
    def get_eval_at(self, data_idx: int) -> List[Tuple[str, str, float,
                                                       bool]]:
        """Training-set metrics as (data_name, metric_name, value,
        bigger_better) (gbdt.cpp OutputMetric:476-533)."""
        if data_idx != 0:
            raise outside_slice("validation sets", "ROADMAP Queue 1 #7")
        scores = self.scores.cpu().numpy()
        out = []
        for m in self.train_metrics:
            for name, v in zip(m.names, m.eval(scores,
                                               self.objective.convert_output)):
                out.append(("training", name, v,
                            m.factor_to_bigger_better > 0))
        return out

    # ------------------------------------------------------------ prediction
    def predict(self, data: np.ndarray, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        """Batch prediction on raw feature values (GBDT::Predict,
        gbdt_prediction.cpp:49-83)."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data.reshape(1, -1)
        use = len(self.models) if num_iteration is None or num_iteration <= 0 \
            else min(num_iteration, len(self.models))
        if use == 0:
            out = np.zeros(data.shape[0], np.float64)
        else:
            trees = tree_mod.stack_predict_trees(self.models[:use],
                                                 self.device)
            x = torch.as_tensor(data, device=self.device)
            out = tree_mod.predict_forest_scores(trees, x).cpu().numpy() \
                .astype(np.float64)
        if not raw_score and self.objective is not None:
            out = np.asarray(self.objective.convert_output(out))
        return out

    @property
    def current_iteration(self) -> int:
        return len(self.models)

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
                    else min(iteration, len(self.models)))
        for t in self.models[:n_models]:
            for i in range(t.num_leaves_actual - 1):
                if importance_type == "split":
                    imp[t.split_feature[i]] += 1
                else:
                    imp[t.split_feature[i]] += t.split_gain[i]
        return imp
