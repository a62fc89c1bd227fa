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

Monotone constraints (``monotone_constraints``) bound the split search of
every grower. Forced splits (``forcedsplits_filename``) and CEGB
(``cegb_penalty_split``, ``cegb_penalty_feature_coupled``,
``cegb_penalty_feature_lazy``) need exact growth, as in the JAX package
(gbdt.py:522-554 there): the forced steps are read once into BFS order, the
CEGB state lives on the device across iterations, each class's tree of an
iteration grows from the iteration's state and the classes' purchases
merge. Rollback leaves the state as it is, as the JAX package does.

Float64 histograms (``gpu_use_dp``, ``tpu_hist_dtype=float64``;
``hist_dtype``) grow in exact growth only: under frontier or batched the
JAX package's warning is logged and ``grow_tree`` runs (gbdt.py:566-570
there). The JAX package then runs with 64-bit types on, so its bagging
and GOSS uniforms are float64: ``_draw_dtype`` draws them the same way.

Packed bin words and out-of-core streaming (``_setup_bins``): under
``tpu_bin_packing=byte|nibble`` the frontier grower with float32
histograms keeps the training bins on the device as int32 words of four
codes (``core/binpack.py``; ``auto`` is none in memory off a TPU), which
both histogram kernels read in place; a streamed dataset
(``data_stream_chunk_rows > 0``, ``stream/``) stays on the host in chunks
that a ``ChunkPipeline`` copies to the card ahead of each sweep, packed
into words unless the option says ``none``, and
``stream.StreamFrontierGrower`` grows its trees (gbdt or GOSS, f32,
frontier; config.py refuses the rest). Replays of the training rows
(rollback, a reset, DART) unpack the words; a streamed booster refuses
them and custom gradients, as the JAX package does.

Observability (``obs/``): ``self.obs`` is the booster's ``TrainingObs``.
Under ``observability=none`` with no health action the loop adds no
launch, sync or allocation. Otherwise each iteration builds its health
vector on the device (``obs/health.py`` ``health_vec``, from the gradients
and whether a tree split, plus the frontier grower's waves and non-finite
gains): ``basic`` keeps ``train_many``'s blocks and fetches a block's rows
once at its end, with a ``train_block`` span and a ``block`` event;
``full`` dispatches one iteration at a time, with a ``train_iter`` span,
an ``iteration`` event and one fetch an iteration (the JAX package's
granularity, gbdt.py:1512-1583 and :1905-1960 there). ``obs_modelstats``
feeds ``obs/modelstats.py`` from the host trees of every grower.

Every option outside the slice raises ``NotImplementedError`` from
``check_slice`` before anything is built, naming the ROADMAP item that
brings it: the port never builds a different tree than the one asked for.
"""
from __future__ import annotations

import copy
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core import tree as tree_mod
from ..core.grow import (Cegb, CegbState, ForcedSplits, GrowParams,
                         TreeArrays, grow_tree)
from ..core.grow_batched import grow_tree_batched
from ..core.grow_batched_part import grow_tree_batched_part
from ..core.binpack import (pack_words_np, resolve_bin_packing,
                            unpack_words, words_per_row)
from ..core.grow_frontier import GrowerHealth, grow_tree_frontier
from ..core.histogram import HIST_IMPLS
from ..core.renew import renew_leaf_values
from ..core.split import FeatureMeta, SplitParams
from .. import random as threefry
from ..io.binning import BinType
from ..io.dataset import BinnedDataset
from ..log import LightGBMError, Log, check, outside_slice
from ..metrics import Metric
from ..objectives import ObjectiveFunction
from ..obs.health import health_vec
from ..obs.runtime import TrainingObs
from ..resilience import faults
from ..stream.grow_stream import StreamFrontierGrower
from ..stream.pipeline import ChunkPipeline

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
        # the cross-process telemetry (DistributedObs): one process is the
        # JAX package's auto, which is off
        (cfg.obs_distributed == "on",
         "obs_distributed=on (cross-process telemetry)",
         "ROADMAP Queue 1 #13"),
        (cfg.tree_learner != "serial" or bool(cfg.mesh_shape)
         or cfg.num_machines > 1, "a device mesh (tree_learner=%s)"
         % cfg.tree_learner, "ROADMAP Queue 1 #13"),
    ]
    for bad, what, where in rules:
        if bad:
            raise outside_slice(what, where)


def hist_dtype(cfg: Config) -> str:
    """Histogram accumulation dtype (the JAX package's ``_hist_dtype``,
    gbdt.py:171-180 there): tpu_hist_dtype is the explicit knob,
    gpu_use_dp (config.h:784) the reference-compatible alias for f64."""
    spelled = str(cfg.tpu_hist_dtype).strip().lower()
    if spelled in ("float64", "f64", "double"):
        return "f64"
    if spelled not in ("float32", "f32", "single", ""):
        raise LightGBMError("unknown tpu_hist_dtype %r "
                            "(use float32 or float64)" % cfg.tpu_hist_dtype)
    return "f64" if cfg.gpu_use_dp else "f32"


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

    monotone = np.zeros(len(mappers), np.int64)
    if cfg.monotone_constraints:
        mc = np.asarray(cfg.monotone_constraints, np.int64)
        # the constraint list must cover every feature (dataset.cpp:295):
        # zero-filling would drop constraints the user asked for
        check(len(mc) == ds.num_total_features,
              "monotone_constraints has %d entries but the dataset has %d "
              "features" % (len(mc), ds.num_total_features))
        monotone[:] = mc[ds.used_features]

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
                        if any(is_cat) else None),
        monotone=as_long(monotone))


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


def draw_bound(value: float, dtype: torch.dtype) -> float:
    """The Python float ``value`` as the JAX package compares it with a
    uniform draw of ``dtype``: rounded to float32 against a float32 draw
    (``as_f32``), unrounded against a float64 one."""
    return as_f32(value) if dtype == torch.float32 else float(value)


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
        if config.fault_inject and train_data is not None:
            # arm the fault plan before any seam can fire; an identical
            # (spec, seed) re-installed keeps its fire counts across an
            # in-process supervised restart (gbdt.py:218-223 of the JAX
            # package, which arms it for predict-only boosters too)
            faults.install_plan(config.fault_inject, config.fault_seed)
        self.models: List[HostTree] = []
        self.iter_ = 0
        # the iterations an init model brought (merge_init_models): a
        # resumed run's budget counts the rest
        self.num_init_iteration = 0
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
        self._stream = None           # a streamed training set's pipeline
        self.obs = TrainingObs.disabled()
        self._modelstats = None
        if train_data is not None:
            self._setup_train(train_data)

    def _setup_train(self, ds: BinnedDataset) -> None:
        cfg = self.config
        check_slice(cfg)
        dev = self.device
        self.num_data = ds.num_data
        hdt = hist_dtype(cfg)
        self._stream, word_packed_cols = self._setup_bins(ds, hdt)
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
                cat_features=categorical_features(ds),
                with_monotone=bool(self.feature_meta.monotone.any())),
            hist_impl=resolve_hist_impl(cfg), hist_dtype=hdt,
            batch_splits=cfg.tree_batch_splits,
            batched_pack=bool(cfg.tpu_batched_pack),
            batched_part=batched_part_on(cfg) and hdt == "f32",
            with_efb=ds.has_bundles or ds.has_packed,
            num_feat_bins=num_feat_bins,
            pack_j=int(pack_partner.max(initial=1)),
            packed_features=tuple(int(i) for i in np.nonzero(pack_mod)[0]),
            cegb_split_penalty=float(cfg.cegb_tradeoff
                                     * cfg.cegb_penalty_split),
            with_cegb_coupled=bool(len(cfg.cegb_penalty_feature_coupled)),
            with_cegb_lazy=bool(len(cfg.cegb_penalty_feature_lazy)),
            word_packed_cols=word_packed_cols)
        # forced splits and CEGB (gbdt.py:522-554 of the JAX package): exact
        # growth only, the CEGB state kept across iterations
        self._forced = self._setup_forced_splits(ds)
        self._cegb = self._setup_cegb(ds)
        if cfg.tree_growth in ("batched", "frontier") and (
                self._forced is not None or self._cegb is not None):
            raise LightGBMError(
                "tree_growth=%s requires exact split ordering; disable "
                "forced splits / CEGB or use tree_growth=exact"
                % cfg.tree_growth)
        # one place decides which grower runs (gbdt.py:1150-1160 of the
        # JAX package)
        self._grow = (grow_tree_batched_part if self.grow_params.batched_part
                      else GROWERS[cfg.tree_growth])
        if cfg.tree_growth in ("batched", "frontier") and hdt == "f64":
            # both wave growers accumulate f32 (gbdt.py:566-570 there)
            Log.warning("tree_growth=%s does not support f64 histograms "
                        "yet; falling back to exact growth" % cfg.tree_growth)
            self._grow = grow_tree
        if self._forced is not None or self._cegb is not None:
            self._grow = functools.partial(grow_tree, forced=self._forced,
                                           cegb=self._cegb)
        if self._stream is not None:
            self._grow = StreamFrontierGrower(self._stream)
        # built once the options are known to train: it may start a server,
        # a thread and the kernels' launch accounting
        self.obs = TrainingObs.from_config(cfg, device=dev)
        # the growers that count waves for the health vector
        self._reports_waves = (self._grow is grow_tree_frontier
                               or self._stream is not None)
        self._health = None     # the last iteration's health vector
        if cfg.obs_modelstats:
            from ..obs.modelstats import ModelStats
            self._modelstats = ModelStats(
                ds.num_total_features, feature_names=ds.feature_names,
                registry=self.obs.registry, events=self.obs.events)
        self._init_scores_provided = ds.metadata.init_score is not None
        self.scores = torch.as_tensor(self._initial_scores(ds), device=dev)
        self.boost_from_average_done = False
        self._rng = np.random.RandomState(cfg.feature_fraction_seed)
        # bagging (gbdt.py:786-807 of the JAX package): the threefry key and
        # the mask it last drew, kept between refreshes; under lambdarank
        # one draw a query (and one for the padding group the JAX package
        # counts in), broadcast to its rows
        # under f64 the JAX package runs with 64-bit types on, so its key
        # takes an int64 seed and its draws are float64 (random.py)
        f64 = self.grow_params.hist_dtype == "f64"
        self._bag_key = threefry.prng_key(cfg.bagging_seed, x64=f64)
        self._draw_dtype = torch.float64 if f64 else torch.float32
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

    def _setup_bins(self, ds: BinnedDataset, hdt: str
                    ) -> Tuple[Optional[ChunkPipeline], int]:
        """The training bins on the device (gbdt.py:385-432, :631-649 and
        :740-751 of the JAX package): returns (the streamed chunks'
        pipeline or None, the code columns of packed words or 0), and sets
        ``self.xb``. A streamed dataset's chunks go through a
        ``ChunkPipeline`` (``self.xb`` None), packed into int32 words where
        ``tpu_bin_packing`` resolves to byte or nibble (streamed ``auto``
        is byte). In memory the frontier grower with float32 histograms
        takes the words where it resolves so (``auto`` is none off a TPU);
        every other grower takes the uint8 matrix."""
        cfg = self.config
        dev = self.device
        streamed = bool(getattr(ds, "is_streamed", False))
        mode = resolve_bin_packing(cfg.tpu_bin_packing, streamed=streamed,
                                   tpu_shaped=False,
                                   col_num_bin=list(ds.col_num_bin))
        if streamed:
            # config.py refuses every other grower, boosting and f64
            check(cfg.tree_growth == "frontier" and hdt == "f32",
                  "streamed training requires tree_growth=frontier with f32 "
                  "histograms")
            # uniform chunks of data_stream_chunk_rows rows, at most the
            # data's (the JAX package pads one chunk to any larger count)
            pipe = ChunkPipeline(
                ds.chunks, min(int(cfg.data_stream_chunk_rows)
                               or max(ds.chunk_row_counts), ds.num_data),
                prefetch=int(cfg.data_stream_prefetch), device=dev,
                packed=mode != "none")
            self.xb = None
            return pipe, (pipe.num_cols if pipe.packed else 0)
        xb = ds.X_binned
        if cfg.tree_growth == "frontier" and hdt == "f32" and mode != "none":
            Log.info("bin packing: %d uint8 columns stored as %d int32 "
                     "words a row on the device (tpu_bin_packing=%s)",
                     xb.shape[1], words_per_row(xb.shape[1]),
                     cfg.tpu_bin_packing)
            self.xb = torch.as_tensor(pack_words_np(xb), device=dev)
            return None, xb.shape[1]
        self.xb = torch.as_tensor(xb, device=dev)              # [N, C]
        return None, 0

    def training_rows(self, what: str) -> torch.Tensor:
        """The training set's stored uint8 [N, C] matrix on the device, to
        replay trees on (``what``: a rollback, a reset, DART's drops):
        packed words are unpacked into a copy; streamed chunks are never
        in one piece, so there it raises."""
        if self._stream is not None:
            raise LightGBMError(
                "%s needs the full binned matrix to replay trees; it is not "
                "supported with streamed training (data_stream_chunk_rows "
                "> 0)" % what)
        packed = self.grow_params.word_packed_cols
        return unpack_words(self.xb, packed) if packed else self.xb

    def _setup_forced_splits(self, ds: BinnedDataset
                             ) -> Optional[ForcedSplits]:
        """forcedsplits_filename's JSON as BFS steps (the ForceSplits queue
        walk, serial_tree_learner.cpp:593-751; gbdt.py:880-926 of the JAX
        package): step t splits a known leaf, since its right child is
        always leaf t + 1. None without a file or with an empty one."""
        import json
        from collections import deque
        cfg = self.config
        if not cfg.forcedsplits_filename:
            return None
        with open(cfg.forcedsplits_filename) as fh:
            root = json.load(fh)
        if not root:
            return None
        inner_of = {real: i for i, real in enumerate(ds.used_features)}
        steps = []
        queue = deque([(root, 0)])
        while queue and len(steps) < cfg.num_leaves - 1:
            node, leaf = queue.popleft()
            real = int(node["feature"])
            check(real in inner_of,
                  "forced split feature %d is trivial/unused" % real)
            mapper = ds.bin_mappers[real]
            check(mapper.bin_type != BinType.CATEGORICAL,
                  "forced splits on categorical features are not supported")
            # rows of bin < ValueToBin(threshold) go left (BinThreshold,
            # dataset.h:507), here bin <= threshold: -1 is an empty left
            # side, and the forced split then aborts on it
            steps.append((leaf, inner_of[real],
                          mapper.value_to_bin(float(node["threshold"])) - 1))
            right_leaf = len(steps)
            if isinstance(node.get("left"), dict):
                queue.append((node["left"], leaf))
            if isinstance(node.get("right"), dict):
                queue.append((node["right"], right_leaf))
        return ForcedSplits(*(tuple(v) for v in zip(*steps)))

    def _setup_cegb(self, ds: BinnedDataset) -> Optional[Cegb]:
        """The CEGB state at the start of training, on the device
        (gbdt.py:988-1016 of the JAX package; SerialTreeLearner's
        feature_used and feature_used_in_data,
        serial_tree_learner.cpp:103-112); None when CEGB is off."""
        cfg = self.config
        coupled = list(cfg.cegb_penalty_feature_coupled)
        lazy = list(cfg.cegb_penalty_feature_lazy)
        if not coupled and not lazy and cfg.cegb_penalty_split <= 0:
            return None
        f = len(ds.used_features)
        coupled_arr = np.zeros(f, np.float32)
        lazy_arr = np.zeros(f, np.float32)
        for i, real in enumerate(ds.used_features):
            if coupled:
                check(real < len(coupled), "cegb_penalty_feature_coupled "
                      "must cover every feature")
                coupled_arr[i] = cfg.cegb_tradeoff * float(coupled[real])
            if lazy:
                check(real < len(lazy), "cegb_penalty_feature_lazy "
                      "must cover every feature")
                lazy_arr[i] = cfg.cegb_tradeoff * float(lazy[real])
        dev = self.device
        return Cegb(CegbState(
            coupled_penalty=torch.as_tensor(coupled_arr, device=dev),
            lazy_penalty=torch.as_tensor(lazy_arr, device=dev),
            feature_used=torch.zeros(f, dtype=torch.bool, device=dev),
            row_used=torch.zeros((f, ds.num_data if lazy else 0),
                                 dtype=torch.uint8, device=dev)))

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
        self.num_init_iteration = self.iter_

    def reset_from(self, old: "GBDT") -> None:
        """Carry ``old``'s model over to this GBDT's training set, binned
        with the same mappers (GBDT::ResetTrainingData, gbdt.cpp:622-660;
        basic.py:744-766 of the JAX package): copies of its trees, its
        iteration count and its init-score offsets; the training scores are
        the new set's init scores plus every tree replayed on its stored
        columns. Each class's first tree has its init score folded in
        (AddBias), so the replay carries it: the JAX package adds the
        offsets to the scores once more, which the port does not copy
        (ROADMAP Queue 3). Everything else starts over, as it does there;
        the scores are replaced, not updated in place, so RF's running
        training sums start over too."""
        self.models = copy.deepcopy(old.models)
        self.iter_ = old.iter_
        self.init_score_offsets = np.array(old.init_score_offsets,
                                           np.float32)
        self.boost_from_average_done = True
        k = self.num_tree_per_iteration
        scores = self.scores.clone()
        xb = self.training_rows("resetting the training data")
        for i, ht in enumerate(self.models):
            scores[:, i % k] += self._tree_output(ht, self._binned_tree(ht),
                                                  xb)
        self.scores = scores

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
        u = threefry.uniform(key, n, self.device, self._draw_dtype)
        if self._row_group is not None:
            u = u[self._row_group]
        self._bag_mask = (u < draw_bound(self.config.bagging_fraction,
                                         u.dtype)).to(torch.float32)

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
        # the train_dispatch seam (gbdt.py:1506, :2184 of the JAX package):
        # before the iteration's work, in memory and streamed
        faults.inject("train_dispatch", iteration=self.iter_)
        sample_mask = self._sample_bagging_mask(self.iter_)
        self._bag_key, goss_key = threefry.split(self._bag_key)
        obs = self.obs
        if not obs.fetches_health:
            return self._train_iteration(grad, hess, sample_mask, goss_key)
        # one iteration observed: its span, one fetch of its health row,
        # its event (gbdt.py:2190-2250 of the JAX package)
        it = self.iter_
        t0 = time.perf_counter()
        obs.perfetto_step(it, it + 1)
        with obs.span("train_iter", iteration=it), \
                obs.iteration_scope("train_iter"):
            stopped = self._train_iteration(grad, hess, sample_mask,
                                            goss_key)
            t_disp = time.perf_counter()
            hrow = self._health.cpu().numpy()[None]     # the one fetch
        t_done = time.perf_counter()
        self._observed(it, 1, hrow, t0, t_disp, t_done, obs.per_iteration)
        return stopped

    def _observed(self, start: int, count: int, rows: np.ndarray,
                  t0: float, t_disp: float, t_done: float,
                  record_hbm: bool) -> None:
        """Account a dispatch of ``count`` iterations from ``start`` whose
        health ``rows`` were fetched between ``t_disp`` and ``t_done``
        (with the device memory where ``record_hbm``), then check them,
        which may raise."""
        obs = self.obs
        if obs.enabled:
            obs.dispatch_done(start, count, t_done - t0, health_rows=rows,
                              busy_s=t_disp - t0, wait_s=t_done - t_disp)
            obs.account_rows(self.num_data * count)
            if record_hbm:
                obs.record_hbm()
        obs.check_health(rows, start, booster=self)

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
        if self.boosting_type not in ("gbdt", "goss") \
                or self._stream is not None or self.obs.per_iteration:
            # streamed growth, too, takes the per-iteration key stream, as
            # the JAX package never fuses it (gbdt.py:1870-1876 there), and
            # so does observability=full, which wants a span, an event and
            # health flags an iteration (:1877 there)
            for _ in range(num_iters):
                if self.train_one_iter():
                    return True
            return False
        done = 0
        while done < num_iters and not self._stopped:
            block = min(num_iters - done, TRAIN_BLOCK)
            keys = threefry.split(self._bag_key, block + 1)
            self._bag_key = keys[0]
            if not self.obs.fetches_health:
                if self._train_block(keys[1:], block, None)[1]:
                    return True
                done += block
                continue
            # a block observed: its health rows in one device buffer,
            # fetched once at its end, then one span, one event
            # (gbdt.py:1905-1960 of the JAX package)
            start = self.iter_
            t0 = time.perf_counter()
            rows = torch.empty((block, 4), dtype=torch.float32,
                               device=self.device)
            with self.obs.span("train_block", start_iter=start,
                               count=block):
                ran, stopped = self._train_block(keys[1:], block, rows)
                t_disp = time.perf_counter()
                hrows = rows[:ran].cpu().numpy()       # the one fetch
            self._observed(start, ran, hrows, t0, t_disp,
                           time.perf_counter(), True)
            if stopped:
                return True
            done += block
        return self._stopped

    def _train_block(self, keys, block: int,
                     rows: Optional[torch.Tensor]):
        """The iterations of one block of ``train_many`` from their
        ``keys``; each one's health vector goes into row i of ``rows``
        where given. Returns (iterations run, whether training
        stopped)."""
        cfg = self.config
        bagging = cfg.bagging_freq > 0 and 0.0 < cfg.bagging_fraction < 1.0
        for i, key in enumerate(keys):
            # the seam fires before each iteration of a block, since the
            # host grows them one at a time here: an iteration trigger
            # inside a block fires where it says (the JAX package's fires
            # once a block, at its start, gbdt.py:1902)
            faults.inject("train_dispatch", iteration=self.iter_,
                          block_len=block)
            bag_key, goss_key = threefry.split(key)
            if bagging and self.iter_ % cfg.bagging_freq == 0:
                self._draw_bag_mask(bag_key)
            stopped = self._train_iteration(None, None, self._bag_mask,
                                            goss_key)
            if rows is not None:
                rows[i] = self._health
            if stopped:
                return i + 1, True
        return len(keys), False

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
        if external and self._stream is not None:
            raise LightGBMError(
                "streamed training does not support externally supplied "
                "gradients; use a built-in objective or unset "
                "data_stream_chunk_rows")
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
        observe = self.obs.fetches_health
        healths = ([GrowerHealth(self.device) for _ in range(k)]
                   if observe and self._reports_waves else None)
        # a streamed iteration's trace: one child a class's tree, one under
        # it a sweep (gbdt.py:1512-1583 of the JAX package)
        tspan = (self.obs.trace_iter(self.iter_) if self._stream is not None
                 else None)
        grown = []
        for c in range(k):
            kw = {} if healths is None else {"health": healths[c]}
            if tspan:
                cspan = tspan.child("tree", cls=c)
                kw["trace_span"] = cspan
            grown.append(self._grow(self.xb, grad[c], hess[c], sample_mask,
                                    self.feature_meta, feature_mask,
                                    self.grow_params, **kw))
            if tspan:
                cspan.end()
        if tspan is not None:
            tspan.finish("ok")
        if self._cegb is not None:
            # every class grew from the iteration's CEGB state; what the
            # class trees bought merges for the next iteration
            self._cegb.merge()
        any_split = any(tree.num_leaves > 1 for tree, _ in grown)
        if observe:
            # the iteration's health row, on the device
            grower_health = None
            if healths is not None:
                # the waves are host counts: fills on the card, no copy
                grower_health = torch.stack([torch.stack((
                    torch.full((), float(h.waves), device=self.device),
                    h.bad_gain)) for h in healths])
            self._health = health_vec(grad, hess, any_split, grower_health)
        if not any_split:
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
        if self._modelstats is not None:
            self._modelstats.ingest_iteration(host_trees,
                                              len(self.models) // k - 1)
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
        xb = self.training_rows("rollback_one_iter")
        k = self.num_tree_per_iteration
        dropped = self.models[-k:]
        del self.models[-k:]
        binned = [self._binned_tree(ht) for ht in dropped]
        self.scores = self.scores - self._iteration_output(dropped, binned,
                                                           xb)
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
                raw_score: bool = False, pred_leaf: bool = False,
                pred_early_stop: bool = False, pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """Batch prediction on raw feature values (GBDT::Predict,
        gbdt_prediction.cpp:49-83; gbdt.py:2523-2582 of the JAX package):
        [N] for one class, [N, K] for K, each class the sum of its trees
        (tree ``i`` is class ``i % K``) over the first ``num_iteration``
        iterations, divided by their number in an averaged (RF) model.

        ``pred_leaf``: [N, T] int32 leaf ids, for K classes class-major
        (class 0's iterations, then class 1's), as the JAX package lays
        them out; no averaging or conversion. ``pred_early_stop``: the
        margin early stop (``predict_forest_early_stop``), off for an
        objective that needs accurate prediction (predictor.hpp:39) and
        under ``pred_leaf``."""
        data = np.asarray(data, np.float64)
        if data.ndim == 1:
            data = data.reshape(1, -1)
        k = self.num_tree_per_iteration
        total = len(self.models) // k
        use = total if num_iteration is None or num_iteration <= 0 \
            else min(num_iteration, total)
        if pred_early_stop and self.objective is not None \
                and self.objective.need_accurate_prediction:
            pred_early_stop = False
        if use == 0:
            out = np.zeros((data.shape[0], k), np.float64)
        else:
            x = torch.as_tensor(data, device=self.device)
            if pred_leaf:
                leaves = [tree_mod.predict_forest_leaves(
                    tree_mod.stack_predict_trees(self.models[c:use * k:k],
                                                 self.device), x)
                    for c in range(k)]
                return torch.cat(leaves, dim=1).cpu().numpy()
            if pred_early_stop:
                out = tree_mod.predict_forest_early_stop(
                    tree_mod.stack_predict_trees(self.models[:use * k],
                                                 self.device), x, k,
                    max(int(pred_early_stop_freq), 1),
                    float(pred_early_stop_margin))
            else:
                out = torch.stack([tree_mod.predict_forest_scores(
                    tree_mod.stack_predict_trees(self.models[c:use * k:k],
                                                 self.device), x)
                    for c in range(k)], dim=1)
            out = out.cpu().numpy().astype(np.float64)
        if self.average_output and use > 0:
            out = out / use
        if k == 1:
            out = out[:, 0]
        if not raw_score and self.objective is not None:
            out = np.asarray(self.objective.convert_output(out))
        return out

    # ------------------------------------------------------------ checkpoint
    @staticmethod
    def _host_copy(t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host for a snapshot: one synchronized
        copy, as the iteration's work that produced it has to finish."""
        return t.detach().cpu().numpy()

    def _device_copy(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.array(a, dtype=dtype), device=self.device)

    def training_state(self):
        """The complete mutable training state as ``(meta, arrays)``, the
        capture point of ``checkpoint`` (gbdt.py:2023-2075 of the JAX
        package, under its key names): ``meta`` holds JSON-safe scalars
        (iteration cursors, RNG cursors, tree shapes, the training data's
        profile), ``arrays`` numpy payloads (the raw HostTree fields, the
        float32 scores, the bagging key and mask, the feature-fraction
        RandomState's keys, each valid set's scores, the CEGB state).
        Restoring them verbatim, instead of replaying the trees, keeps a
        resumed run on the uninterrupted run's scores bit for bit."""
        from ..checkpoint import snapshot as snap_mod
        meta = {
            "boosting_type": self.boosting_type,
            "iteration": int(self.iter_),
            "num_init_iteration": int(self.num_init_iteration),
            "stopped": bool(self._stopped),
            "shrinkage_rate": float(self.shrinkage_rate),
            "boost_from_average_done": bool(self.boost_from_average_done),
        }
        arrays = {
            "scores": self._host_copy(self.scores),
            # the key is two 32-bit words however its seed was taken
            # (random.prng_key, x64 or not): uint32, as the JAX package's
            "bag_key": np.asarray(self._bag_key, np.uint32),
            "bag_mask": self._host_copy(self._bag_mask),
        }
        meta["ff_rng"], arrays["ff_rng_keys"] = snap_mod.rng_state_split(
            self._rng)
        if self.train_data is not None:
            # the serving side scores drift against this profile; a
            # snapshot without one still loads
            try:
                meta["data_profile"] = \
                    self.train_data.data_profile().to_json_dict()
            except Exception as e:  # noqa: BLE001 - the profile is optional
                Log.warning("data profile capture failed (%s); the snapshot "
                            "will carry none", e)
        arrays["init_score_offsets"] = np.asarray(self.init_score_offsets,
                                                  np.float32)
        if self._cegb is not None:
            for j, leaf in enumerate(self._cegb.state):
                arrays["cegb_%d" % j] = self._host_copy(leaf)
        for vi, cache in enumerate(self._valid):
            arrays["valid%d_scores" % vi] = self._host_copy(cache["scores"])
        meta["trees"], tree_arrays = snap_mod.trees_to_arrays(self.models)
        arrays.update(tree_arrays)
        return meta, arrays

    def load_training_state(self, meta, arrays) -> None:
        """The inverse of ``training_state`` on a driver built with the
        same config and data (``checkpoint.snapshot.check_compatibility``):
        every piece goes back as it was saved, each array onto the device
        with one copy. The trees keep their bins (``threshold_bin``,
        ``cat_bitset_bin``), from which ``_binned_tree`` rebuilds their
        replay tables. A valid set the snapshot lacks (added after it) gets
        the trees replayed into its scores, with a warning."""
        from ..checkpoint import snapshot as snap_mod
        self.models = snap_mod.trees_from_arrays(meta["trees"], arrays)
        self.iter_ = int(meta["iteration"])
        self.num_init_iteration = int(meta.get("num_init_iteration", 0))
        self.shrinkage_rate = float(meta["shrinkage_rate"])
        self.boost_from_average_done = bool(meta["boost_from_average_done"])
        self._stopped = bool(meta["stopped"])
        self.scores = self._device_copy(arrays["scores"], np.float32)
        self._bag_key = tuple(int(w) for w in
                              np.asarray(arrays["bag_key"]).reshape(-1))
        self._bag_mask = self._device_copy(arrays["bag_mask"], np.float32)
        self._rng.set_state(snap_mod.rng_state_join(meta["ff_rng"],
                                                    arrays["ff_rng_keys"]))
        if "init_score_offsets" in arrays:
            self.init_score_offsets = np.array(arrays["init_score_offsets"],
                                               np.float32)
        if self._cegb is not None and "cegb_0" in arrays:
            state = self._cegb.state
            self._cegb.state = CegbState(*(
                torch.as_tensor(np.array(arrays["cegb_%d" % j]),
                                dtype=leaf.dtype, device=self.device)
                for j, leaf in enumerate(state)))
            self._cegb.grown = []
        k = self.num_tree_per_iteration
        for vi, cache in enumerate(self._valid):
            key = "valid%d_scores" % vi
            if key in arrays:
                cache["scores"] = self._device_copy(arrays[key], np.float32)
                continue
            Log.warning(
                "checkpoint has no scores for validation set %d (added "
                "after the snapshot was written?); replaying the trees, so "
                "its eval values may differ in the last ulp", vi)
            for i, ht in enumerate(self.models):
                cache["scores"][:, i % k] += self._tree_output(
                    ht, self._binned_tree(ht), cache["xb"])

    @property
    def current_iteration(self) -> int:
        return len(self.models) // self.num_tree_per_iteration

    def enable_health_monitor(self, action: str = "warn") -> None:
        """Arm health monitoring (``callback.health_monitor``): from the
        next iteration on, each builds its health vector on the device and
        the host checks it (gbdt.py:2144-2160 of the JAX package, which
        also rebuilds its compiled step; the port has none to rebuild)."""
        self.obs.arm_health(action)

    def extract_cost_model(self, force: bool = False
                           ) -> Dict[str, Dict[str, float]]:
        """The cost model's entries (``obs/costmodel.py``): per kernel, the
        bytes and additions per launch of every launch accounted under
        ``observability=basic|full``, and per training span, the kernels'
        bytes and additions over its count. They land as
        ``lgbm_costmodel_*`` gauges and feed ``GET /roofline``.

        Pull-based, as the JAX package's (gbdt.py:1776-1800 there):
        nothing in the training loop calls this, and with observability
        off it returns ``{}`` unless ``force=True``."""
        if not (force or self.obs.enabled):
            return {}
        from ..obs.costmodel import (attribute_spans, get_cost_model,
                                     span_wall_times)
        cm = get_cost_model()
        attribute_spans(span_wall_times(self.obs.registry), cm)
        return cm.entries()

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
