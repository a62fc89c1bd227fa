"""Model statistics: split-gain introspection and streaming importance.

The port's own copy of ``lightgbm_tpu/obs/modelstats.py``. The JAX package
feeds ``ModelStats`` from a device accumulator that the frontier grower
carries through its compiled wave loop, and recomputes from the host
trees elsewhere. The port's growers bring every tree to the host in one
transfer, ``split_feature`` and ``split_gain`` included
(``core/grow.py`` ``tree_to_host``), so ``ModelStats`` ingests the host
trees on every grower: no device accumulator, no launch and no sync.

It streams:

- ``lgbm_model_split_count/gain_total/gain_max{feature=}`` gauges,
- ``lgbm_model_leaf_value`` / ``lgbm_model_leaf_depth`` summaries,
- ``lgbm_model_trees`` / ``lgbm_model_gain_mass`` / new-leaf gauges,
- per-iteration ``model_iter`` EventStream records (the learning-curve
  companion to engine.train's ``lgbm_eval_metric`` gauges),

and answers ``importance("split"|"gain")`` with reference-LightGBM
semantics (per ORIGINAL feature index; gains summed over every committed
split), equal to ``GBDT.feature_importance``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .registry import MetricsRegistry, get_registry

def leaf_depths(ht) -> np.ndarray:
    """Per-leaf depths of a HostTree, replayed from the split order.

    Node ``t`` splits leaf ``split_leaf[t]``; the left child keeps the
    parent's leaf index and the right child becomes leaf ``t + 1`` (the
    numbering ``core/tree.py`` ``replay_leaves_binned`` routes by), so one
    pass over the nodes in commit order reconstructs every leaf's final
    depth."""
    nl = int(getattr(ht, "num_leaves_actual", ht.num_leaves))
    depth = np.zeros(max(nl, 1), np.int32)
    for t in range(nl - 1):
        leaf = int(ht.split_leaf[t])
        if leaf < 0:
            continue
        d = depth[leaf] + 1
        depth[leaf] = d
        depth[t + 1] = d
    return depth[:max(nl, 1)]


class ModelStats:
    """Cumulative training-side model statistics over ORIGINAL feature
    indices, which the host trees hold (the JAX package's
    ``inner_to_real`` maps its device accumulator's inner indices; the
    port has no such accumulator)."""

    def __init__(self, num_features: int,
                 feature_names: Optional[List[str]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 events=None):
        self.num_features = int(num_features)
        self.feature_names = (list(feature_names) if feature_names
                              else ["Column_%d" % i
                                    for i in range(self.num_features)])
        self.split_count = np.zeros(self.num_features, np.float64)
        self.gain_total = np.zeros(self.num_features, np.float64)
        self.gain_max = np.zeros(self.num_features, np.float64)
        self.trees = 0
        self.iterations = 0
        self._events = events
        reg = registry if registry is not None else get_registry()
        self._reg = reg
        self._g_trees = reg.gauge(
            "lgbm_model_trees", "Materialized trees in the model so far.")
        self._g_gain_mass = reg.gauge(
            "lgbm_model_gain_mass",
            "Cumulative split gain across all features and trees.")
        self._g_new_leaves = reg.gauge(
            "lgbm_model_new_leaves_last",
            "Leaves grown by the most recent materialized iteration.")
        self._s_leaf_value = reg.summary(
            "lgbm_model_leaf_value",
            "Leaf output values of materialized trees (post-shrinkage).")
        self._s_leaf_depth = reg.summary(
            "lgbm_model_leaf_depth",
            "Leaf depths of materialized trees.")
        self._feat_gauges = {}

    # ------------------------------------------------------------ ingest
    def _ingest_tree_splits(self, ht) -> float:
        """Fold one host tree's committed splits from its arrays
        (``split_feature`` is in ORIGINAL index space); returns their gain
        mass."""
        mass = 0.0
        for i in range(int(getattr(ht, "num_leaves_actual",
                                   ht.num_leaves)) - 1):
            if ht.split_leaf[i] < 0:
                continue
            j = int(ht.split_feature[i])
            g = float(ht.split_gain[i])
            if 0 <= j < self.num_features:
                self.split_count[j] += 1
                self.gain_total[j] += g
                self.gain_max[j] = max(self.gain_max[j], g)
            mass += g
        return mass

    def ingest_iteration(self, host_trees, iteration: int) -> None:
        """One KEPT iteration's class trees, after they joined the model
        (leaf values shrunk and the init score folded in)."""
        new_leaves = 0
        for ht in host_trees:
            self.trees += 1
            nl = int(getattr(ht, "num_leaves_actual", ht.num_leaves))
            new_leaves += nl
            for d in leaf_depths(ht):
                self._s_leaf_depth.observe(float(d))
            for v in np.asarray(ht.leaf_value[:max(nl, 1)], np.float64):
                self._s_leaf_value.observe(float(v))
        gain_mass = sum(self._ingest_tree_splits(ht) for ht in host_trees)
        self.iterations += 1
        self._publish(new_leaves)
        if self._events is not None:
            self._events.write("model_iter", iteration=int(iteration),
                               trees=self.trees,
                               new_leaves=int(new_leaves),
                               gain_iter=round(float(gain_mass), 6),
                               gain_mass=round(float(self.gain_total.sum()),
                                               6))

    # ------------------------------------------------------------ export
    def _gauges_for(self, j: int):
        g = self._feat_gauges.get(j)
        if g is None:
            name = (self.feature_names[j] if j < len(self.feature_names)
                    else "Column_%d" % j)
            lbl = {"feature": name}
            g = (self._reg.gauge("lgbm_model_split_count",
                                 "Committed splits per feature.", lbl),
                 self._reg.gauge("lgbm_model_gain_total",
                                 "Total committed split gain per feature.",
                                 lbl),
                 self._reg.gauge("lgbm_model_gain_max",
                                 "Largest committed split gain per feature.",
                                 lbl))
            self._feat_gauges[j] = g
        return g

    def _publish(self, new_leaves: int) -> None:
        self._g_trees.set(self.trees)
        self._g_gain_mass.set(float(self.gain_total.sum()))
        self._g_new_leaves.set(new_leaves)
        for j in np.nonzero(self.split_count > 0)[0]:
            gc, gt, gm = self._gauges_for(int(j))
            gc.set(float(self.split_count[j]))
            gt.set(float(self.gain_total[j]))
            gm.set(float(self.gain_max[j]))

    def importance(self, importance_type: str = "split") -> np.ndarray:
        """Streaming feature importance over ORIGINAL feature indices, in
        reference semantics (``GBDT.feature_importance`` recomputes the
        same quantity from the trees)."""
        src = (self.split_count if importance_type == "split"
               else self.gain_total)
        return np.array(src, np.float64)
