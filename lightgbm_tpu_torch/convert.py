"""Carry a trained model across from plain numpy arrays.

For a GBDT the weights are the forest and the bin mappers.
``forest_from_numpy`` builds the port's ``HostTree`` list from one dict of
numpy arrays per tree, holding the fields of the JAX package's HostTree
(``split_feature``, ``threshold``, ``threshold_bin``, ``default_left``,
``missing_type``, ``left_child``, ``right_child``, ``leaf_value``,
``internal_value``, ``shrinkage``; ``split_gain``, ``leaf_count``,
``internal_count``, and the categorical ``is_categorical``, ``cat_bitset``
(raw category values, as many 32-bit words as the model needs) and
``cat_bitset_bin`` when present). ``bin_mappers_from_numpy`` does the same
for the BinMapper fields, categorical mappers' ``bin_2_categorical``
included, and ``booster_from_numpy`` puts both behind a predict-only
``Booster``: with ``num_class`` K > 1 its trees are a multiclass forest,
K an iteration (tree ``i`` is class ``i % K``), and it predicts [N, K];
the JAX package's parameters with ``boosting=rf`` make it an RF, which
averages its iterations as that package's RF model does.
Nothing here imports the JAX package: a caller
that holds a JAX-trained model reads its trees into numpy first.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence

import numpy as np

from .basic import Booster
from .boosting.gbdt import HostTree
from .core.tree import split_leaf_of_nodes
from .device import DeviceLike
from .io.binning import BinMapper, BinType

_TREE_FIELDS = ("split_feature", "threshold", "threshold_bin",
                "default_left", "missing_type", "left_child", "right_child",
                "leaf_value", "internal_value")


def forest_from_numpy(trees: Sequence[Mapping[str, Any]]) -> List[HostTree]:
    """One HostTree per dict of numpy arrays (capacity-sized arrays, as the
    JAX package stores them: internal nodes [L-1], leaves [L])."""
    out = []
    for arrays in trees:
        missing = [k for k in _TREE_FIELDS if k not in arrays]
        if missing:
            raise KeyError("tree arrays lack %s" % ", ".join(missing))
        leaf_value = np.asarray(arrays["leaf_value"], np.float64)
        ht = HostTree(len(leaf_value))
        right = np.asarray(arrays["right_child"], np.int32)
        # a used node's right child is never -1: it is node >= 1 or ~leaf
        # with leaf >= 1
        nn = int(np.count_nonzero(right != -1))
        ht.num_leaves_actual = nn + 1
        for name in _TREE_FIELDS + ("split_gain", "leaf_count",
                                    "internal_count", "is_categorical",
                                    "cat_bitset_bin"):
            if name in arrays:
                dst = getattr(ht, name)
                src = np.asarray(arrays[name])
                dst[:len(src)] = src.astype(dst.dtype)
        if "cat_bitset" in arrays:
            # the raw bitset is as wide as the model's largest category
            src = np.asarray(arrays["cat_bitset"], np.uint32)
            ht.cat_bitset = np.zeros((len(ht.is_categorical),
                                      max(8, src.shape[1])), np.uint32)
            ht.cat_bitset[:len(src), :src.shape[1]] = src
        ht.shrinkage = float(arrays.get("shrinkage", 1.0))
        ht.split_leaf[:nn] = split_leaf_of_nodes(ht.left_child, nn)
        out.append(ht)
    return out


def bin_mappers_from_numpy(mappers: Sequence[Mapping[str, Any]]
                           ) -> List[BinMapper]:
    """One BinMapper per dict of its fields (num_bin, missing_type,
    bin_type, is_trivial, sparse_rate, bin_upper_bound, bin_2_categorical,
    min_val, max_val, default_bin)."""
    out = []
    for d in mappers:
        out.append(BinMapper.from_dict({
            "num_bin": int(d["num_bin"]),
            "missing_type": int(d["missing_type"]),
            "bin_type": int(d["bin_type"]),
            "is_trivial": bool(d["is_trivial"]),
            "sparse_rate": float(d.get("sparse_rate", 0.0)),
            "bin_upper_bound": np.asarray(d["bin_upper_bound"], np.float64),
            "bin_2_categorical": [int(v) for v in
                                  d.get("bin_2_categorical", [])],
            "min_val": float(d["min_val"]),
            "max_val": float(d["max_val"]),
            "default_bin": int(d["default_bin"]),
        }))
    return out


def booster_from_numpy(trees: Sequence[Mapping[str, Any]],
                       mappers: Sequence[Mapping[str, Any]],
                       params: Optional[Mapping[str, Any]] = None,
                       feature_names: Optional[List[str]] = None,
                       device: DeviceLike = None,
                       num_class: int = 1) -> Booster:
    """A predict-only Booster on ``device`` from numpy trees and mappers;
    ``num_class`` > 1 makes it multiclass (objective ``multiclass`` unless
    ``params`` names another); ``params`` with ``boosting=rf`` make it an
    RF, whose predictions average the iterations."""
    params = dict(params) if params else None
    if num_class > 1:
        params = dict(params or {}, num_class=num_class)
        params.setdefault("objective", "multiclass")
    bms = bin_mappers_from_numpy(mappers)
    infos = ["none" if m.is_trivial
             else ":".join(str(c) for c in sorted(m.bin_2_categorical))
             if m.bin_type == BinType.CATEGORICAL
             else "[%r:%r]" % (m.min_val, m.max_val) for m in bms]
    names = feature_names or ["Column_%d" % i for i in range(len(bms))]
    booster = Booster.from_forest(forest_from_numpy(trees), names, infos,
                                  params=params, device=device)
    k = booster.num_model_per_iteration()
    if len(trees) % k:
        raise ValueError("%d trees do not make whole iterations of %d "
                         "classes" % (len(trees), k))
    return booster
