"""Leaf-wise (best-first) tree growth.

The port of ``lightgbm_tpu/core/grow.py`` ``grow_tree`` for one device with
the row partition and without EFB (SerialTreeLearner::Train,
serial_tree_learner.cpp:169-233, and Tree::Split, tree.cpp:49-67 of the
reference). The root histogram comes from ``build_histogram`` over all rows;
every split then runs the fused partition and two-child histogram pass
(``core/partition.py``) and searches both children in one batched call.

The JAX package runs ``num_leaves - 1`` masked steps inside one compiled
loop. PyTorch runs eagerly, so this is a Python loop over splits. Each
split reads four integers back from the device in one transfer, its only
synchronisation: the leaf with the best gain, whether that gain is
positive, and the leaf's row range (to size the gather). The loop stops at
the first split whose gain is not positive, where the JAX loop would run
no-op steps to the end.

Node numbering is the reference's: the split at step ``t`` creates internal
node ``t``; the left child keeps the leaf's index and the right child
becomes leaf ``t + 1``. Child pointers use the ``~leaf`` encoding.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .histogram import build_histogram, stack_vals
from .partition import (init_partition, leaf_id_from_partition,
                        partition_and_hist)
from .split import (BestSplit, FeatureMeta, K_MIN_SCORE, MISSING_NAN,
                    MISSING_ZERO, SplitParams, calculate_leaf_output,
                    find_best_split)


class GrowParams(NamedTuple):
    num_leaves: int
    num_bins: int            # bin axis size B of the histograms
    max_depth: int
    split: SplitParams
    hist_impl: str = "auto"  # core/histogram.py: auto | plain


class TreeArrays(NamedTuple):
    """Fixed-capacity tree on the host, the JAX package's TreeArrays layout
    (tree.h:404-517): internal-node arrays [L-1], leaf arrays [L]."""
    split_feature: np.ndarray    # [L-1] int32 inner feature index
    threshold_bin: np.ndarray    # [L-1] int32
    default_left: np.ndarray     # [L-1] bool
    missing_type: np.ndarray     # [L-1] int32
    left_child: np.ndarray       # [L-1] int32 (~leaf for leaves)
    right_child: np.ndarray      # [L-1] int32
    split_gain: np.ndarray       # [L-1] float32
    internal_value: np.ndarray   # [L-1] float32
    internal_weight: np.ndarray  # [L-1] float32
    internal_count: np.ndarray   # [L-1] float32
    split_leaf: np.ndarray       # [L-1] int32
    leaf_value: np.ndarray       # [L] float32
    leaf_weight: np.ndarray      # [L] float32
    leaf_count: np.ndarray       # [L] float32
    leaf_parent: np.ndarray      # [L] int32
    leaf_depth: np.ndarray       # [L] int32
    num_leaves: int


def _bin_go_left(col: torch.Tensor, threshold, default_left, missing_type,
                 num_bin, default_bin) -> torch.Tensor:
    """Numerical decision in bin space (Tree::NumericalDecisionInner,
    tree.h:212-260): missing rows follow ``default_left``, the others go
    left when their bin is <= threshold."""
    coli = col.to(torch.int64)
    is_missing = torch.where(missing_type == MISSING_NAN,
                             coli == num_bin - 1,
                             (missing_type == MISSING_ZERO)
                             & (coli == default_bin))
    return torch.where(is_missing, default_left, coli <= threshold)


def _set_best(best: BestSplit, slots: torch.Tensor, new: BestSplit) -> None:
    for arr, val in zip(best, new):
        arr[slots] = val


def grow_tree(xb: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              sample_mask: torch.Tensor, meta: FeatureMeta,
              feature_mask: torch.Tensor, params: GrowParams
              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one leaf-wise tree; returns (tree on the host, per-row leaf id
    on the device).

    xb [N, F] uint8 bins; grad, hess, sample_mask [N] float32 on the same
    device; feature_mask [F] bool.
    """
    n = xb.shape[0]
    l = params.num_leaves
    b = params.num_bins
    sp = params.split
    dev = xb.device
    f32 = dict(dtype=torch.float32, device=dev)

    vals = stack_vals(grad, hess, sample_mask)               # [N, 3]
    root = vals.sum(dim=0)                                   # (g, h, count)
    hist_root = build_histogram(xb, grad, hess, sample_mask, b,
                                params.hist_impl)

    # leaf and node values stay on the device; the structure is host ints
    leaf_value = torch.zeros(l, **f32)
    leaf_weight = torch.zeros(l, **f32)
    leaf_count = torch.zeros(l, **f32)
    node_f = {k: torch.zeros(l - 1, **f32)
              for k in ("split_gain", "internal_value", "internal_weight",
                        "internal_count")}
    node_i = {k: torch.zeros(l - 1, dtype=torch.int64, device=dev)
              for k in ("split_feature", "threshold_bin", "missing_type")}
    node_default_left = torch.zeros(l - 1, dtype=torch.bool, device=dev)
    left_child = np.full(l - 1, -1, np.int32)
    right_child = np.full(l - 1, -1, np.int32)
    split_leaf = np.full(l - 1, -1, np.int32)
    leaf_parent = np.full(l, -1, np.int32)
    leaf_depth = np.zeros(l, np.int32)

    leaf_value[0] = calculate_leaf_output(root[0], root[1], sp.lambda_l1,
                                          sp.lambda_l2, sp.max_delta_step)
    leaf_weight[0] = root[1]
    leaf_count[0] = root[2]

    best = find_best_split(hist_root[None], meta, sp, root[0:1], root[1:2],
                           root[2:3], feature_mask)
    best = BestSplit(*[torch.cat([a, torch.full((l - 1,), K_MIN_SCORE, **f32)
                                  if i == 0 else a.new_zeros(l - 1)])
                       for i, a in enumerate(best)])
    part = init_partition(n, l, dev)
    # index tensors of the two children, made without a host-to-device copy
    slot_ids = torch.arange(l, device=dev)

    num_leaves = 1
    for t in range(l - 1):
        # one device-to-host read per split; indexing with a 0-d tensor
        # would read it back on its own, so every lookup is index_select
        leaf_t = torch.argmax(best.gain).view(1)
        leaf, valid, begin, count = torch.cat([
            leaf_t, (best.gain.index_select(0, leaf_t) > 0.0).to(torch.int64),
            part.leaf_begin.index_select(0, leaf_t),
            part.leaf_count.index_select(0, leaf_t)]).tolist()
        if not valid:        # the reference stops on gain <= 0 (:217-219)
            break
        cur = BestSplit(*[a[leaf] for a in best])
        right_leaf = t + 1
        feat = cur.feature.view(1)
        missing_type, num_bin, default_bin = (
            m.index_select(0, feat)[0]
            for m in (meta.missing_type, meta.num_bin, meta.default_bin))

        def go_left_rows(rows):
            col = rows.index_select(1, feat)[:, 0]
            return _bin_go_left(col, cur.threshold, cur.default_left,
                                missing_type, num_bin, default_bin)

        part, hist_left, hist_right = partition_and_hist(
            part, leaf, right_leaf, begin, count, xb, vals, go_left_rows, b,
            params.hist_impl)

        # ---- tree bookkeeping (Tree::Split, tree.cpp:49-67) -------------
        node = t
        parent = leaf_parent[leaf]
        if parent >= 0:
            if left_child[parent] == ~leaf:
                left_child[parent] = node
            else:
                right_child[parent] = node
        left_child[node] = ~leaf
        right_child[node] = ~right_leaf
        split_leaf[node] = leaf
        depth = leaf_depth[leaf] + 1
        leaf_parent[[leaf, right_leaf]] = node
        leaf_depth[[leaf, right_leaf]] = depth
        num_leaves += 1

        node_i["split_feature"][node] = cur.feature
        node_i["threshold_bin"][node] = cur.threshold
        node_i["missing_type"][node] = missing_type
        node_default_left[node] = cur.default_left
        node_f["split_gain"][node] = cur.gain
        node_f["internal_value"][node] = calculate_leaf_output(
            cur.left_sum_grad + cur.right_sum_grad,
            cur.left_sum_hess + cur.right_sum_hess,
            sp.lambda_l1, sp.lambda_l2, sp.max_delta_step)
        node_f["internal_weight"][node] = (cur.left_sum_hess
                                           + cur.right_sum_hess)
        node_f["internal_count"][node] = cur.left_count + cur.right_count
        children = torch.stack((slot_ids[leaf], slot_ids[right_leaf]))
        leaf_value[children] = torch.stack([cur.left_output,
                                            cur.right_output])
        leaf_weight[children] = torch.stack([cur.left_sum_hess,
                                             cur.right_sum_hess])
        leaf_count[children] = torch.stack([cur.left_count,
                                            cur.right_count])

        # ---- best splits of both children, one batched search -----------
        b2 = find_best_split(
            torch.stack([hist_left, hist_right]), meta, sp,
            torch.stack([cur.left_sum_grad, cur.right_sum_grad]),
            torch.stack([cur.left_sum_hess, cur.right_sum_hess]),
            torch.stack([cur.left_count, cur.right_count]), feature_mask)
        if 0 < params.max_depth <= depth:
            b2 = b2._replace(gain=torch.full_like(b2.gain, K_MIN_SCORE))
        _set_best(best, children, b2)

    leaf_id = leaf_id_from_partition(part, n, l)
    host = {k: v.cpu().numpy() for k, v in
            dict(leaf_value=leaf_value, leaf_weight=leaf_weight,
                 leaf_count=leaf_count, default_left=node_default_left,
                 **node_f, **node_i).items()}
    tree = TreeArrays(
        split_feature=host["split_feature"].astype(np.int32),
        threshold_bin=host["threshold_bin"].astype(np.int32),
        default_left=host["default_left"],
        missing_type=host["missing_type"].astype(np.int32),
        left_child=left_child, right_child=right_child,
        split_gain=host["split_gain"],
        internal_value=host["internal_value"],
        internal_weight=host["internal_weight"],
        internal_count=host["internal_count"],
        split_leaf=split_leaf,
        leaf_value=host["leaf_value"], leaf_weight=host["leaf_weight"],
        leaf_count=host["leaf_count"], leaf_parent=leaf_parent,
        leaf_depth=leaf_depth, num_leaves=num_leaves)
    return tree, leaf_id
