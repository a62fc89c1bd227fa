"""Leaf-wise (best-first) tree growth.

The port of ``lightgbm_tpu/core/grow.py`` ``grow_tree`` for one device with
the row partition and without EFB (SerialTreeLearner::Train,
serial_tree_learner.cpp:169-233, and Tree::Split, tree.cpp:49-67 of the
reference). The root (``root_split``, shared with the wave growers) takes
one histogram over all rows; every split then runs the fused partition
and two-child histogram pass (``core/partition.py``) and searches both
children in one batched call.

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

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .histogram import hist_tile_vals, stack_vals
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
    # tree_growth=batched (core/grow_batched.py): split up to this many of
    # the highest-gain leaves per step
    batch_splits: int = 16
    # tpu_batched_pack: the batched step runs the slot kernel over child
    # slots instead of the parent-slot pass
    batched_pack: bool = False


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


class DeviceTree(NamedTuple):
    """The TreeArrays fields as tensors on the device, for the wave growers
    that commit many splits per step without reading back: internal-node
    fields [L-1], leaf fields [L]. Integer fields are int64. The leaf count
    is kept by the host."""
    split_feature: torch.Tensor
    threshold_bin: torch.Tensor
    default_left: torch.Tensor
    missing_type: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    split_gain: torch.Tensor
    internal_value: torch.Tensor
    internal_weight: torch.Tensor
    internal_count: torch.Tensor
    split_leaf: torch.Tensor
    leaf_value: torch.Tensor
    leaf_weight: torch.Tensor
    leaf_count: torch.Tensor
    leaf_parent: torch.Tensor
    leaf_depth: torch.Tensor


def empty_tree(num_leaves: int, device: torch.device) -> DeviceTree:
    """A tree with one leaf and no nodes (``lightgbm_tpu/core/grow.py``
    ``empty_tree``): children and split leaves -1, everything else 0."""
    l = num_leaves
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return DeviceTree(
        split_feature=torch.zeros(l - 1, **i64),
        threshold_bin=torch.zeros(l - 1, **i64),
        default_left=torch.zeros(l - 1, dtype=torch.bool, device=device),
        missing_type=torch.zeros(l - 1, **i64),
        left_child=torch.full((l - 1,), -1, **i64),
        right_child=torch.full((l - 1,), -1, **i64),
        split_gain=torch.zeros(l - 1, **f32),
        internal_value=torch.zeros(l - 1, **f32),
        internal_weight=torch.zeros(l - 1, **f32),
        internal_count=torch.zeros(l - 1, **f32),
        split_leaf=torch.full((l - 1,), -1, **i64),
        leaf_value=torch.zeros(l, **f32),
        leaf_weight=torch.zeros(l, **f32),
        leaf_count=torch.zeros(l, **f32),
        leaf_parent=torch.full((l,), -1, **i64),
        leaf_depth=torch.zeros(l, **i64))


def _empty_best(num_leaves: int, device: torch.device) -> BestSplit:
    """The per-leaf best-split table: gain -inf (no split) everywhere."""
    z = torch.zeros(num_leaves, dtype=torch.float32, device=device)
    zi = torch.zeros(num_leaves, dtype=torch.int64, device=device)
    return BestSplit(
        gain=torch.full_like(z, K_MIN_SCORE), feature=zi, threshold=zi.clone(),
        default_left=torch.zeros_like(zi, dtype=torch.bool),
        **{k: z.clone() for k in BestSplit._fields[4:]})


def propagate_monotone_bounds(mono, left_output, right_output, p_min, p_max):
    """Monotone constraint propagation (serial_tree_learner.cpp:790-847):
    children inherit the parent's output bounds; a monotone split feature
    pins the shared boundary at the midpoint of the two child outputs.
    Returns (l_min, l_max, r_min, r_max)."""
    mid = (left_output + right_output) * 0.5
    l_min = torch.where(mono < 0, torch.maximum(p_min, mid), p_min)
    l_max = torch.where(mono > 0, torch.minimum(p_max, mid), p_max)
    r_min = torch.where(mono > 0, torch.maximum(p_min, mid), p_min)
    r_max = torch.where(mono < 0, torch.minimum(p_max, mid), p_max)
    return l_min, l_max, r_min, r_max


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy device tensors to the host in one transfer: packed into one
    float64 tensor (exact for float32 values and for integers below 2^53),
    then split and cast back to each tensor's dtype."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[at:at + n].astype(dtype).reshape(tuple(t.shape)))
        at += n
    return out


def tree_to_host(tree: DeviceTree, num_leaves: int) -> TreeArrays:
    """A finished device tree as host TreeArrays, in one transfer."""
    host = dict(zip(DeviceTree._fields, to_host(list(tree))))
    int32 = ("split_feature", "threshold_bin", "missing_type", "left_child",
             "right_child", "split_leaf", "leaf_parent", "leaf_depth")
    for k in int32:
        host[k] = host[k].astype(np.int32)
    return TreeArrays(num_leaves=num_leaves, **host)


def root_split(xb: torch.Tensor, vals: torch.Tensor, meta: FeatureMeta,
               feature_mask: torch.Tensor, params: GrowParams):
    """The root of a wave-grown tree, as in exact growth: returns the
    empty device tree with leaf 0 set, the best-split table with the
    root's best split, and the root histogram [F, B, 3]."""
    l = params.num_leaves
    sp = params.split
    dev = xb.device
    root = vals.sum(dim=0)                                   # (g, h, count)
    hist_root = hist_tile_vals(xb, vals, params.num_bins, params.hist_impl)
    tree = empty_tree(l, dev)
    tree.leaf_value[0] = calculate_leaf_output(root[0], root[1], sp.lambda_l1,
                                               sp.lambda_l2, sp.max_delta_step)
    tree.leaf_weight[0] = root[1]
    tree.leaf_count[0] = root[2]
    best = _empty_best(l, dev)
    b0 = find_best_split(hist_root[None], meta, sp, root[0:1], root[1:2],
                         root[2:3], feature_mask)
    _set_best(best, slice(0, 1), b0)
    return tree, best, hist_root


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

    vals = stack_vals(grad, hess, sample_mask)               # [N, 3]
    # split values stay on the device; the structure is host ints, which
    # replace the device tree's structure fields when the tree is done
    tree, best, _ = root_split(xb, vals, meta, feature_mask, params)
    left_child = np.full(l - 1, -1, np.int32)
    right_child = np.full(l - 1, -1, np.int32)
    split_leaf = np.full(l - 1, -1, np.int32)
    leaf_parent = np.full(l, -1, np.int32)
    leaf_depth = np.zeros(l, np.int32)
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

        tree.split_feature[node] = cur.feature
        tree.threshold_bin[node] = cur.threshold
        tree.missing_type[node] = missing_type
        tree.default_left[node] = cur.default_left
        tree.split_gain[node] = cur.gain
        tree.internal_value[node] = calculate_leaf_output(
            cur.left_sum_grad + cur.right_sum_grad,
            cur.left_sum_hess + cur.right_sum_hess,
            sp.lambda_l1, sp.lambda_l2, sp.max_delta_step)
        tree.internal_weight[node] = cur.left_sum_hess + cur.right_sum_hess
        tree.internal_count[node] = cur.left_count + cur.right_count
        children = torch.stack((slot_ids[leaf], slot_ids[right_leaf]))
        tree.leaf_value[children] = torch.stack([cur.left_output,
                                                 cur.right_output])
        tree.leaf_weight[children] = torch.stack([cur.left_sum_hess,
                                                  cur.right_sum_hess])
        tree.leaf_count[children] = torch.stack([cur.left_count,
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
    return tree_to_host(tree, num_leaves)._replace(
        left_child=left_child, right_child=right_child,
        split_leaf=split_leaf, leaf_parent=leaf_parent,
        leaf_depth=leaf_depth), leaf_id
