"""Serving's flat-forest traversal: O(depth) steps, all trees at once.

The port of ``lightgbm_tpu/serving/traversal.py``. ``predict``'s replay
(``core/tree.py``) moves rows through a tree by replaying its
``num_leaves - 1`` splits in creation order, one tree after another.
Here the whole ensemble is packed once per model generation into one
structure-of-arrays node table (``FlatForest``: ``[T, max_nodes]`` split
feature, threshold, default-left, missing type and child pointers, plus a
``[T, max_leaves]`` leaf table, ``T`` = iterations x classes), and all
rows x all trees advance one level a step: each of the ``depth`` steps
gathers the current node's fields for every (row, tree) pair, makes the
split decision (``core/tree.py`` ``decision_go_left`` and
``categorical_words_go_left``, the routing of ``predict``) and follows a
child pointer. Leaves are encoded ``~leaf_index`` in the child arrays, so
landing on a leaf freezes the row: ``depth`` steps suffice for every row,
and the loop bound is a property of the packed model.

Unlike the JAX package, which casts requests and thresholds to float32
(``serving/traversal.py:104``), the port keeps both in float64, as its
``predict`` compares them (LightGBM's ``Tree::NumericalDecision``): the
served scores are ``predict``'s bit for bit. ``_sum_iterations`` adds one
iteration's [N, K] leaf values a step, in iteration order and in float32,
the order of ``predict_forest_scores`` (a class's trees added one by one
to a zero start).

Early-exit cascade (``cascade_trees=k``, ``cascade_margin=m``): score the
first ``k`` iterations for every row, then continue through the remaining
trees only where a row's margin (binary: ``2|score|``; multiclass: top-1
minus top-2) is below ``m``; confident rows keep their stage-1 score.
``cascade_stage1`` and ``cascade_stage2`` are the two halves, so that a
caller can run the second only when some row is uncertain
(``forest_scores_flat`` reads ``any(uncertain)`` once on the host, as the
JAX package's ``lax.cond`` decides on the device). ``m = inf`` keeps every
row uncertain and gives the full model's scores.

Optionally the leaf table is int16 with a per-tree float32 scale
(``quantize``), ~1e-4 relative off the full scores; off by default.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.tree import categorical_words_go_left, decision_go_left
from ..log import check


class FlatForest(NamedTuple):
    """Whole-ensemble node table; every field's leading axis is the tree
    index ``T = iterations * num_tree_per_iteration`` (iteration-major).
    ``pack_flat_forest`` builds it in numpy, ``to_device`` moves it."""
    feature: np.ndarray         # [T, Nn] int32 split feature per node
    threshold: np.ndarray       # [T, Nn] float64 real-value threshold
    default_left: np.ndarray    # [T, Nn] bool
    missing_type: np.ndarray    # [T, Nn] int32
    is_categorical: np.ndarray  # [T, Nn] bool
    cat_bitset: np.ndarray      # [T, Nn, W] uint32 raw-category bitsets
    left: np.ndarray            # [T, Nn] int32 child; >=0 node, <0 = ~leaf
    right: np.ndarray           # [T, Nn] int32 child; >=0 node, <0 = ~leaf
    leaf_value: np.ndarray      # [T, L] float32 (int16 when quantized)
    leaf_scale: np.ndarray      # [T] float32 dequant scale (ones unless quantized)


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Traversal steps needed for one tree: the max count of internal
    nodes on any root-to-leaf path (>= 1; a stump still takes one step to
    follow ``~0`` to leaf 0). Iterative: trees can be chain-shaped."""
    # only a truly empty tree short-circuits. A root whose LEFT child is a
    # leaf is NOT a stump: its right subtree can be arbitrarily deep
    # (sparse-trained chain trees look exactly like this), and
    # under-counting depth freezes traversal mid-tree.
    if len(left) == 0:
        return 1
    depth = 1
    stack: List[Tuple[int, int]] = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        for child in (int(left[node]), int(right[node])):
            if child >= 0:
                stack.append((child, d + 1))
    return depth


def pack_flat_forest(models, quantize: bool = False
                     ) -> Tuple[FlatForest, int]:
    """Pack host trees (``boosting.gbdt.HostTree`` or
    ``io.model_text.LoadedTree``, iteration-major) into one numpy
    ``FlatForest`` plus the traversal depth. Runs once per model
    generation on the host; ``to_device`` moves the result."""
    check(len(models) > 0, "cannot pack an empty model")
    max_nodes = max(max(len(t.left_child), 1) for t in models)
    max_leaves = max(t.num_leaves for t in models)
    cat_words = max(t.cat_bitset.shape[1] for t in models)
    tcount = len(models)

    feature = np.zeros((tcount, max_nodes), np.int32)
    threshold = np.zeros((tcount, max_nodes), np.float64)
    default_left = np.zeros((tcount, max_nodes), bool)
    missing_type = np.zeros((tcount, max_nodes), np.int32)
    is_categorical = np.zeros((tcount, max_nodes), bool)
    cat_bitset = np.zeros((tcount, max_nodes, cat_words), np.uint32)
    # padding children point at leaf 0 (~0 == -1): a row that somehow
    # lands on a padded node freezes on a real leaf instead of escaping
    left = np.full((tcount, max_nodes), -1, np.int32)
    right = np.full((tcount, max_nodes), -1, np.int32)
    leaf_f32 = np.zeros((tcount, max_leaves), np.float32)
    depth = 1
    for ti, ht in enumerate(models):
        nn = len(ht.left_child)
        feature[ti, :nn] = ht.split_feature
        threshold[ti, :nn] = ht.threshold
        default_left[ti, :nn] = ht.default_left
        missing_type[ti, :nn] = ht.missing_type
        is_categorical[ti, :nn] = ht.is_categorical
        bw = ht.cat_bitset.shape[1]
        cat_bitset[ti, :len(ht.cat_bitset), :bw] = ht.cat_bitset
        left[ti, :nn] = ht.left_child
        right[ti, :nn] = ht.right_child
        nl = len(ht.leaf_value)
        leaf_f32[ti, :nl] = ht.leaf_value.astype(np.float32)
        depth = max(depth, _tree_depth(ht.left_child, ht.right_child))

    if quantize:
        scale = np.maximum(np.abs(leaf_f32).max(axis=1), 1e-30) / 32767.0
        leaf = np.round(leaf_f32 / scale[:, None]).astype(np.int16)
        leaf_scale = scale.astype(np.float32)
    else:
        leaf = leaf_f32
        leaf_scale = np.ones((tcount,), np.float32)

    return FlatForest(feature=feature, threshold=threshold,
                      default_left=default_left, missing_type=missing_type,
                      is_categorical=is_categorical, cat_bitset=cat_bitset,
                      left=left, right=right, leaf_value=leaf,
                      leaf_scale=leaf_scale), depth


def to_device(forest: FlatForest, device: torch.device) -> FlatForest:
    """The packed forest as tensors on ``device``: indices as int64 (what
    torch gathers with), bitset words as int32 bit patterns. A forest with
    no categorical node keeps a bitset of 0 words, and the traversal then
    makes the numerical decision alone."""
    words = forest.cat_bitset if forest.is_categorical.any() \
        else forest.cat_bitset[..., :0]

    def idx(a):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return FlatForest(
        feature=idx(forest.feature),
        threshold=torch.as_tensor(forest.threshold, device=device),
        default_left=torch.as_tensor(forest.default_left, device=device),
        missing_type=idx(forest.missing_type),
        is_categorical=torch.as_tensor(forest.is_categorical, device=device),
        cat_bitset=torch.as_tensor(
            np.ascontiguousarray(words).view(np.int32), device=device),
        left=idx(forest.left), right=idx(forest.right),
        leaf_value=torch.as_tensor(forest.leaf_value, device=device),
        leaf_scale=torch.as_tensor(forest.leaf_scale, device=device))


def slice_trees(forest: FlatForest, lo: int, hi: int) -> FlatForest:
    """Trees ``lo..hi`` of a packed forest (views, no copy)."""
    return FlatForest(*(a[lo:hi] for a in forest))


def _terminal_nodes(forest: FlatForest, x: torch.Tensor,
                    depth: int) -> torch.Tensor:
    """[N, T] terminal encoded nodes (``~leaf_index``, all negative after
    ``depth`` steps): all rows x all trees, breadth-first gather + decide
    + follow-child. ``x`` is [N, F] float64."""
    n = x.shape[0]
    tcount, nodes = forest.left.shape
    words = forest.cat_bitset.shape[-1]
    base = (torch.arange(tcount, device=x.device) * nodes)[None, :]
    feature = forest.feature.reshape(-1)
    threshold = forest.threshold.reshape(-1)
    default_left = forest.default_left.reshape(-1)
    missing_type = forest.missing_type.reshape(-1)
    is_categorical = forest.is_categorical.reshape(-1)
    bitset = forest.cat_bitset.reshape(-1)
    left = forest.left.reshape(-1)
    right = forest.right.reshape(-1)
    node = torch.zeros((n, tcount), dtype=torch.int64, device=x.device)
    for _ in range(depth):
        at = base + node.clamp(min=0)                         # [N, T]
        fval = x.gather(1, feature[at])                       # [N, T]
        go_left = decision_go_left(fval, threshold[at], default_left[at],
                                   missing_type[at])
        if words:
            go_left = torch.where(
                is_categorical[at],
                categorical_words_go_left(
                    fval, words, lambda wi: bitset[at * words + wi]),
                go_left)
        nxt = torch.where(go_left, left[at], right[at])
        node = torch.where(node >= 0, nxt, node)
    return node


def forest_leaf_ids(forest: FlatForest, x: torch.Tensor,
                    depth: int) -> torch.Tensor:
    """[N, T] leaf index each row lands on in each tree: the routing half
    of the traversal without the leaf-table gather."""
    return ~_terminal_nodes(forest, x, depth)


def _leaf_values(forest: FlatForest, x: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """[N, T] float32 per-tree leaf values of every row."""
    tcount, leaves = forest.leaf_value.shape
    base = (torch.arange(tcount, device=x.device) * leaves)[None, :]
    vals = forest.leaf_value.reshape(-1)[
        base + forest_leaf_ids(forest, x, depth)]
    if forest.leaf_value.dtype != torch.float32:             # quantized table
        vals = vals.to(torch.float32) * forest.leaf_scale[None, :]
    return vals


def _sum_iterations(acc: torch.Tensor, vals: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Add [N, T'] per-tree values into [N, K] scores one iteration at a
    time: each class's float32 sum in the order ``predict_forest_scores``
    adds its trees, so the result is ``predict``'s bit for bit."""
    per_iter = vals.reshape(vals.shape[0], vals.shape[1] // k, k)
    for i in range(per_iter.shape[1]):
        acc = acc + per_iter[:, i]
    return acc


def forest_scores(forest: FlatForest, x: torch.Tensor, k: int,
                  depth: int) -> torch.Tensor:
    """[N, K] float32 raw scores of every row over every tree."""
    acc = torch.zeros((x.shape[0], k), dtype=torch.float32, device=x.device)
    return _sum_iterations(acc, _leaf_values(forest, x, depth), k)


def cascade_split(forest: FlatForest, k: int, cascade_trees: int) -> int:
    """Trees in the cascade's first stage: ``cascade_trees`` iterations,
    or 0 when the cascade is off or covers the whole forest."""
    tcount = forest.left.shape[0]
    ck = min(max(int(cascade_trees), 0), tcount // k) * k
    return 0 if ck >= tcount else ck


def cascade_stage1(forest: FlatForest, x: torch.Tensor, k: int, depth: int,
                   ck: int, cascade_margin: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of the cascade: ([N, K] scores over the first ``ck``
    trees, [N] whether each row's margin is below ``cascade_margin``)."""
    acc = forest_scores(slice_trees(forest, 0, ck), x, k, depth)
    if k > 1:
        top2 = torch.topk(acc, 2, dim=1).values
        margin = top2[:, 0] - top2[:, 1]
    else:
        margin = 2.0 * torch.abs(acc[:, 0])
    # the margin as float32, compared as a scalar: no host-to-device copy,
    # so the stage can be captured in a CUDA graph
    uncertain = margin < float(np.float32(cascade_margin))
    return acc, uncertain


def cascade_stage2(forest: FlatForest, x: torch.Tensor, k: int, depth: int,
                   ck: int, acc: torch.Tensor,
                   uncertain: torch.Tensor) -> torch.Tensor:
    """Stage 2: the remaining trees added to the uncertain rows' stage-1
    scores; confident rows keep theirs."""
    vals = _leaf_values(slice_trees(forest, ck, forest.left.shape[0]), x,
                        depth)
    full = _sum_iterations(acc, vals, k)
    return torch.where(uncertain[:, None], full, acc)


def forest_scores_flat(forest: FlatForest, x: torch.Tensor, k: int,
                       depth: int, cascade_trees: int = 0,
                       cascade_margin: float = 10.0) -> torch.Tensor:
    """[N, K] float32 raw ensemble scores from a packed forest on ``x``'s
    device (``x`` [N, F] float64). ``k`` is trees per iteration, ``depth``
    the bound from ``pack_flat_forest``; ``cascade_trees > 0`` runs the
    two-stage cascade, the second stage only when some row is uncertain
    (one host read)."""
    ck = cascade_split(forest, k, cascade_trees)
    if ck == 0:
        return forest_scores(forest, x, k, depth)
    acc, uncertain = cascade_stage1(forest, x, k, depth, ck, cascade_margin)
    if not bool(uncertain.any()):
        return acc
    return cascade_stage2(forest, x, k, depth, ck, acc, uncertain)
