"""Tree prediction on raw feature values.

The port of ``lightgbm_tpu/core/tree.py`` (Tree::Predict / GetLeaf,
tree.h:203-260 and gbdt_prediction.cpp:9-83 of the reference). Prediction
replays the splits in creation order: node ``t`` split leaf
``split_leaf[t]``, so visiting nodes 0..L-2 in turn moves every row through
exactly the decisions a traversal would make, each step one vectorized
compare over all rows. Feature values and thresholds are compared in
float64, as Tree::NumericalDecision compares them, so every row goes where
the binning of training sent it (the binned replay's leaf). The JAX
package compares in float32; a value within a float32 rounding of a
threshold can go the other way there (8 of 125,000 valid rows in 25 trees
of chip_smoke.py's path 4r, whose data are float32, because a threshold's
nearest float32 lay above it). A categorical node holds a bitset of raw
category values
as wide as the model's largest category needs (Tree cat_threshold_,
tree.h:276-291), stored as int32 words on the device: a 60,000-id column
takes ~1,875 words a node.

``predict_forest_leaves`` gives each row's leaf in every tree
(``pred_leaf``) and ``predict_forest_early_stop`` the scores under the
prediction early stop, from the same decisions.

``replay_leaves_binned`` finds the leaf of every row of a binned matrix
instead (the JAX package's ``_replay_leaves_binned_impl``,
boosting/gbdt.py:2416-2468, for numerical splits): it walks the tree from
the root, one gather, decode and compare per depth level, and serves the
valid-set scores, rollback and continued training. Each node reads its
split feature's stored column and decodes the byte into the feature's
bin (``decode_bundle_value``: identity for a column of its own); a
categorical node tests the bin against its bin-space bitset.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .grow import _bin_go_left, decode_bundle_value
from .split import CAT_WORDS, MISSING_NAN, MISSING_ZERO

K_ZERO_THRESHOLD = 1e-35


class PredictTree(NamedTuple):
    """Per-tree arrays of replay prediction, stacked over trees [T, ...]."""
    split_leaf: torch.Tensor     # [T, L-1] int64; -1 = unused node
    split_feature: torch.Tensor  # [T, L-1] int64 real feature index
    threshold: torch.Tensor      # [T, L-1] float64 real threshold
    default_left: torch.Tensor   # [T, L-1] bool
    missing_type: torch.Tensor   # [T, L-1] int64
    cat_bitset: torch.Tensor     # [T, L-1, W] int32 raw-category words
    leaf_value: torch.Tensor     # [T, L] float32
    is_categorical: np.ndarray   # [T, L-1] bool, on the host: which nodes
    #                              take the categorical decision


def stack_predict_trees(trees: Sequence, device: torch.device) -> PredictTree:
    """Pad host trees (HostTree or LoadedTree layout) to common shapes and
    stack them on ``device``; every bitset is widened to the forest's
    widest, as ``pack_predict_table`` does (JAX core/tree.py:43-70)."""
    max_nodes = max(max(t.num_leaves - 1, 1) for t in trees)
    max_leaves = max(t.num_leaves for t in trees)
    words = max(t.cat_bitset.shape[1] for t in trees)
    bitsets = np.zeros((len(trees), max_nodes, words), np.uint32)
    for i, t in enumerate(trees):
        bitsets[i, :len(t.cat_bitset), :t.cat_bitset.shape[1]] = t.cat_bitset
    is_cat = np.zeros((len(trees), max_nodes), bool)
    for i, t in enumerate(trees):
        nn = max(int(t.num_leaves_actual) - 1, 0)
        is_cat[i, :nn] = t.is_categorical[:nn]

    def stack(get, n, fill, dtype):
        out = np.full((len(trees), n), fill, dtype)
        for i, t in enumerate(trees):
            a = np.asarray(get(t))
            out[i, :len(a)] = a
        return torch.as_tensor(out, device=device)

    return PredictTree(
        split_leaf=stack(lambda t: t.split_leaf, max_nodes, -1, np.int64),
        split_feature=stack(lambda t: t.split_feature, max_nodes, 0,
                            np.int64),
        threshold=stack(lambda t: t.threshold, max_nodes, 0.0, np.float64),
        default_left=stack(lambda t: t.default_left, max_nodes, False, bool),
        missing_type=stack(lambda t: t.missing_type, max_nodes, 0, np.int64),
        cat_bitset=torch.as_tensor(bitsets.view(np.int32), device=device),
        leaf_value=stack(lambda t: t.leaf_value.astype(np.float32),
                         max_leaves, 0.0, np.float32),
        is_categorical=is_cat)


def split_leaf_of_nodes(left_child: np.ndarray, num_nodes: int
                        ) -> np.ndarray:
    """The leaf each node split, for replay prediction: the end of the
    node's left-child spine (Tree::Split keeps the split leaf's index on the
    left child, tree.cpp:49-67)."""
    out = np.full(num_nodes, -1, np.int32)
    for t in range(num_nodes):
        node = t
        while left_child[node] >= 0:
            node = left_child[node]
        out[t] = ~left_child[node]
    return out


def decision_go_left(fval: torch.Tensor, threshold, default_left,
                     missing_type) -> torch.Tensor:
    """Tree::NumericalDecision on raw values (tree.h:212-243): NaN is
    missing under MissingType::NaN; under MissingType::Zero both zero and
    NaN are missing; otherwise NaN is treated as 0."""
    is_nan = torch.isnan(fval)
    fval_safe = torch.where(is_nan, torch.zeros_like(fval), fval)
    is_zero = torch.abs(fval_safe) <= K_ZERO_THRESHOLD
    use_default = torch.where(missing_type == MISSING_NAN, is_nan,
                              (missing_type == MISSING_ZERO)
                              & (is_zero | is_nan))
    return torch.where(use_default, default_left, fval_safe <= threshold)


def categorical_go_left(fval: torch.Tensor,
                        cat_bitset: torch.Tensor) -> torch.Tensor:
    """Tree::CategoricalDecision on raw values (tree.h:245-260): a row goes
    left when its category's bit is set in the node's [W] bitset."""
    return categorical_words_go_left(
        fval, cat_bitset.shape[0], lambda wi: cat_bitset.index_select(0, wi))


def categorical_words_go_left(fval: torch.Tensor, num_words: int,
                              word_of) -> torch.Tensor:
    """``categorical_go_left`` with the bitset read through ``word_of``:
    given the word index of each element of ``fval``, it returns that
    element's bitset word (the serving traversal reads each (row, tree)
    pair's node this way). The value is truncated toward zero; NaN,
    negative values and values past the bitset's ``32 * num_words`` go
    right (the JAX package's ``cat_ok``)."""
    max_cat = num_words * 32
    is_nan = torch.isnan(fval)
    cat_i = torch.clamp(torch.where(is_nan, torch.zeros_like(fval), fval),
                        0, max_cat - 1).to(torch.int64)
    word = word_of(cat_i >> 5)
    cat_ok = ~is_nan & (fval >= 0) & (fval < max_cat)
    return cat_ok & (((word >> (cat_i & 31)) & 1) == 1)


def tree_leaves(trees: PredictTree, i: int, x: torch.Tensor
                ) -> torch.Tensor:
    """[N] int64 leaf of every row of x [N, F] float64 in tree ``i``
    (Tree::GetLeaf): the splits replayed in creation order."""
    leaf_id = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for t in range(trees.split_leaf.shape[1]):
        fval = x.index_select(1, trees.split_feature[i, t].view(1))[:, 0]
        if trees.is_categorical[i, t]:
            go_left = categorical_go_left(fval, trees.cat_bitset[i, t])
        else:
            go_left = decision_go_left(fval, trees.threshold[i, t],
                                       trees.default_left[i, t],
                                       trees.missing_type[i, t])
        move = ((leaf_id == trees.split_leaf[i, t]) & ~go_left
                & (trees.split_leaf[i, t] >= 0))
        leaf_id = torch.where(move, t + 1, leaf_id)
    return leaf_id


def predict_forest_scores(trees: PredictTree, x: torch.Tensor
                          ) -> torch.Tensor:
    """[N] raw scores: the sum over trees, in tree order, of each tree's
    leaf value for every row of x [N, F] float64."""
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for i in range(trees.split_leaf.shape[0]):
        out = out + trees.leaf_value[i][tree_leaves(trees, i, x)]
    return out


def predict_forest_leaves(trees: PredictTree, x: torch.Tensor
                          ) -> torch.Tensor:
    """[N, T] int32 leaf ids of every row of x [N, F] float64 in each of
    the T trees (PredictLeafIndex, gbdt.cpp:564-583; the JAX package's
    ``predict_forest_leaves_raw``), with ``predict_forest_scores``'s float64
    decisions."""
    return torch.stack([tree_leaves(trees, i, x).to(torch.int32)
                        for i in range(trees.split_leaf.shape[0])], dim=1)


def predict_forest_early_stop(trees: PredictTree, x: torch.Tensor,
                              num_class: int, freq: int, margin: float
                              ) -> torch.Tensor:
    """[N, K] raw scores with the margin early stop of prediction
    (src/boosting/prediction_early_stop.cpp; the JAX package's
    ``predict_forest_early_stop``, core/tree.py:175-210). ``trees`` are
    the forest in tree order, K = ``num_class`` trees an iteration. After
    every ``freq``-th iteration, a row whose margin has reached
    ``margin`` adds no more trees: the margin is 2|s| for one class and
    the largest score less the second for K. Stopped rows freeze while
    the whole batch runs on, so nothing is read back."""
    n = x.shape[0]
    acc = torch.zeros((n, num_class), dtype=torch.float32, device=x.device)
    stopped = torch.zeros(n, dtype=torch.bool, device=x.device)
    for it in range(trees.split_leaf.shape[0] // num_class):
        delta = torch.stack([
            trees.leaf_value[i][tree_leaves(trees, i, x)]
            for i in range(it * num_class, (it + 1) * num_class)], dim=1)
        acc = acc + torch.where(stopped[:, None], 0.0, delta)
        if (it + 1) % freq == 0:
            if num_class > 1:
                top2 = torch.topk(acc, 2, dim=1).values
                reached = top2[:, 0] - top2[:, 1] >= margin
            else:
                reached = 2.0 * torch.abs(acc[:, 0]) >= margin
            stopped = stopped | reached
    return acc


class BinnedTree(NamedTuple):
    """One host tree's splits in bin space, as tensors on the device."""
    nodes: torch.Tensor   # [L-1, 12] int64: stored column, threshold bin,
    #                       default_left, missing type, num_bin, default
    #                       bin, left child, right child (~leaf for
    #                       leaves), bin offset, pack_div, pack_mod,
    #                       is_categorical
    depth: int            # levels from the root to the deepest leaf
    # [L-1, 8] int64 bin-space bitsets, None when no node is categorical
    cat_bitset: Optional[torch.Tensor] = None


def tree_depth(left_child: np.ndarray, right_child: np.ndarray,
               num_nodes: int) -> int:
    """Edges on the longest root-to-leaf path (0 for a single leaf)."""
    if num_nodes <= 0:
        return 0
    depth, level = 0, [0]
    while level:
        depth += 1
        level = [c for node in level
                 for c in (left_child[node], right_child[node]) if c >= 0]
    return depth


def binned_tree(ht, columns: np.ndarray, offset: np.ndarray,
                pack_div: np.ndarray, pack_mod: np.ndarray,
                num_bin: np.ndarray, default_bin: np.ndarray,
                device: torch.device) -> BinnedTree:
    """The bin-space table of host tree ``ht`` (HostTree, or a LoadedTree
    given its ``cat_bitset_bin``): for each of its nodes, the split
    feature's stored column, how to decode it (bin offset, ``pack_div``,
    ``pack_mod``: 0, 1, 0 for a column of its own), its bin layout
    (``num_bin``, ``default_bin``) and, for a categorical node, its
    bin-space bitset."""
    nn = max(int(ht.num_leaves_actual) - 1, 0)
    is_cat = np.asarray(ht.is_categorical[:nn], bool)
    table = np.stack([
        columns[:nn], ht.threshold_bin[:nn], ht.default_left[:nn],
        ht.missing_type[:nn], num_bin[:nn], default_bin[:nn],
        ht.left_child[:nn], ht.right_child[:nn], offset[:nn],
        pack_div[:nn], pack_mod[:nn], is_cat], axis=1).astype(np.int64)
    bitset = None
    if is_cat.any():
        bitset = torch.as_tensor(ht.cat_bitset_bin[:nn].astype(np.int64),
                                 device=device)
    return BinnedTree(
        nodes=torch.as_tensor(table.reshape(nn, 12), device=device),
        depth=tree_depth(ht.left_child, ht.right_child, nn),
        cat_bitset=bitset)


def replay_leaves_binned(tree: BinnedTree, xb: torch.Tensor) -> torch.Tensor:
    """[N] int64 leaf of every row of the stored matrix ``xb`` [N, C]."""
    n = xb.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=xb.device)
    if tree.depth == 0:
        return node
    for _ in range(tree.depth):
        safe = node.clamp(min=0)
        at = tree.nodes.index_select(0, safe)                   # [N, 12]
        binv = decode_bundle_value(xb.gather(1, at[:, 0:1])[:, 0], at[:, 8],
                                   at[:, 4], at[:, 5], at[:, 9], at[:, 10])
        cat_args = ()
        if tree.cat_bitset is not None:
            words = tree.cat_bitset.reshape(-1)
            cat_args = (at[:, 11].bool(), lambda wi: words.index_select(
                0, safe * CAT_WORDS + wi))
        go_left = _bin_go_left(binv, at[:, 1], at[:, 2].bool(), at[:, 3],
                               at[:, 4], at[:, 5], *cat_args)
        node = torch.where(node >= 0,
                           torch.where(go_left, at[:, 6], at[:, 7]), node)
    return ~node
