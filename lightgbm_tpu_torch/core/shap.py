"""TreeSHAP feature contributions (``pred_contrib``).

The port of ``lightgbm_tpu/core/shap.py``: path-dependent TreeSHAP
(Lundberg & Lee 2017) with the reference's ``PredictContrib`` semantics
(src/io/tree.cpp:628-698 TreeSHAP/Extend/Unwind): ``num_features + 1``
columns a class, the last the expected value (bias), each class's columns
summing to its raw score. Two functions compute it:

- ``predict_contrib_plain``: the JAX package's recursion, on the host in
  numpy float64, one row and one tree at a time. The tests and
  chip_smoke.py hold the device version to it.
- ``predict_contrib``: the same values in torch float64 on the booster's
  device, vectorized over rows and leaves as GPUTreeShap (Mitchell et al.,
  2022) lays the problem out. The host walks each tree once, to every
  leaf's root-to-leaf path; a feature that repeats on a path is merged into
  one path element as the recursion's ``_unwind`` does (its zero fraction
  the product of its cover ratios, its one fraction 1 only where the row
  takes the leaf's side at each of its splits). The device decides every
  node for every row at once ([N, nodes], the ``decision_go_left`` and
  ``categorical_go_left`` of prediction), gathers the one fractions
  [N, L, D], runs ``_extend`` as D vector steps and ``_unwound_path_sum``
  for every path element at once, and adds the results into [N, F + 1]:
  O(D) torch operations a tree, D the longest merged path + 1, no loop
  over rows. Rows go in chunks, so that the [rows, L, D] float64 tensors
  of a chunk (``LIVE_TENSORS`` at once) stay within ``CHUNK_BYTES``. The
  two functions add in different orders, so they agree to rounding, not
  bit for bit.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .split import MISSING_NAN, MISSING_ZERO
from .tree import categorical_go_left, decision_go_left

K_ZERO_THRESHOLD = 1e-35
# the [rows, L, D] float64 tensors of one chunk of rows, and how many of
# them ``_tree_contrib`` holds at once
CHUNK_BYTES = 1 << 30
LIVE_TENSORS = 8


def _children(ht, node: int):
    """(left, right) child ids of ``node``; negative = ~leaf."""
    return int(ht.left_child[node]), int(ht.right_child[node])


def _node_cover(ht, node_or_leaf: int) -> float:
    if node_or_leaf < 0:
        return float(ht.leaf_count[~node_or_leaf])
    return float(ht.internal_count[node_or_leaf])


def _num_feat(impl, x: np.ndarray) -> int:
    """The contribution columns a class, less the bias: the training set's
    feature count, else the largest split feature + 1, and at least the
    data's width (shap.py:185-190 of the JAX package)."""
    num_feat = max(
        (int(np.max(t.split_feature[:max(t.num_leaves_actual - 1, 0)]))
         for t in impl.models if t.num_leaves_actual > 1), default=-1) + 1
    if impl.train_data is not None:
        num_feat = impl.train_data.num_total_features
    return max(num_feat, x.shape[1])


def _iterations(impl, num_iteration: Optional[int]) -> int:
    total = len(impl.models) // max(impl.num_tree_per_iteration, 1)
    return total if num_iteration is None or num_iteration <= 0 \
        else min(num_iteration, total)


def tree_expected_value(ht) -> float:
    """Count-weighted mean leaf output: the tree's share of the bias
    column."""
    nl = ht.num_leaves_actual
    counts = np.asarray(ht.leaf_count[:nl], np.float64)
    total = counts.sum()
    if total <= 0:
        return float(ht.leaf_value[0])
    return float(np.dot(counts, np.asarray(ht.leaf_value[:nl], np.float64))
                 / total)


# ---- the plain version: the JAX package's recursion ----------------------

def _decision_go_left(ht, node: int, x: np.ndarray) -> bool:
    """Raw-value decision (tree.h:212-260 NumericalDecision /
    CategoricalDecision) of one row, in float64."""
    fval = x[ht.split_feature[node]]
    missing_type = int(ht.missing_type[node])
    if ht.is_categorical[node]:
        if np.isnan(fval) or fval < 0 or fval >= ht.cat_bitset.shape[1] * 32:
            return False
        ci = int(fval)
        return bool((int(ht.cat_bitset[node][ci >> 5]) >> (ci & 31)) & 1)
    is_nan = bool(np.isnan(fval))
    if missing_type != MISSING_NAN and is_nan:
        fval = 0.0
        is_nan = False
    if missing_type == MISSING_NAN and is_nan:
        return bool(ht.default_left[node])
    if missing_type == MISSING_ZERO and abs(fval) <= K_ZERO_THRESHOLD:
        return bool(ht.default_left[node])
    return fval <= ht.threshold[node]


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, feature_index=-1, zero_fraction=0.0, one_fraction=0.0,
                 pweight=0.0):
        self.feature_index = feature_index
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight

    def copy(self):
        return _PathElement(self.feature_index, self.zero_fraction,
                            self.one_fraction, self.pweight)


def _extend(path: List[_PathElement], unique_depth: int, zero_fraction: float,
            one_fraction: float, feature_index: int) -> None:
    path[unique_depth].feature_index = feature_index
    path[unique_depth].zero_fraction = zero_fraction
    path[unique_depth].one_fraction = one_fraction
    path[unique_depth].pweight = 1.0 if unique_depth == 0 else 0.0
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += (one_fraction * path[i].pweight * (i + 1)
                                / (unique_depth + 1))
        path[i].pweight = (zero_fraction * path[i].pweight
                           * (unique_depth - i) / (unique_depth + 1))


def _unwind(path: List[_PathElement], unique_depth: int,
            path_index: int) -> None:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = (next_one_portion * (unique_depth + 1)
                               / ((i + 1) * one_fraction))
            next_one_portion = tmp - path[i].pweight * zero_fraction * \
                (unique_depth - i) / (unique_depth + 1)
        else:
            path[i].pweight = (path[i].pweight * (unique_depth + 1)
                               / (zero_fraction * (unique_depth - i)))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction


def _unwound_path_sum(path: List[_PathElement], unique_depth: int,
                      path_index: int) -> float:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = (next_one_portion * (unique_depth + 1)
                   / ((i + 1) * one_fraction))
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * \
                ((unique_depth - i) / (unique_depth + 1))
        else:
            total += (path[i].pweight / zero_fraction
                      / ((unique_depth - i) / (unique_depth + 1)))
    return total


def _tree_shap(ht, x: np.ndarray, phi: np.ndarray, node: int,
               unique_depth: int, parent_path: List[_PathElement],
               parent_zero_fraction: float, parent_one_fraction: float,
               parent_feature_index: int) -> None:
    # the path holds unique_depth + 1 elements: the JAX package pads it
    # with 64 unused ones, which change no value
    path = [p.copy() for p in parent_path[:unique_depth]] + [_PathElement()]
    _extend(path, unique_depth, parent_zero_fraction, parent_one_fraction,
            parent_feature_index)

    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, unique_depth + 1):
            w = _unwound_path_sum(path, unique_depth, i)
            el = path[i]
            phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction) \
                * float(ht.leaf_value[leaf])
        return

    left, right = _children(ht, node)
    hot, cold = ((left, right) if _decision_go_left(ht, node, x)
                 else (right, left))
    node_count = _node_cover(ht, node)
    hot_zero_fraction = _node_cover(ht, hot) / node_count
    cold_zero_fraction = _node_cover(ht, cold) / node_count
    incoming_zero_fraction = 1.0
    incoming_one_fraction = 1.0

    # a feature split on before: undo its element and combine fractions
    split_feat = int(ht.split_feature[node])
    path_index = next((i for i in range(1, unique_depth + 1)
                       if path[i].feature_index == split_feat), 0)
    if path_index > 0:
        incoming_zero_fraction = path[path_index].zero_fraction
        incoming_one_fraction = path[path_index].one_fraction
        _unwind(path, unique_depth, path_index)
        unique_depth -= 1

    _tree_shap(ht, x, phi, hot, unique_depth + 1, path,
               hot_zero_fraction * incoming_zero_fraction,
               incoming_one_fraction, split_feat)
    _tree_shap(ht, x, phi, cold, unique_depth + 1, path,
               cold_zero_fraction * incoming_zero_fraction, 0.0, split_feat)


def predict_contrib_plain(impl, X: np.ndarray,
                          num_iteration: Optional[int] = None) -> np.ndarray:
    """SHAP values of a boosting model (``impl``, a GBDT) by the JAX
    package's recursion (shap.py:178-213 there): [N, (F+1) * K], per class
    F feature columns then the expected value; each class's columns sum
    to its raw score."""
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    n = X.shape[0]
    k = impl.num_tree_per_iteration
    use_iters = _iterations(impl, num_iteration)
    num_feat = _num_feat(impl, X)
    out = np.zeros((n, k, num_feat + 1), np.float64)
    for it in range(use_iters):
        for c in range(k):
            ht = impl.models[it * k + c]
            ev = tree_expected_value(ht)
            for r in range(n):
                out[r, c, num_feat] += ev
                if ht.num_leaves_actual > 1:
                    _tree_shap(ht, X[r], out[r, c, :], 0, 0, [], 1.0, 1.0,
                               -1)
    if impl.average_output and use_iters > 0:
        out /= use_iters
    return out.reshape(n, -1) if k > 1 else out[:, 0, :]


# ---- the device version ---------------------------------------------------

class TreePaths(NamedTuple):
    """Every leaf's root-to-leaf path of one tree, on the device. Leaves
    L, path steps S (the deepest leaf's depth), merged elements D (the
    most distinct features on a path, + 1 for the recursion's element 0,
    which has no feature)."""
    node: torch.Tensor       # [L, S] int64 the node of each step (0: none)
    left: torch.Tensor       # [L, S] bool the leaf lies left of it
    elem: torch.Tensor       # [L, S] int64 the step's merged element (0:
    #                          none)
    feature: torch.Tensor    # [L, D] int64 each element's feature (0:
    #                          none)
    zero: torch.Tensor       # [L, D] float64 zero fractions (1: none)
    depth: torch.Tensor      # [L] int64 elements on the path, element 0
    #                          not counted (the recursion's unique_depth)
    leaf_value: torch.Tensor  # [L] float64
    max_depth: int           # depth.max()


def tree_paths(ht, device: torch.device) -> TreePaths:
    """Walk tree ``ht`` (a HostTree or LoadedTree with two leaves or more)
    once on the host, to each leaf's path, merging a repeated feature into
    its one element as the recursion does: the element moves to the
    path's end with its zero fraction multiplied by the new cover ratio."""
    nl = int(ht.num_leaves_actual)
    steps: List[list] = [None] * nl
    merged: List[list] = [None] * nl
    stack = [(0, [], [])]               # (node, steps, [feature, zero])
    while stack:
        node, path, elems = stack.pop()
        if node < 0:
            steps[~node], merged[~node] = path, elems
            continue
        feat = int(ht.split_feature[node])
        cover = _node_cover(ht, node)
        for child, is_left in ((int(ht.left_child[node]), True),
                               (int(ht.right_child[node]), False)):
            ratio = _node_cover(ht, child) / cover
            prior = [e for e in elems if e[0] == feat]
            rest = [e for e in elems if e[0] != feat]
            zero = ratio * prior[0][1] if prior else ratio
            stack.append((child, path + [(node, is_left)],
                          rest + [(feat, zero)]))
    s = max(max((len(p) for p in steps), default=1), 1)
    d = max(len(m) for m in merged) + 1
    node = np.zeros((nl, s), np.int64)
    left = np.ones((nl, s), bool)
    elem = np.zeros((nl, s), np.int64)
    feature = np.zeros((nl, d), np.int64)
    zero = np.ones((nl, d), np.float64)
    for leaf in range(nl):
        at = {f: j + 1 for j, (f, _) in enumerate(merged[leaf])}
        for i, (nd, is_left) in enumerate(steps[leaf]):
            node[leaf, i] = nd
            left[leaf, i] = is_left
            elem[leaf, i] = at[int(ht.split_feature[nd])]
        for j, (f, z) in enumerate(merged[leaf]):
            feature[leaf, j + 1] = f
            zero[leaf, j + 1] = z
    depth = np.array([len(m) for m in merged], np.int64)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return TreePaths(dev(node), dev(left), dev(elem), dev(feature),
                     dev(zero), dev(depth),
                     dev(np.asarray(ht.leaf_value[:nl], np.float64)),
                     int(depth.max()))


def node_decisions(ht, x: torch.Tensor) -> torch.Tensor:
    """[N, nodes] bool: every row of x [N, F] float64 goes left at every
    node of ``ht``, by prediction's float64 decisions."""
    nn = int(ht.num_leaves_actual) - 1
    dev = x.device
    feat = torch.as_tensor(np.asarray(ht.split_feature[:nn], np.int64),
                           device=dev)
    fval = x.index_select(1, feat)                               # [N, nn]
    go_left = decision_go_left(
        fval,
        torch.as_tensor(np.asarray(ht.threshold[:nn], np.float64),
                        device=dev),
        torch.as_tensor(np.asarray(ht.default_left[:nn], bool), device=dev),
        torch.as_tensor(np.asarray(ht.missing_type[:nn], np.int64),
                        device=dev))
    for t in np.flatnonzero(np.asarray(ht.is_categorical[:nn], bool)):
        words = torch.as_tensor(
            np.ascontiguousarray(ht.cat_bitset[t], np.uint32).view(np.int32)
            .astype(np.int64), device=dev)
        go_left[:, t] = categorical_go_left(fval[:, t], words)
    return go_left


def _tree_contrib(paths: TreePaths, go_left: torch.Tensor,
                  phi: torch.Tensor) -> None:
    """Add one tree's SHAP values of a chunk of rows into phi [R, F + 1]:
    the recursion's values at every leaf, every leaf at once."""
    r = go_left.shape[0]
    nl, d = paths.zero.shape
    # one fractions [R, L, D]: 1 where the row takes the leaf's side at
    # every split of the element's feature (the dummy element 0 too)
    ok = go_left[:, paths.node] == paths.left                    # [R, L, S]
    flat = (torch.arange(nl, device=phi.device)[:, None] * d
            + paths.elem).reshape(-1)
    misses = torch.zeros((r, nl * d), dtype=torch.float64,
                         device=phi.device)
    misses.index_add_(1, flat, (~ok).reshape(r, -1).to(torch.float64))
    one = (misses == 0).to(torch.float64).reshape(r, nl, d)
    zero = paths.zero[None].expand(r, nl, d)
    depth = paths.depth
    # _extend of elements 1..depth, each leaf up to its own depth
    pw = torch.zeros((r, nl, d), dtype=torch.float64, device=phi.device)
    pw[..., 0] = 1.0
    k = torch.arange(d, device=phi.device, dtype=torch.float64)
    for u in range(1, paths.max_depth + 1):
        z = zero[..., u:u + 1]
        o = one[..., u:u + 1]
        shifted = torch.cat([torch.zeros_like(pw[..., :1]), pw[..., :-1]],
                            dim=2)
        new = (z * pw * (u - k) / (u + 1)
               + o * shifted * k / (u + 1))
        new = torch.where(k <= u, new, pw)
        pw = torch.where((u <= depth)[None, :, None], new, pw)
    # _unwound_path_sum of every element j at once ([R, L, D] over j)
    ud = depth.to(torch.float64)[None, :, None]                  # [1, L, 1]
    nop = pw.gather(2, depth[None, :, None].expand(r, nl, 1)).expand(
        r, nl, d)
    total_one = torch.zeros_like(pw)
    total_zero = torch.zeros_like(pw)
    for i in range(paths.max_depth - 1, -1, -1):
        live = (i < depth)[None, :, None]
        pw_i = pw[..., i:i + 1]
        tmp = nop * (ud + 1) / ((i + 1) * one)
        total_one = torch.where(live, total_one + tmp, total_one)
        nop = torch.where(live, pw_i - tmp * zero * ((ud - i) / (ud + 1)),
                          nop)
        total_zero = torch.where(
            live, total_zero + pw_i / zero / ((ud - i) / (ud + 1)),
            total_zero)
    w = torch.where(one != 0, total_one, total_zero)
    j = torch.arange(d, device=phi.device)
    real = (j[None, :] >= 1) & (j[None, :] <= depth[:, None])      # [L, D]
    contrib = torch.where(real[None], w * (one - zero)
                          * paths.leaf_value[None, :, None], 0.0)
    phi.index_add_(1, paths.feature.reshape(-1),
                   contrib.reshape(r, nl * d))


def contrib_tensor(impl, x: torch.Tensor,
                   num_iteration: Optional[int] = None) -> torch.Tensor:
    """[N, K, F + 1] float64 SHAP values of the rows x [N, F'] float64 on
    their device (``predict_contrib``'s layout before the reshape)."""
    n = x.shape[0]
    k = impl.num_tree_per_iteration
    use_iters = _iterations(impl, num_iteration)
    num_feat = _num_feat(impl, x)
    out = torch.zeros((n, k, num_feat + 1), dtype=torch.float64,
                      device=x.device)
    for it in range(use_iters):
        for c in range(k):
            ht = impl.models[it * k + c]
            out[:, c, num_feat] += tree_expected_value(ht)
            if ht.num_leaves_actual <= 1:
                continue
            paths = tree_paths(ht, x.device)
            rows = max(1, CHUNK_BYTES
                       // (LIVE_TENSORS * 8 * paths.zero.numel()))
            for lo in range(0, n, rows):
                chunk = x[lo:lo + rows]
                phi = torch.zeros((chunk.shape[0], num_feat + 1),
                                  dtype=torch.float64, device=x.device)
                _tree_contrib(paths, node_decisions(ht, chunk), phi)
                out[lo:lo + rows, c] += phi
    if impl.average_output and use_iters > 0:
        out /= use_iters
    return out


def predict_contrib(impl, X: np.ndarray,
                    num_iteration: Optional[int] = None) -> np.ndarray:
    """SHAP values of a boosting model on its device: [N, (F+1) * K], per
    class F feature columns then the expected value, on the host as every
    ``predict`` returns them."""
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    out = contrib_tensor(impl, torch.as_tensor(X, device=impl.device),
                         num_iteration).cpu().numpy()
    return out.reshape(len(X), -1) if out.shape[1] > 1 else out[:, 0, :]
