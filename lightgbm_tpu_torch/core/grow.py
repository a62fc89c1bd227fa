"""Leaf-wise (best-first) tree growth.

The port of ``lightgbm_tpu/core/grow.py`` ``grow_tree`` for one device with
the row partition (SerialTreeLearner::Train, serial_tree_learner.cpp:
169-233, and Tree::Split, tree.cpp:49-67 of the reference). The root
(``root_split``, shared with the wave growers) takes one histogram over all
rows; every split then runs the fused partition and two-child histogram
pass (``core/partition.py``) and searches both children in one batched
call.

Histograms are built over the stored columns ``[C, B, 3]``. Where EFB
bundles or packed pairs share columns (``GrowParams.with_efb``), each
search first expands them into per-feature views ``[F, Bf, 3]``
(``expand_hist``) and each routing decision decodes the stored byte into
the split feature's own bin (``decode_bundle_value``). A categorical split
(``SplitParams.cat_features`` lists the categorical features) sends a row
left when its bin's bit is set in the split's bin-space bitset, and a
node records that bitset.

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
from .split import (BestSplit, CAT_WORDS, FeatureMeta, K_MIN_SCORE,
                    MISSING_NAN, MISSING_ZERO, SplitParams,
                    calculate_leaf_output, device_index, find_best_split)


class GrowParams(NamedTuple):
    num_leaves: int
    num_bins: int            # bin axis size B of the histograms
    max_depth: int
    split: SplitParams
    hist_impl: str = "auto"  # core/histogram.py: auto | plain
    # the plain histograms sum in float64 (core/histogram.py f64_sums; set
    # by chip_smoke.py and the tests, not by a Config parameter)
    plain_f64_sums: bool = False
    # tree_growth=batched (core/grow_batched.py): split up to this many of
    # the highest-gain leaves per step
    batch_splits: int = 16
    # tpu_batched_pack: the batched step runs the slot kernel over child
    # slots instead of the parent-slot pass
    batched_pack: bool = False
    # tpu_batched_part: the batched step keeps the rows grouped by leaf
    # (core/grow_batched_part.py)
    batched_part: bool = False
    # EFB and packed pairs (io/dataset.py): histograms are built over the
    # stored columns ([C, num_bins]) and expanded to per-feature views
    # ([F, num_feat_bins]) before the split search; routing decodes the
    # stored values through meta.col / offset / pack_div / pack_mod.
    # num_feat_bins 0 means num_bins.
    with_efb: bool = False
    num_feat_bins: int = 0
    # the widest marginalisation of a packed pair (the largest
    # pack_partner; 1 = no packed columns) and the packed inner features
    pack_j: int = 1
    packed_features: tuple = ()


class TreeArrays(NamedTuple):
    """Fixed-capacity tree on the host, the JAX package's TreeArrays layout
    (tree.h:404-517): internal-node arrays [L-1], leaf arrays [L]."""
    split_feature: np.ndarray    # [L-1] int32 inner feature index
    threshold_bin: np.ndarray    # [L-1] int32
    default_left: np.ndarray     # [L-1] bool
    missing_type: np.ndarray     # [L-1] int32
    is_categorical: np.ndarray   # [L-1] bool
    cat_bitset: np.ndarray       # [L-1, 8] uint32: the bins going left
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
    fields [L-1], leaf fields [L]. Integer fields are int64, the bitsets
    [L-1, 8] int64 words of 32 bits. The leaf count is kept by the
    host."""
    split_feature: torch.Tensor
    threshold_bin: torch.Tensor
    default_left: torch.Tensor
    missing_type: torch.Tensor
    is_categorical: torch.Tensor
    cat_bitset: torch.Tensor
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
        is_categorical=torch.zeros(l - 1, dtype=torch.bool, device=device),
        cat_bitset=torch.zeros((l - 1, CAT_WORDS), **i64),
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
    floats = BestSplit._fields[4:-2]
    return BestSplit(
        gain=torch.full_like(z, K_MIN_SCORE), feature=zi, threshold=zi.clone(),
        default_left=torch.zeros_like(zi, dtype=torch.bool),
        **{k: z.clone() for k in floats},
        is_categorical=torch.zeros_like(zi, dtype=torch.bool),
        cat_bitset=torch.zeros((num_leaves, CAT_WORDS), dtype=torch.int64,
                               device=device))


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
    host["cat_bitset"] = host["cat_bitset"].astype(np.uint32)
    return TreeArrays(num_leaves=num_leaves, **host)


def expand_hist(hist: torch.Tensor, sum_g: torch.Tensor,
                sum_h: torch.Tensor, cnt: torch.Tensor, meta: FeatureMeta,
                params: GrowParams) -> torch.Tensor:
    """[..., C, B, 3] column histograms -> [..., F, Bf, 3] per-feature
    views, with leaf totals sum_g, sum_h, cnt [...] (the JAX package's
    ``expand_hist``, over leading batch dims).

    EFB: each feature's bins are a contiguous slice of its column
    (feature_group.h bin_offsets_). A bundled feature's default bin is
    shared with its bundle-mates, so its entry is rebuilt from the leaf
    totals, the Dataset::FixHistogram idea (dataset.h:411-412). Packed
    pair columns: a feature's bin-b entry is the marginal over the
    pair-mate's digit, the sum of ``pack_partner`` joint bins at stride
    1 (the high digit) or ``pack_mod`` (the low digit).
    """
    if not params.with_efb:
        return hist
    b = params.num_bins
    bf = params.num_feat_bins or b
    lead = tuple(hist.shape[:-3])
    ncols = hist.shape[-3]
    dev = hist.device
    f = meta.num_bin.shape[0]
    flat = hist.reshape(lead + (ncols * b, 3))
    bidx = torch.arange(bf, device=dev)[None, :]                 # [1, Bf]
    in_feat = bidx < meta.num_bin[:, None]                       # [F, Bf]
    idx = (meta.col[:, None] * b + meta.offset[:, None] + bidx).clamp(
        0, ncols * b - 1)
    out = flat.index_select(-2, idx.reshape(-1)).reshape(lead + (f, bf, 3))
    zero = hist.new_zeros(())
    out = torch.where(in_feat[..., None], out, zero)
    if params.packed_features:
        # overwrite the packed features' rows with marginals of their
        # column's joint histogram: a [P, Bf, J] gather-sum over the packed
        # subset, so unpacked features never pay the marginalisation
        pf = device_index(params.packed_features, dev)            # [P]
        div, mod = meta.pack_div[pf], meta.pack_mod[pf]
        jstride = torch.where(div > 1, torch.ones_like(mod),
                              mod.clamp(min=1))
        jj = torch.arange(params.pack_j, device=dev)[None, None, :]
        bidx_p = torch.arange(bf, device=dev)[None, :, None]
        idx_p = (meta.col[pf][:, None, None] * b
                 + bidx_p * div[:, None, None]
                 + jj * jstride[:, None, None])                   # [P, Bf, J]
        ok = ((jj < meta.pack_partner[pf][:, None, None])
              & (bidx_p < meta.num_bin[pf][:, None, None]))
        gathered = flat.index_select(
            -2, idx_p.clamp(0, ncols * b - 1).reshape(-1)).reshape(
                lead + tuple(idx_p.shape) + (3,))
        out_p = torch.where(ok[..., None], gathered, zero).sum(dim=-2)
        out = out.index_copy(-3, pf, out_p)
    totals = torch.stack([sum_g, sum_h, cnt], dim=-1)            # [..., 3]
    is_def = bidx == meta.default_bin[:, None]                   # [F, Bf]
    sum_wo_def = torch.where(is_def[..., None], zero, out).sum(dim=-2)
    rebuilt = totals[..., None, :] - sum_wo_def                  # [..., F, 3]
    fix = (is_def & meta.bundled[:, None])[..., None]            # [F, Bf, 1]
    return torch.where(fix, rebuilt[..., None, :], out)


def decode_bundle_value(v: torch.Tensor, offset: torch.Tensor,
                        num_bin: torch.Tensor, default_bin: torch.Tensor,
                        pack_div: torch.Tensor = None,
                        pack_mod: torch.Tensor = None) -> torch.Tensor:
    """Stored column value -> the feature's own bin index (int64).

    EFB bundles: a value inside [offset, offset + num_bin) belongs to this
    feature; anything else means some bundle-mate (or the shared zero
    slot) is active, so this feature sits at its default bin
    (``io/bundle.py``'s encoding). Packed pair columns: the feature's bin
    is a base-``pack_div`` digit of the stored value. Identity for
    singleton columns (offset 0, values always in range).
    """
    vv = v.to(torch.int64)
    if pack_div is not None:
        digit = torch.div(vv, pack_div.clamp(min=1),
                          rounding_mode="floor") % pack_mod.clamp(min=1)
        vv = torch.where(pack_mod > 0, digit, vv)
    vv = vv - offset
    return torch.where((vv >= 0) & (vv < num_bin), vv, default_bin)


def root_split(xb: torch.Tensor, vals: torch.Tensor, meta: FeatureMeta,
               feature_mask: torch.Tensor, params: GrowParams):
    """The root of a wave-grown tree, as in exact growth: returns the
    empty device tree with leaf 0 set, the best-split table with the
    root's best split, and the root histogram over the stored columns
    [C, B, 3]."""
    l = params.num_leaves
    sp = params.split
    dev = xb.device
    root = vals.sum(dim=0)                                   # (g, h, count)
    hist_root = hist_tile_vals(xb, vals, params.num_bins, params.hist_impl,
                               params.plain_f64_sums)
    tree = empty_tree(l, dev)
    tree.leaf_value[0] = calculate_leaf_output(root[0], root[1], sp.lambda_l1,
                                               sp.lambda_l2, sp.max_delta_step)
    tree.leaf_weight[0] = root[1]
    tree.leaf_count[0] = root[2]
    best = _empty_best(l, dev)
    b0 = find_best_split(
        expand_hist(hist_root[None], root[0:1], root[1:2], root[2:3], meta,
                    params),
        meta, sp, root[0:1], root[1:2], root[2:3], feature_mask)
    _set_best(best, slice(0, 1), b0)
    return tree, best, hist_root


def _bin_go_left(col: torch.Tensor, threshold, default_left, missing_type,
                 num_bin, default_bin, is_cat=None,
                 cat_word=None) -> torch.Tensor:
    """Decision in bin space (Tree::NumericalDecisionInner /
    CategoricalDecisionInner, tree.h:212-260): missing rows follow
    ``default_left``, the others go left when their bin is <= threshold;
    under a categorical split a row goes left when its bin's bit is set.

    One split (scalar parameters) or per-row splits ([N] parameters).
    ``cat_word(word_index)`` reads the split's bitset word for each row's
    bin (one split's [8] words, or each row's split's). ``is_cat=None``
    skips the categorical branch, the fast path of data with no
    categorical feature."""
    coli = col.to(torch.int64)
    is_missing = torch.where(missing_type == MISSING_NAN,
                             coli == num_bin - 1,
                             (missing_type == MISSING_ZERO)
                             & (coli == default_bin))
    numerical = torch.where(is_missing, default_left, coli <= threshold)
    if is_cat is None:
        return numerical
    categorical = ((cat_word(coli >> 5) >> (coli & 31)) & 1) == 1
    return torch.where(is_cat, categorical, numerical)


def _set_best(best: BestSplit, slots: torch.Tensor, new: BestSplit) -> None:
    for arr, val in zip(best, new):
        arr[slots] = val


def grow_tree(xb: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              sample_mask: torch.Tensor, meta: FeatureMeta,
              feature_mask: torch.Tensor, params: GrowParams
              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one leaf-wise tree; returns (tree on the host, per-row leaf id
    on the device).

    xb [N, C] uint8 stored columns; grad, hess, sample_mask [N] float32
    on the same device; feature_mask [F] bool.
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
        if params.with_efb:
            stored_col = meta.col.index_select(0, feat)
            offset, pack_div, pack_mod = (
                m.index_select(0, feat)[0]
                for m in (meta.offset, meta.pack_div, meta.pack_mod))
        else:
            stored_col = feat

        def go_left_rows(rows):
            col = rows.index_select(1, stored_col)[:, 0]
            if params.with_efb:
                col = decode_bundle_value(col, offset, num_bin, default_bin,
                                          pack_div, pack_mod)
            if not sp.cat_features:
                return _bin_go_left(col, cur.threshold, cur.default_left,
                                    missing_type, num_bin, default_bin)
            return _bin_go_left(
                col, cur.threshold, cur.default_left, missing_type, num_bin,
                default_bin, cur.is_categorical,
                lambda wi: cur.cat_bitset.index_select(0, wi.reshape(-1))
                .reshape(wi.shape))

        part, hist_left, hist_right = partition_and_hist(
            part, leaf, right_leaf, begin, count, xb, vals, go_left_rows, b,
            params.hist_impl, params.plain_f64_sums)

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
        if sp.cat_features:
            tree.is_categorical[node] = cur.is_categorical
            tree.cat_bitset[node] = cur.cat_bitset
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
        ch_g = torch.stack([cur.left_sum_grad, cur.right_sum_grad])
        ch_h = torch.stack([cur.left_sum_hess, cur.right_sum_hess])
        ch_c = torch.stack([cur.left_count, cur.right_count])
        b2 = find_best_split(
            expand_hist(torch.stack([hist_left, hist_right]), ch_g, ch_h,
                        ch_c, meta, params),
            meta, sp, ch_g, ch_h, ch_c, feature_mask)
        if 0 < params.max_depth <= depth:
            b2 = b2._replace(gain=torch.full_like(b2.gain, K_MIN_SCORE))
        _set_best(best, children, b2)

    leaf_id = leaf_id_from_partition(part, n, l)
    return tree_to_host(tree, num_leaves)._replace(
        left_child=left_child, right_child=right_child,
        split_leaf=split_leaf, leaf_parent=leaf_parent,
        leaf_depth=leaf_depth), leaf_id
