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

Three split-selection options (JAX ``core/grow.py:729-1015``):

- monotone constraints: each leaf carries output bounds ``[L]`` on the
  device, both children's are set at each split
  (``propagate_monotone_bounds``) and passed to their search;
- forced splits (``ForcedSplits``): step ``t < num_forced`` splits the
  forced leaf on the forced feature and bin, priced from the leaf's own
  histogram (``forced_split_info``, rebuilt by ``hist_for_leaf``). The
  rebuild gathers a row range the host already knows to hold the leaf's
  rows (its own or its parent's, from an earlier read) and zeroes the rows
  outside the leaf's range on the device, so a forced step reads nothing
  more than any other: its one read returns the leaf split, whether the
  split is usable, its row range and whether the forced split was taken.
  A forced split that is not usable (gain <= 0 or an empty side) turns
  that step and the rest of the forced phase into best-first growth;
- CEGB (``CegbState``, on the device): a per-feature gain penalty at the
  root and for both children of each split (``cegb_gain_penalty``); the
  state (features bought, and under lazy costs the in-bag rows that paid
  for each feature) is updated after each split and left in the ``Cegb``
  holder the caller passed, which merges an iteration's trees. A child's
  rows are the split's row range ``part.order[begin:begin + count]``,
  left ones first, so no per-row leaf id is kept.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .histogram import hist_tile_vals, stack_vals
from .partition import (hist_for_leaf, init_partition,
                        leaf_id_from_partition, partition_and_hist)
from .split import (BestSplit, CAT_WORDS, FeatureMeta, K_EPSILON,
                    K_MIN_SCORE, MISSING_NAN, MISSING_ZERO, SplitParams,
                    calculate_leaf_output, device_index, find_best_split,
                    leaf_split_gain)


class GrowParams(NamedTuple):
    num_leaves: int
    num_bins: int            # bin axis size B of the histograms
    max_depth: int
    split: SplitParams
    hist_impl: str = "auto"  # core/histogram.py: auto | plain
    # the histograms' and the split search's dtype: "f32", or "f64"
    # (gpu_use_dp; exact growth only, the tree rounded to f32 at the end)
    hist_dtype: str = "f32"
    # how the plain histograms add a cell's rows: running | blocked | f64
    # (core/histogram.py PLAIN_SUMS; set by chip_smoke.py and the tests,
    # not by a Config parameter)
    plain_sums: str = "running"
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
    # CEGB (serial_tree_learner.cpp:533-539), exact growth only: the split
    # penalty is tradeoff * cegb_penalty_split, times the leaf's count;
    # the coupled and lazy terms are on when their lists are given
    cegb_split_penalty: float = 0.0
    with_cegb_coupled: bool = False
    with_cegb_lazy: bool = False
    # tpu_bin_packing (core/binpack.py), frontier growth only: the stored
    # matrix is int32 [N, W] packed words holding this many code columns
    # (0: the uint8 [N, C] matrix); the histograms read the words in place
    # and routing gathers one code a row from them
    word_packed_cols: int = 0


class ForcedSplits(NamedTuple):
    """forcedsplits_filename's JSON in BFS order (ForceSplits,
    serial_tree_learner.cpp:593-751), host ints: step ``t`` splits leaf
    ``leaf[t]`` on inner feature ``feature[t]``, rows of bin <=
    ``threshold[t]`` going left. Step t's right child is leaf t + 1, so
    the leaves are known when the file is read."""
    leaf: tuple
    feature: tuple
    threshold: tuple


class CegbState(NamedTuple):
    """CEGB's acquisition state on the device, kept across trees (the JAX
    package's ``CegbState``; a SerialTreeLearner member in the
    reference): once a feature is bought, later splits on it are free."""
    coupled_penalty: torch.Tensor  # [F] f32 tradeoff * coupled penalty
    lazy_penalty: torch.Tensor     # [F] f32 tradeoff * lazy penalty
    feature_used: torch.Tensor     # [F] bool: some split on f so far
    row_used: torch.Tensor         # [F, N] uint8: the row paid for f;
    #                                [F, 0] without lazy penalties


class Cegb:
    """CEGB across trees: ``state`` is what each tree of an iteration
    starts from; each tree leaves the state it ends with in ``grown``, and
    ``merge``, once the iteration's trees are grown, makes their union the
    next start (any over ``feature_used``, max over ``row_used``: under
    multiclass every class grows from the iteration's state, gbdt.py:
    1319-1326 of the JAX package)."""

    def __init__(self, state: CegbState):
        self.state, self.grown = state, []

    def merge(self) -> None:
        if self.grown:
            self.state = self.state._replace(
                feature_used=torch.stack(
                    [s.feature_used for s in self.grown]).any(dim=0),
                row_used=torch.stack(
                    [s.row_used for s in self.grown]).amax(dim=0))
            self.grown = []


def cegb_gain_penalty(params: GrowParams, state: CegbState,
                      cnt: torch.Tensor,
                      unpaid: torch.Tensor = None) -> torch.Tensor:
    """[..., F] CEGB penalty of leaves of ``cnt`` [...] rows
    (serial_tree_learner.cpp:533-539, the JAX package's
    ``cegb_gain_penalty``): the split cost scales with the leaf's count,
    the coupled cost applies to features never bought, the lazy cost to
    ``unpaid`` [..., F], the leaf's in-bag weight of rows that have not
    paid for the feature (CalculateOndemandCosts, :484-504)."""
    f = state.coupled_penalty.shape[0]
    pen = (params.cegb_split_penalty * cnt)[..., None].expand(
        tuple(cnt.shape) + (f,))
    if params.with_cegb_coupled:
        pen = pen + torch.where(state.feature_used, 0.0,
                                state.coupled_penalty)
    if params.with_cegb_lazy:
        pen = pen + state.lazy_penalty * unpaid
    return pen


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


def empty_tree(num_leaves: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> DeviceTree:
    """A tree with one leaf and no nodes (``lightgbm_tpu/core/grow.py``
    ``empty_tree``): children and split leaves -1, everything else 0; its
    float fields in ``dtype``."""
    l = num_leaves
    i64 = dict(dtype=torch.int64, device=device)
    flt = dict(dtype=dtype, device=device)
    return DeviceTree(
        split_feature=torch.zeros(l - 1, **i64),
        threshold_bin=torch.zeros(l - 1, **i64),
        default_left=torch.zeros(l - 1, dtype=torch.bool, device=device),
        missing_type=torch.zeros(l - 1, **i64),
        is_categorical=torch.zeros(l - 1, dtype=torch.bool, device=device),
        cat_bitset=torch.zeros((l - 1, CAT_WORDS), **i64),
        left_child=torch.full((l - 1,), -1, **i64),
        right_child=torch.full((l - 1,), -1, **i64),
        split_gain=torch.zeros(l - 1, **flt),
        internal_value=torch.zeros(l - 1, **flt),
        internal_weight=torch.zeros(l - 1, **flt),
        internal_count=torch.zeros(l - 1, **flt),
        split_leaf=torch.full((l - 1,), -1, **i64),
        leaf_value=torch.zeros(l, **flt),
        leaf_weight=torch.zeros(l, **flt),
        leaf_count=torch.zeros(l, **flt),
        leaf_parent=torch.full((l,), -1, **i64),
        leaf_depth=torch.zeros(l, **i64))


def _empty_best(num_leaves: int, device: torch.device,
                dtype: torch.dtype = torch.float32) -> BestSplit:
    """The per-leaf best-split table: gain -inf (no split) everywhere, its
    float fields in ``dtype``."""
    z = torch.zeros(num_leaves, dtype=dtype, device=device)
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
    """A finished device tree as host TreeArrays, in one transfer. Float
    fields are rounded to float32 once, here: the model holds f32 values
    whatever the histograms' dtype (:1095-1100 of the JAX package)."""
    host = dict(zip(DeviceTree._fields, to_host(list(tree))))
    for k, v in host.items():
        if v.dtype == np.float64:
            host[k] = v.astype(np.float32)
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
               feature_mask: torch.Tensor, params: GrowParams,
               cegb: CegbState = None):
    """The root of a tree, shared by every grower: returns the empty
    device tree with leaf 0 set, the best-split table with the root's best
    split (CEGB-penalised where ``cegb`` is given), and the root histogram
    over the stored columns [C, B, 3]."""
    root = vals.sum(dim=0)                                   # (g, h, count)
    hist_root = hist_tile_vals(xb, vals, params.num_bins, params.hist_impl,
                               params.plain_sums, params.word_packed_cols)
    pen = None
    if cegb is not None:
        unpaid = None
        if params.with_cegb_lazy:
            unpaid = (vals[None, :, 2] * (1.0 - cegb.row_used.to(
                vals.dtype))).sum(dim=1)[None]
        pen = cegb_gain_penalty(params, cegb, root[2:3], unpaid)
    tree, best = root_from_hist(hist_root, root, meta, feature_mask, params,
                                pen)
    return tree, best, hist_root


def root_from_hist(hist_root: torch.Tensor, root: torch.Tensor,
                   meta: FeatureMeta, feature_mask: torch.Tensor,
                   params: GrowParams, gain_penalty=None):
    """The empty device tree with leaf 0 set and the best-split table with
    the root's best split, from the root's histogram [C, B, 3] and its
    (g, h, count) totals ``root`` [3] (a streamed tree sums its root
    histogram over the chunks first, ``stream/grow_stream.py``)."""
    l = params.num_leaves
    sp = params.split
    dev = hist_root.device
    tree = empty_tree(l, dev, root.dtype)
    tree.leaf_value[0] = calculate_leaf_output(root[0], root[1], sp.lambda_l1,
                                               sp.lambda_l2, sp.max_delta_step)
    tree.leaf_weight[0] = root[1]
    tree.leaf_count[0] = root[2]
    best = _empty_best(l, dev, root.dtype)
    b0 = find_best_split(
        expand_hist(hist_root[None], root[0:1], root[1:2], root[2:3], meta,
                    params),
        meta, sp, root[0:1], root[1:2], root[2:3], feature_mask,
        gain_penalty=gain_penalty)
    _set_best(best, slice(0, 1), b0)
    return tree, best


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


def forced_split_info(hist_col: torch.Tensor, feature: torch.Tensor,
                      threshold: torch.Tensor, meta: FeatureMeta,
                      params: GrowParams) -> Tuple[BestSplit, torch.Tensor]:
    """A forced split priced from its leaf's column histogram [C, B, 3]
    (GatherInfoForThresholdNumerical, feature_histogram.hpp:284-357; the
    JAX package's ``forced_split_info``): the leaf's totals from column 0,
    the feature's view through ``expand_hist``, the rows of bins above
    ``threshold`` going right and the default and NaN bins left. Returns
    (the split, default left, gain at least 1e-30; ok [1]: gain > 0 and
    both sides hold rows). ``feature`` and ``threshold`` are 0-d device
    ints."""
    sp = params.split
    sum_g, sum_h, cnt = (hist_col[0, :, k].sum() for k in range(3))
    # index_select: indexing with a 0-d device tensor reads it back
    f1 = feature.view(1)
    row = expand_hist(hist_col, sum_g, sum_h, cnt, meta,
                      params).index_select(0, f1)[0]
    nb, db, mt = (m.index_select(0, f1)[0]
                  for m in (meta.num_bin, meta.default_bin,
                            meta.missing_type))
    bidx = torch.arange(row.shape[0], device=row.device)
    in_right = ((bidx > threshold) & (bidx < nb)
                & ~((mt == MISSING_ZERO) & (bidx == db))
                & ~((mt == MISSING_NAN) & (bidx == nb - 1)))
    r = (row * in_right[:, None].to(row.dtype)).sum(dim=0)
    rg, rh, rc = r[0], r[1] + K_EPSILON, r[2]
    lg, lh, lc = sum_g - rg, sum_h - rh, cnt - rc
    l1, l2, mds = sp.lambda_l1, sp.lambda_l2, sp.max_delta_step
    shift = leaf_split_gain(sum_g, sum_h, l1, l2, mds) + sp.min_gain_to_split
    gain = (leaf_split_gain(lg, lh, l1, l2, mds)
            + leaf_split_gain(rg, rh, l1, l2, mds) - shift)
    ok = (gain > 0.0) & (lc > 0) & (rc > 0)
    split = BestSplit(
        gain=torch.clamp(gain, min=1e-30), feature=feature,
        threshold=threshold,
        default_left=torch.ones((), dtype=torch.bool, device=row.device),
        left_sum_grad=lg, left_sum_hess=lh, left_count=lc,
        right_sum_grad=rg, right_sum_hess=rh, right_count=rc,
        left_output=calculate_leaf_output(lg, lh, l1, l2, mds),
        right_output=calculate_leaf_output(rg, rh, l1, l2, mds),
        is_categorical=torch.zeros((), dtype=torch.bool, device=row.device),
        cat_bitset=torch.zeros(CAT_WORDS, dtype=torch.int64,
                               device=row.device))
    return split, ok.view(1)


def grow_tree(xb: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              sample_mask: torch.Tensor, meta: FeatureMeta,
              feature_mask: torch.Tensor, params: GrowParams,
              forced: ForcedSplits = None, cegb: Cegb = None
              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one leaf-wise tree; returns (tree on the host, per-row leaf id
    on the device).

    xb [N, C] uint8 stored columns; grad, hess, sample_mask [N] float32
    on the same device, cast to ``params.hist_dtype`` here (the JAX
    package's cast, grow.py:615-617 there: under f64 the histograms, the
    split search, the bounds and the device tree are float64 and the tree
    is rounded to float32 once, in ``tree_to_host``); feature_mask [F]
    bool. ``forced`` splits the
    first steps as the forced-splits file says; ``cegb`` holds the CEGB
    state the tree starts from, which it does not modify: the tree works
    on a copy and leaves it in ``cegb.grown``.
    """
    n = xb.shape[0]
    l = params.num_leaves
    b = params.num_bins
    sp = params.split
    dev = xb.device
    hdt = torch.float64 if params.hist_dtype == "f64" else torch.float32

    vals = stack_vals(grad.to(hdt), hess.to(hdt), sample_mask.to(hdt))
    state = None
    if cegb is not None:
        state = cegb.state._replace(
            feature_used=cegb.state.feature_used.clone(),
            row_used=cegb.state.row_used.clone())
    # split values stay on the device; the structure is host ints, which
    # replace the device tree's structure fields when the tree is done
    tree, best, _ = root_split(xb, vals, meta, feature_mask, params, state)
    left_child = np.full(l - 1, -1, np.int32)
    right_child = np.full(l - 1, -1, np.int32)
    split_leaf = np.full(l - 1, -1, np.int32)
    leaf_parent = np.full(l, -1, np.int32)
    leaf_depth = np.zeros(l, np.int32)
    part = init_partition(n, l, dev)
    # index tensors of the two children, made without a host-to-device copy
    slot_ids = torch.arange(l, device=dev)
    if sp.with_monotone:
        leaf_min = torch.full((l,), float("-inf"), dtype=hdt, device=dev)
        leaf_max = torch.full((l,), float("inf"), dtype=hdt, device=dev)
    num_forced = min(len(forced.leaf), l - 1) if forced is not None else 0
    if num_forced:
        forced_feature = device_index(forced.feature, dev)
        forced_threshold = device_index(forced.threshold, dev)
        # a row range of ``order`` holding each leaf's rows, known to the
        # host: the range read for the leaf's parent when it split
        known_begin = np.zeros(l, np.int64)
        known_count = np.zeros(l, np.int64)
        known_count[0] = n

    num_leaves = 1
    for t in range(l - 1):
        # one device-to-host read per split; indexing with a 0-d tensor
        # would read it back on its own, so every lookup is index_select
        leaf_t = torch.argmax(best.gain).view(1)
        gain_t = best.gain.index_select(0, leaf_t)
        in_forced = t < num_forced
        if in_forced:
            fleaf = forced.leaf[t]
            hist_f = hist_for_leaf(part, slot_ids[fleaf:fleaf + 1],
                                   int(known_begin[fleaf]),
                                   int(known_count[fleaf]), xb, vals, b,
                                   params.hist_impl, params.plain_sums)
            fcur, use_forced = forced_split_info(
                hist_f, forced_feature[t], forced_threshold[t], meta, params)
            leaf_t = torch.where(use_forced, slot_ids[fleaf:fleaf + 1],
                                 leaf_t)
            gain_t = torch.where(use_forced, fcur.gain, gain_t)
        read = [leaf_t, (gain_t > 0.0).to(torch.int64),
                part.leaf_begin.index_select(0, leaf_t),
                part.leaf_count.index_select(0, leaf_t)]
        if in_forced:
            read.append(use_forced.to(torch.int64))
        leaf, valid, begin, count, *took = torch.cat(read).tolist()
        if not valid:        # the reference stops on gain <= 0 (:217-219)
            break
        if took and took[0]:
            cur = fcur
        else:
            # a forced split that is not usable ends the forced phase
            # (aborted_last_force_split)
            num_forced = min(num_forced, t)
            cur = BestSplit(*[a[leaf] for a in best])
        right_leaf = t + 1
        if num_forced:
            known_begin[[leaf, right_leaf]] = begin
            known_count[[leaf, right_leaf]] = count
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
            params.hist_impl, params.plain_sums)

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

        # ---- the children's output bounds (:993-1000 of the JAX package)
        ch_min = ch_max = None
        if sp.with_monotone:
            l_min, l_max, r_min, r_max = propagate_monotone_bounds(
                meta.monotone.index_select(0, feat)[0], cur.left_output,
                cur.right_output, leaf_min[leaf], leaf_max[leaf])
            ch_min = torch.stack([l_min, r_min])
            ch_max = torch.stack([l_max, r_max])
            leaf_min[children] = ch_min
            leaf_max[children] = ch_max

        # ---- CEGB: the split buys its feature, and under lazy costs the
        # in-bag rows of the split leaf pay for it (:1002-1015 there) ------
        pen = None
        if state is not None:
            state.feature_used.index_fill_(0, feat, True)
            unpaid = None
            if params.with_cegb_lazy:
                rows = part.order[begin:begin + count]   # left rows first
                mask = vals.index_select(0, rows)[:, 2]
                flat = state.row_used.view(-1)
                at = feat * n + rows
                flat.index_copy_(0, at, torch.maximum(
                    flat.index_select(0, at), (mask > 0).to(flat.dtype)))
                w = mask[None, :] * (1.0 - state.row_used.index_select(
                    1, rows).to(mask.dtype))                  # [F, count]
                is_left = (torch.arange(count, device=dev)
                           < part.leaf_count[leaf:leaf + 1])
                unpaid = torch.stack([(w * is_left).sum(dim=1),
                                      (w * ~is_left).sum(dim=1)])
            pen = cegb_gain_penalty(params, state, torch.stack(
                [cur.left_count, cur.right_count]), unpaid)

        # ---- best splits of both children, one batched search -----------
        ch_g = torch.stack([cur.left_sum_grad, cur.right_sum_grad])
        ch_h = torch.stack([cur.left_sum_hess, cur.right_sum_hess])
        ch_c = torch.stack([cur.left_count, cur.right_count])
        b2 = find_best_split(
            expand_hist(torch.stack([hist_left, hist_right]), ch_g, ch_h,
                        ch_c, meta, params),
            meta, sp, ch_g, ch_h, ch_c, feature_mask, ch_min, ch_max, pen)
        if 0 < params.max_depth <= depth:
            b2 = b2._replace(gain=torch.full_like(b2.gain, K_MIN_SCORE))
        _set_best(best, children, b2)

    if cegb is not None:
        cegb.grown.append(state)
    leaf_id = leaf_id_from_partition(part, n, l)
    return tree_to_host(tree, num_leaves)._replace(
        left_child=left_child, right_child=right_child,
        split_leaf=split_leaf, leaf_parent=leaf_parent,
        leaf_depth=leaf_depth), leaf_id
