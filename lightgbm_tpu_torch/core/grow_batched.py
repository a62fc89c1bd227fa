"""Batched growth: split the top-K leaves of the frontier per step.

The port of ``lightgbm_tpu/core/grow_batched.py`` (``tree_growth=batched``)
for one device, categorical features included, and the wave bookkeeping
that it shares with the frontier grower
(``core/grow_frontier.py``): ``wave_plan``, ``wave_route``,
``interleave_lr``, ``apply_split_wave``, ``search_children`` and
``scatter_child_best``.

Each step ranks the leaves by best gain, commits up to K = ``batch_splits``
of the positive ones at once, routes every row through its leaf's split
by per-row gathers of the split's descriptor (``wave_route``, as the
frontier grower does), builds all 2K children's histograms in one
pass, and searches the 2K children in one batched ``find_best_split``.
Histograms stay over the stored columns; with EFB bundles or packed pairs
the routing decodes each row's stored byte and ``search_children`` expands
the children's column histograms into per-feature views first (JAX
``core/grow_batched.py:169-205, 280-290``); a categorical split routes a
row by its bin's bit in the split's bitset.
This is approximate best-first; K = 1 is the exact algorithm, node
numbering included: rank ``i`` of a step with ``nl`` leaves makes node
``nl - 1 + i`` and right leaf ``nl + i`` (tree.cpp:49-67 when one leaf
splits).

The children's histograms come from the parent-slot pass by default:
``hist_slots6`` (the port of ``_hist_slot6_kernel``) with each active row
carrying its parent's rank and a go-left selector, giving both children's
channels at once. With ``batched_pack`` (``tpu_batched_pack``) the slot
pass (the port of ``_hist_slot_kernel``) runs over 2K child slots instead.
The JAX package's Pallas branch packs the active rows first so its tiles
can skip the rest; the CUDA slot kernel sorts the active rows by slot
itself and skips slot -1, so the port passes the rows as they are. The
slot count of either pass is the number of committed splits, which the
host knows, so the output holds no empty slots.

Eager steps, one read each. The JAX loop is a ``lax.while_loop`` whose
masked lanes write nowhere. Here each step reads one integer back, the
number of leaves with positive gain. The committed lanes are then a prefix
of the gain ranking whose length the host knows, ``min(live, K, L - nl)``,
so every per-lane array is cut to that prefix and written with plain
index writes to distinct leaves and nodes: nothing else is read back and
no lane needs a mask. The ranking is a stable descending sort, which keeps
``lax.top_k``'s order among equal gains (lower leaf first); ``torch.topk``
leaves that order unspecified on CUDA.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .grow import (DeviceTree, GrowParams, TreeArrays, _bin_go_left,
                   decode_bundle_value, expand_hist,
                   propagate_monotone_bounds, root_split, tree_to_host)
from .histogram import hist_slots, hist_slots6, stack_vals
from .split import (BestSplit, CAT_WORDS, FeatureMeta, K_MIN_SCORE,
                    calculate_leaf_output, find_best_split)


def rank_leaves(gain: torch.Tensor, count: int) -> torch.Tensor:
    """The ``count`` leaves of highest gain, in descending gain and, among
    equal gains, ascending leaf index (``lax.top_k``'s order)."""
    return torch.sort(gain, descending=True, stable=True).indices[:count]


def interleave_lr(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[K] left + [K] right per-split values -> [2K] L, R, L, R, ...: the
    lane order of the children's batched split search."""
    return torch.stack([a, c], dim=1).reshape(-1)


class WavePlan(NamedTuple):
    gleaf: torch.Tensor         # [K] split leaves, gain-ranked
    node: torch.Tensor          # [K] their new nodes
    right_leaf: torch.Tensor    # [K] their new right leaves
    cur: BestSplit              # [K] their best splits
    rank_of_leaf: torch.Tensor  # [L] rank of each leaf, -1 = not splitting


def wave_plan(best: BestSplit, num_leaves: int, k: int) -> WavePlan:
    """The wave's bookkeeping that reads no rows: the ``k`` committed
    leaves (the gain-ranked prefix), their numbering and split records,
    and the leaf -> rank map."""
    dev = best.gain.device
    gleaf = rank_leaves(best.gain, k)
    rank = torch.arange(k, device=dev)
    rank_of_leaf = torch.full((best.gain.shape[0],), -1, dtype=torch.int64,
                              device=dev)
    rank_of_leaf[gleaf] = rank
    return WavePlan(gleaf=gleaf, node=rank + (num_leaves - 1),
                    right_leaf=rank + num_leaves,
                    cur=BestSplit(*[a.index_select(0, gleaf) for a in best]),
                    rank_of_leaf=rank_of_leaf)


def wave_route(xb: torch.Tensor, leaf_id: torch.Tensor, plan: WavePlan,
               meta: FeatureMeta, with_efb: bool = False,
               with_cat: bool = False):
    """Route every row through its leaf's split. Returns (new leaf_id,
    active [N] bool: the row's leaf splits, rs [N] its split's rank,
    go_left [N])."""
    r_r = plan.rank_of_leaf.index_select(0, leaf_id)
    active = r_r >= 0
    rs = r_r.clamp(min=0)
    go_left = _route_rows_gather(xb, rs, plan.cur, meta, with_efb, with_cat)
    new_leaf_id = torch.where(active & ~go_left,
                              plan.right_leaf.index_select(0, rs), leaf_id)
    return new_leaf_id, active, rs, go_left


def _route_rows_gather(xb: torch.Tensor, rs: torch.Tensor, cur: BestSplit,
                       meta: FeatureMeta, with_efb: bool = False,
                       with_cat: bool = False) -> torch.Tensor:
    """Per-row go-left decisions by per-row gathers of each row's split
    descriptor. xb [N, C] stored columns; rs [N] per-row split rank into
    ``cur`` (0 for rows in no splitting leaf, whose answer the caller
    masks). With ``with_efb`` the split feature's stored column is read
    and decoded into its own bin; with ``with_cat`` a categorical split
    reads its bitset word for each row's bin, one [N] gather from the
    flat [K * 8] words (JAX ``core/grow_batched.py:170-212``)."""
    fk = cur.feature.index_select(0, rs)                      # [N]
    stored_col = meta.col.index_select(0, fk) if with_efb else fk
    colv = torch.gather(xb, 1, stored_col[:, None])[:, 0]
    num_bin_r = meta.num_bin.index_select(0, fk)
    default_bin_r = meta.default_bin.index_select(0, fk)
    if with_efb:
        colv = decode_bundle_value(
            colv, meta.offset.index_select(0, fk), num_bin_r, default_bin_r,
            meta.pack_div.index_select(0, fk),
            meta.pack_mod.index_select(0, fk))
    cat_args = ()
    if with_cat:
        words = cur.cat_bitset.reshape(-1)
        cat_args = (cur.is_categorical.index_select(0, rs),
                    lambda wi: words.index_select(0, rs * CAT_WORDS + wi))
    return _bin_go_left(colv, cur.threshold.index_select(0, rs),
                        cur.default_left.index_select(0, rs),
                        meta.missing_type.index_select(0, fk), num_bin_r,
                        default_bin_r, *cat_args)


def apply_split_wave(tree: DeviceTree, leaf_min: torch.Tensor,
                     leaf_max: torch.Tensor, cur: BestSplit,
                     gleaf: torch.Tensor, node: torch.Tensor,
                     right_leaf: torch.Tensor, num_leaves: int,
                     meta: FeatureMeta, sp, max_depth: int) -> torch.Tensor:
    """Commit one wave of K splits to the device tree (Tree::Split x K,
    tree.cpp:49-67) and propagate the monotone bounds, in place.

    Lanes are committed splits only: ``gleaf`` [K] the split leaves,
    ``node`` [K] their new nodes, ``right_leaf`` [K] their new right
    leaves, ``cur`` their best splits; ``num_leaves`` the leaf count before
    the wave. Returns ``ch_ok`` [2K], in interleaved child order: whether
    each child may split again under ``max_depth``.
    """
    depth = tree.leaf_depth.index_select(0, gleaf) + 1
    if num_leaves > 1:
        # re-point each split leaf's parent at the new node. Two siblings
        # may split in one wave, so both pointers are written through one
        # [L-1, 2] table in which every (parent, side) target is distinct
        parent = tree.leaf_parent.index_select(0, gleaf)
        was_left = tree.left_child.index_select(0, parent) == ~gleaf
        children = torch.stack([tree.left_child, tree.right_child], dim=1)
        children.view(-1)[parent * 2 + (~was_left).to(torch.int64)] = node
        tree.left_child.copy_(children[:, 0])
        tree.right_child.copy_(children[:, 1])
    tree.left_child[node] = ~gleaf
    tree.right_child[node] = ~right_leaf
    tree.split_feature[node] = cur.feature
    tree.threshold_bin[node] = cur.threshold
    tree.default_left[node] = cur.default_left
    tree.missing_type[node] = meta.missing_type.index_select(0, cur.feature)
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
    tree.split_leaf[node] = gleaf

    both = torch.cat([gleaf, right_leaf])
    tree.leaf_value[both] = torch.cat([cur.left_output, cur.right_output])
    tree.leaf_weight[both] = torch.cat([cur.left_sum_hess,
                                        cur.right_sum_hess])
    tree.leaf_count[both] = torch.cat([cur.left_count, cur.right_count])
    tree.leaf_parent[both] = torch.cat([node, node])
    tree.leaf_depth[both] = torch.cat([depth, depth])

    # monotone constraints are outside the slice (every feature is 0), so
    # the bounds stay (-inf, inf); they are carried for Queue 1 #4
    mono = torch.zeros_like(cur.feature)
    l_min, l_max, r_min, r_max = propagate_monotone_bounds(
        mono, cur.left_output, cur.right_output,
        leaf_min.index_select(0, gleaf), leaf_max.index_select(0, gleaf))
    leaf_min[both] = torch.cat([l_min, r_min])
    leaf_max[both] = torch.cat([l_max, r_max])

    depth_ok = (depth < max_depth) if max_depth > 0 \
        else torch.ones_like(depth, dtype=torch.bool)
    return interleave_lr(depth_ok, depth_ok)


def search_children(ch_hist: torch.Tensor, cur: BestSplit, ch_ok, meta,
                    params: GrowParams, feature_mask) -> BestSplit:
    """Best splits of the 2K children's column histograms [2K, C, B, 3]
    (interleaved), expanded to per-feature views first, in one batched
    search; a child past ``max_depth`` gets gain -inf."""
    sg = interleave_lr(cur.left_sum_grad, cur.right_sum_grad)
    sh = interleave_lr(cur.left_sum_hess, cur.right_sum_hess)
    cnt = interleave_lr(cur.left_count, cur.right_count)
    b2k = find_best_split(expand_hist(ch_hist, sg, sh, cnt, meta, params),
                          meta, params.split, sg, sh, cnt, feature_mask)
    return b2k._replace(gain=torch.where(ch_ok, b2k.gain, K_MIN_SCORE))


def scatter_child_best(best: BestSplit, b2k: BestSplit, gleaf: torch.Tensor,
                       right_leaf: torch.Tensor) -> None:
    """De-interleave the children's searches onto the per-leaf table, in
    place: the left child keeps the parent's leaf, the right child takes
    its new leaf."""
    both = torch.cat([gleaf, right_leaf])
    for arr, v in zip(best, b2k):
        arr[both] = torch.cat([v[0::2], v[1::2]])


def grow_tree_batched(xb: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, sample_mask: torch.Tensor,
                      meta: FeatureMeta, feature_mask: torch.Tensor,
                      params: GrowParams
                      ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree, splitting up to ``params.batch_splits`` frontier
    leaves per step; returns (tree on the host, per-row leaf id on the
    device), as ``grow.grow_tree``."""
    n, c = xb.shape
    l = params.num_leaves
    b = params.num_bins
    sp = params.split
    dev = xb.device
    kb = max(1, min(params.batch_splits, l - 1))

    vals = stack_vals(grad, hess, sample_mask)                # [N, 3]
    tree, best, _ = root_split(xb, vals, meta, feature_mask, params)
    leaf_min = torch.full((l,), float("-inf"), device=dev)
    leaf_max = torch.full((l,), float("inf"), device=dev)
    leaf_id = torch.zeros(n, dtype=torch.int64, device=dev)

    nl = 1
    while nl < l:
        live = int((best.gain > 0.0).sum())     # the step's one read
        if live == 0:
            break
        k = min(live, kb, l - nl)
        plan = wave_plan(best, nl, k)
        leaf_id, active, rs, go_left = wave_route(
            xb, leaf_id, plan, meta, params.with_efb,
            bool(sp.cat_features))

        # ---- all 2k children's histograms in one pass -------------------
        if params.batched_pack:
            slot = rs * 2 + (~go_left).to(torch.int64)       # child slot
            ch_hist = hist_slots(xb, torch.where(active, slot, -1)
                                 .to(torch.int32), vals, b, 2 * k,
                                 params.hist_impl, params.plain_f64_sums)
        else:
            h6 = hist_slots6(xb, torch.where(active, rs, -1).to(torch.int32),
                             go_left.to(torch.float32), vals, b, k,
                             params.hist_impl,
                             params.plain_f64_sums)          # [k, C, B, 6]
            ch_hist = torch.stack([h6[..., :3], h6[..., 3:]],
                                  dim=1).reshape(2 * k, c, b, 3)

        ch_ok = apply_split_wave(tree, leaf_min, leaf_max, plan.cur,
                                 plan.gleaf, plan.node, plan.right_leaf, nl,
                                 meta, sp, params.max_depth)
        scatter_child_best(best, search_children(ch_hist, plan.cur, ch_ok,
                                                 meta, params, feature_mask),
                           plan.gleaf, plan.right_leaf)
        nl += k
    return tree_to_host(tree, nl), leaf_id
