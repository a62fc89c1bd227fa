"""Partitioned batched growth: the top-K leaves per step over rows kept
grouped by leaf (``tree_growth=batched`` with ``tpu_batched_part=true``).

The port of ``lightgbm_tpu/core/grow_batched_part.py`` for one device,
categorical features included. The algorithm is batched growth's
(``core/grow_batched.py``: the same ranking, node numbering, wave commit,
routing and child search, which this module reuses); only the layout of
the rows differs, so only the order of the additions inside a histogram
does.

The rows live in a column-major ``[C, Np]`` copy of the stored columns and a
``[3, Np]`` copy of the values, grouped by leaf into segments that start on
a ``PART_TILE``-row boundary (the DataPartition invariant,
data_partition.hpp:20-37): every row tile belongs to at most one leaf. Each
step

- ranks the leaves and commits the first ``k = min(live, K, L - nl)`` of
  them, as ``grow_tree_batched`` does (one read a step, the live count);
- routes every row through its leaf's split with a per-row gather of its
  split feature's stored byte (``xb_fm[col, row]``), decoded into the
  feature's bin where EFB bundles or packed pairs share columns;
- builds both children of every splitting leaf in one pass over the OLD
  layout, with each tile taking its leaf's slot (``hist_part_tiles``, the
  port of ``_hist_part_kernel``): tiles of leaves that do not split are
  skipped, so the pass reads only the splitting leaves' rows;
- moves every row to its place in the new layout: one cumsum of the
  go-left rows gives each split leaf's left count and each row's rank, the
  new segments start at tile boundaries, and one gather of the bins, the
  values, the leaf ids and the original row ids applies the permutation.

Padding rows carry leaf -1, zero values and original row -1. Rows that a
sample mask leaves out still travel through the layout with zero values,
so their leaf ids stay right for the score update. The JAX loop writes
with ``mode="drop"`` scatters, which torch does not have: the port
scatters into a buffer one element longer, sends pads to the spare index
and cuts it off.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .grow import GrowParams, TreeArrays, root_split, tree_to_host
from .grow_batched import (_route_rows_gather, apply_split_wave,
                           scatter_child_best, search_children, wave_plan)
from .histogram import hist_part_tiles, stack_vals
from .split import FeatureMeta

PART_TILE = 2048   # the kernel's row tile and the segments' alignment


def _local_slot_mask(slot_vals: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[n_slots] bool: which slots appear in ``slot_vals``. A negative entry
    or one past the last slot marks nothing (it goes to a spare index that
    is cut off, never wrapped onto the last slot)."""
    ok = (slot_vals >= 0) & (slot_vals < n_slots)
    idx = torch.where(ok, slot_vals.to(torch.int64), n_slots)
    mask = torch.zeros(n_slots + 1, dtype=torch.bool, device=slot_vals.device)
    # index_fill_ takes the value as a scalar: no host-to-device copy
    return mask.index_fill_(0, idx, True)[:n_slots]


def _part_capacity(n: int, num_leaves: int, tile: int) -> int:
    """Padded row capacity: every leaf segment rounded up to a tile fits,
    and the last row is always padding (the permutation's default
    source)."""
    return -(-n // tile) * tile + (num_leaves + 1) * tile


def grow_tree_batched_part(xb: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, sample_mask: torch.Tensor,
                           meta: FeatureMeta, feature_mask: torch.Tensor,
                           params: GrowParams
                           ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree as ``grow_tree_batched`` does over the partitioned
    layout; returns (tree on the host, per-row leaf id on the device, in
    the original row order)."""
    n, c = xb.shape
    l = params.num_leaves
    b = params.num_bins
    sp = params.split
    dev = xb.device
    kb = max(1, min(params.batch_splits, l - 1))
    tile = PART_TILE
    np_cap = _part_capacity(n, l, tile)
    i64 = dict(dtype=torch.int64, device=dev)

    vals = stack_vals(grad, hess, sample_mask)                # [N, 3]
    tree, best, _ = root_split(xb, vals, meta, feature_mask, params)
    leaf_min = torch.full((l,), float("-inf"), device=dev)
    leaf_max = torch.full((l,), float("inf"), device=dev)

    # ---- the first layout: leaf 0 holds rows [0, n) ----------------------
    xb_fm = torch.zeros((c, np_cap), dtype=torch.uint8, device=dev)
    xb_fm[:, :n] = xb.t()
    vals3 = torch.zeros((3, np_cap), dtype=torch.float32, device=dev)
    vals3[:, :n] = vals.t()
    ar = torch.arange(np_cap, **i64)
    row_leaf = torch.where(ar < n, 0, -1)                     # -1: padding
    orig = torch.where(ar < n, ar, -1)
    leaf_begin = torch.zeros(l, **i64)
    leaf_count = torch.where(torch.arange(l, **i64) == 0, n, 0)

    nl = 1
    while nl < l:
        live = int((best.gain > 0.0).sum())     # the step's one read
        if live == 0:
            break
        k = min(live, kb, l - nl)
        plan = wave_plan(best, nl, k)
        gleaf, right_leaf = plan.gleaf, plan.right_leaf

        # ---- each row's slot (its leaf's rank) and go-left --------------
        safe_rl = row_leaf.clamp(0, l - 1)
        slot_r = torch.where(row_leaf >= 0,
                             plan.rank_of_leaf.index_select(0, safe_rl), -1)
        active = slot_r >= 0
        rs = slot_r.clamp(min=0)
        go_left = _route_rows_gather(xb_fm.t(), rs, plan.cur, meta,
                                     params.with_efb,
                                     bool(sp.cat_features))

        # ---- segmented left counts from one cumsum ----------------------
        gl_cum = torch.cumsum((active & go_left).to(torch.int64), 0)
        beg = leaf_begin.index_select(0, gleaf)               # [k]
        cnt = leaf_count.index_select(0, gleaf)
        base_l = torch.where(beg > 0, gl_cum.index_select(
            0, (beg - 1).clamp(min=0)), 0)
        end_i = (beg + cnt - 1).clamp(0, np_cap - 1)
        n_left = torch.where(cnt > 0, gl_cum.index_select(0, end_i) - base_l,
                             0)
        counts_new = leaf_count.clone()
        counts_new[gleaf] = n_left
        counts_new[right_leaf] = cnt - n_left

        # ---- the new tile-aligned layout --------------------------------
        seg_tiles = -(-counts_new // tile)
        begin_new = (torch.cumsum(seg_tiles, 0) - seg_tiles) * tile
        base_l_r = base_l.index_select(0, rs)
        right_r = right_leaf.index_select(0, rs)
        own_begin = begin_new.index_select(0, safe_rl)
        lrank = gl_cum - 1 - base_l_r
        rrank = (ar - beg.index_select(0, rs)) - (gl_cum - base_l_r)
        pos = torch.where(
            active,
            torch.where(go_left, own_begin + lrank,
                        begin_new.index_select(0, right_r) + rrank),
            own_begin + (ar - leaf_begin.index_select(0, safe_rl)))
        pos = torch.where(row_leaf >= 0, pos, np_cap)         # pads drop
        row_leaf_new = torch.where(active & ~go_left, right_r, row_leaf)

        # ---- all 2k children's histograms over the OLD layout -----------
        slot_at = slot_r[::tile]                              # [T]
        prev = torch.cat([slot_at.new_full((1,), -2), slot_at[:-1]])
        first = (slot_at >= 0) & (slot_at != prev)
        h6 = hist_part_tiles(xb_fm, go_left.to(torch.float32), vals3,
                             slot_at, first, b, k, tile, params.hist_impl,
                             params.plain_sums)               # [k, C, B, 6]
        ch_hist = torch.stack([h6[..., :3], h6[..., 3:]],
                              dim=1).reshape(2 * k, c, b, 3)
        # both routes zero a slot with no tile, so this mask changes nothing
        # on one device; it is the mask a data-parallel shard needs before
        # its histograms are summed across devices
        keep2 = _local_slot_mask(slot_at, k).repeat_interleave(2)
        ch_hist = torch.where(keep2[:, None, None, None], ch_hist, 0.0)

        # ---- apply the permutation (DataPartition::Split) ---------------
        perm = torch.full((np_cap + 1,), np_cap - 1, **i64)
        perm[pos] = ar
        perm = perm[:np_cap]
        xb_fm = xb_fm.index_select(1, perm)
        vals3 = vals3.index_select(1, perm)
        row_leaf = row_leaf_new.index_select(0, perm)
        orig = orig.index_select(0, perm)
        leaf_begin, leaf_count = begin_new, counts_new

        # ---- the wave's tree bookkeeping and its children's search
        # (expanded to per-feature views first, JAX :118-130, 198) ------
        ch_ok = apply_split_wave(tree, leaf_min, leaf_max, plan.cur, gleaf,
                                 plan.node, right_leaf, nl, meta, sp,
                                 params.max_depth)
        scatter_child_best(best, search_children(ch_hist, plan, ch_ok, meta,
                                                 params, feature_mask,
                                                 leaf_min, leaf_max),
                           gleaf, right_leaf)
        nl += k

    # ---- per-row leaf ids in the original row order ----------------------
    leaf_id = torch.zeros(n + 1, **i64)
    leaf_id[torch.where(orig >= 0, orig, n)] = row_leaf.clamp(min=0)
    return tree_to_host(tree, nl), leaf_id[:n]
