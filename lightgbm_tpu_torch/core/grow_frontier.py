"""Frontier-wave growth: O(depth) passes over the rows per tree.

The port of ``lightgbm_tpu/core/grow_frontier.py`` (``tree_growth=frontier``)
for one device, one class, the serial learner, categorical features and
packed bin words included (``tpu_bin_packing``: the stored matrix as int32
words, ``core/binpack.py``, which both histogram kernels read in place and
routing gathers one code a row from). Each wave splits every frontier leaf whose
best split has positive gain, ranked by gain (rank ``i`` of a wave with
``nl`` leaves makes node ``nl - 1 + i`` and right leaf ``nl + i``, the
numbering of ``core/grow_batched.py``), until the tree has ``num_leaves``
leaves:

- every row is routed through its leaf's split by per-row gathers of the
  split's descriptor (``_route_rows_gather``, ``wave_route``);
- one slot-histogram pass (``hist_slots``, the port of
  ``_hist_slot_kernel``) builds the histogram of every split's smaller
  child, each row carrying its split's rank iff it lands in the smaller
  child (``wave_slots``);
- the larger sibling is the parent's histogram, kept in a per-leaf pool
  ``[L, C, B, 3]`` over the stored columns, minus the smaller one
  (``derive_child_hists``);
- the 2K children are searched in one batched ``find_best_split``
  (``wave_commit``), their column histograms expanded to per-feature
  views just before it where EFB bundles or packed pairs share columns
  (JAX ``core/grow_frontier.py:139-170``); the routing decodes the
  stored bytes (``:202-235``).

A 255-leaf tree takes about as many waves as its depth, instead of 254
split steps. When the leaf cap never binds, the splits are those of exact
best-first growth (each leaf's best split depends only on its own rows).

The JAX ``lax.while_loop`` over waves, with a ``lax.switch`` into a wave
compiled at each rung of a power-of-two width ladder, becomes a Python
loop over waves. Each wave reads one integer back: the number of leaves
with positive gain. From it the host knows how many splits the wave
commits, ``k = min(live, L - nl)``, which is also the slot count of the
wave's histogram pass, and stops when nothing is live or the tree is
full. The ladder exists to bound the JAX package's compiled programs; an
eager wave needs none, so ``tpu_frontier_bucketing`` is accepted and
changes nothing. Its cap on the widest wave, ``2^(max_depth - 1)``, never
binds either: a leaf at ``max_depth`` has no positive gain, and a tree
has at most ``2^(d - 1)`` leaves shallower than ``d``. Everything else
stays on the device, with the lanes cut to the committed prefix of the
ranking as in ``core/grow_batched.py``.

Multiclass (ROADMAP Queue 1 #2) calls this grower once a class, in class
order (``boosting/gbdt.py``). The JAX package's class-batched
``grow_tree_frontier_classes`` is not ported and needs no port: its
docstring states that each class's structure equals its solo run, and
sequential growth is that run.

Streamed growth (``stream/grow_stream.py``) runs the same wave over chunks
from ``frontier_state``. Not ported: ``wave_hist_entry`` and
``wave_fused_entry`` (the JAX cost model's pricing entries) and the
learners of a device mesh. The JAX package's model-statistics accumulator
is not needed: ``obs/modelstats.py`` reads the host trees. Its health
accumulator is ``GrowerHealth``: the waves counted on the host, where the
loop is, and the non-finite committed gain kept as a device max.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .grow import DeviceTree, GrowParams, TreeArrays, root_split, tree_to_host
from .grow_batched import (WavePlan, apply_split_wave, scatter_child_best,
                           search_children, wave_plan, wave_route)
from .histogram import hist_slots, stack_vals
from .split import BestSplit, FeatureMeta


class GrowerHealth:
    """What one frontier tree reports to the health vector
    (``obs/health.py``): ``waves`` run, counted on the host, and
    ``bad_gain``, a float32 device scalar that becomes 1 when a wave
    commits a non-finite gain (the JAX package's ``(waves,
    nonfinite_gain)`` carry)."""

    def __init__(self, device: torch.device):
        self.waves = 0
        self.bad_gain = torch.zeros((), dtype=torch.float32, device=device)

    def commit(self, gain: torch.Tensor) -> None:
        """One wave committing the splits of ``gain`` [k]."""
        self.waves += 1
        torch.maximum(self.bad_gain,
                      (~torch.isfinite(gain)).any().to(torch.float32),
                      out=self.bad_gain)


class FrontierState(NamedTuple):
    leaf_id: torch.Tensor     # [N] int64
    hist_pool: torch.Tensor   # [L, C, B, 3] per-leaf column histograms
    best: BestSplit           # per-leaf best split, fields [L]
    tree: DeviceTree
    leaf_min: torch.Tensor    # [L] f32 monotone lower bound
    leaf_max: torch.Tensor    # [L] f32 monotone upper bound


def wave_slots(cur: BestSplit, active: torch.Tensor, go_left: torch.Tensor,
               rs: torch.Tensor):
    """Histogram slot of every row: its split's rank iff it lands in the
    smaller child, else -1 (the larger sibling comes from the pool). Returns
    (left_small [K] bool, slot [N] int32)."""
    left_small = cur.left_count <= cur.right_count
    in_small = active & (go_left == left_small.index_select(0, rs))
    return left_small, torch.where(in_small, rs, -1).to(torch.int32)


def derive_child_hists(parent_hist: torch.Tensor, hist_small: torch.Tensor,
                       left_small: torch.Tensor):
    """Sibling subtraction: [K, C, B, 3] smaller children + their parents
    -> (left [K, ...], right [K, ...], interleaved [2K, C, B, 3])."""
    hist_large = parent_hist - hist_small
    ls = left_small[:, None, None, None]
    hist_left = torch.where(ls, hist_small, hist_large)
    hist_right = torch.where(ls, hist_large, hist_small)
    ch_hist = torch.stack([hist_left, hist_right], dim=1).reshape(
        (-1,) + tuple(hist_left.shape[1:]))
    return hist_left, hist_right, ch_hist


def wave_commit(s: FrontierState, plan: WavePlan, num_leaves: int,
                left_small: torch.Tensor, hist_small: torch.Tensor,
                meta: FeatureMeta, params: GrowParams,
                feature_mask: torch.Tensor) -> None:
    """Everything after the wave's pass over the rows, in place: children
    from the pool, pool update, tree bookkeeping, and the 2K children's
    best splits."""
    hist_left, hist_right, ch_hist = derive_child_hists(
        s.hist_pool.index_select(0, plan.gleaf), hist_small, left_small)
    # the left child keeps the parent's leaf, the right child its new leaf
    s.hist_pool[plan.gleaf] = hist_left
    s.hist_pool[plan.right_leaf] = hist_right
    ch_ok = apply_split_wave(s.tree, s.leaf_min, s.leaf_max, plan.cur,
                             plan.gleaf, plan.node, plan.right_leaf,
                             num_leaves, meta, params.split,
                             params.max_depth)
    scatter_child_best(s.best, search_children(ch_hist, plan, ch_ok, meta,
                                               params, feature_mask,
                                               s.leaf_min, s.leaf_max),
                       plan.gleaf, plan.right_leaf)


def root_state(xb: torch.Tensor, vals: torch.Tensor, meta: FeatureMeta,
               feature_mask: torch.Tensor,
               params: GrowParams) -> FrontierState:
    """The state before the first wave: the root split, and the pool
    holding the root's histogram."""
    tree, best, hist_root = root_split(xb, vals, meta, feature_mask, params)
    return frontier_state(tree, best, hist_root, xb.shape[0], params)


def frontier_state(tree: DeviceTree, best: BestSplit,
                   hist_root: torch.Tensor, n: int,
                   params: GrowParams) -> FrontierState:
    """The state before the first wave from the root split: the pool
    holding the root's histogram, every one of the ``n`` rows in leaf 0."""
    l = params.num_leaves
    dev = hist_root.device
    pool = torch.zeros((l,) + tuple(hist_root.shape), dtype=torch.float32,
                       device=dev)
    pool[0] = hist_root
    return FrontierState(
        leaf_id=torch.zeros(n, dtype=torch.int64, device=dev),
        hist_pool=pool, best=best, tree=tree,
        leaf_min=torch.full((l,), float("-inf"), device=dev),
        leaf_max=torch.full((l,), float("inf"), device=dev))


def grow_tree_frontier(xb: torch.Tensor, grad: torch.Tensor,
                       hess: torch.Tensor, sample_mask: torch.Tensor,
                       meta: FeatureMeta, feature_mask: torch.Tensor,
                       params: GrowParams,
                       health: Optional[GrowerHealth] = None
                       ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree in frontier waves; returns (tree on the host, per-row
    leaf id on the device), as ``grow.grow_tree``. ``health``, where
    given, counts the waves and the non-finite committed gains."""
    l = params.num_leaves
    vals = stack_vals(grad, hess, sample_mask)                # [N, 3]
    s = root_state(xb, vals, meta, feature_mask, params)

    nl = 1
    while nl < l:
        live = int((s.best.gain > 0.0).sum())   # the wave's one read
        if live == 0:
            break
        k = min(live, l - nl)
        plan = wave_plan(s.best, nl, k)
        leaf_id, active, rs, go_left = wave_route(
            xb, s.leaf_id, plan, meta, params.with_efb,
            bool(params.split.cat_features), params.word_packed_cols)
        left_small, slot = wave_slots(plan.cur, active, go_left, rs)
        hist_small = hist_slots(xb, slot, vals, params.num_bins, k,
                                params.hist_impl, params.plain_sums,
                                params.word_packed_cols)      # [k, C, B, 3]
        s = s._replace(leaf_id=leaf_id)
        wave_commit(s, plan, nl, left_small, hist_small, meta, params,
                    feature_mask)
        if health is not None:
            health.commit(plan.cur.gain)
        nl += k
    return tree_to_host(s.tree, nl), s.leaf_id
