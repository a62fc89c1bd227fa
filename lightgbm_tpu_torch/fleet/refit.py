"""Structure-preserving refit: re-estimate leaf outputs on fresh data.

The port of ``lightgbm_tpu/fleet/refit.py`` (the reference's
``GBDT::RefitTree``, gbdt.cpp:263-286, and ``FitByExistingTree``): every
split of every tree is kept, only the leaf OUTPUTS are recomputed from the
new data's gradients, so the serving side can hot-roll the result with the
same node tables and new leaf values.

On the booster's device the packed ``FlatForest`` (serving/traversal.py)
routes ALL rows through ALL trees in one ``depth``-step traversal
(``forest_leaf_ids``: [N, T] leaf ids, float64 decisions, the port's
``predict``), then one loop over boosting iterations refreshes the
gradients from the running scores (once an iteration, before class 0) and
sums gradient and hessian per leaf:

    out  = -sign(G) * max(|G| - l1, 0) / (H + l2 + eps)    (per leaf)
    leaf = decay * old + (1 - decay) * out * tree_shrinkage

(CalculateSplittedLeafOutput, feature_histogram.hpp:454-462, then the
RefitTree decay blend), clipped by ``max_delta_step`` before the
shrinkage. Per-tree shrinkage, DART's per-tree weights included, is kept,
and padded leaf slots keep their old values.

The per-leaf sums are float64 and add each leaf's rows in a fixed order,
so a refit repeats itself bit for bit on the card: a window's leaf ids do
not change across iterations, so each tree's rows are sorted by leaf once
(``LeafLayout``), and every iteration sums fixed blocks of a leaf's sorted
rows and then the leaf's blocks, two ``sum`` reductions over padded
gathers (no atomics, unlike ``index_add_``). The blend is float64 against
the original doubles, as the host loop's (``Booster.refit`` with
``refit_device=false``), and only the running scores are float32:
``decay_rate=1.0`` gives back the old leaf tables byte for byte.
"""
from __future__ import annotations

import copy
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..io.dataset import Metadata
from ..log import check
from ..serving.traversal import forest_leaf_ids, pack_flat_forest, to_device

_EPS = 1e-15
# rows a first-level block of a leaf's sorted rows sums
LEAF_BLOCK_ROWS = 256


class LeafLayout(NamedTuple):
    """A tree's rows grouped by leaf for fixed-order sums: ``rows`` [B, R]
    indexes the value vector with one zero appended (index N pads), each
    row of it R consecutive rows of one leaf in row order; ``blocks`` [L,
    M] indexes the block sums with one zero appended, a leaf's blocks in
    order."""
    rows: torch.Tensor
    blocks: torch.Tensor


def leaf_layout(leaf: torch.Tensor, num_leaves: int,
                block: int = LEAF_BLOCK_ROWS) -> LeafLayout:
    """The ``LeafLayout`` of one tree's [N] leaf ids."""
    n = leaf.shape[0]
    dev = leaf.device
    order = torch.sort(leaf, stable=True).indices
    counts = torch.bincount(leaf, minlength=num_leaves)
    start = torch.cumsum(counts, 0) - counts
    nblk = (counts + block - 1) // block
    total = int(nblk.sum())
    blk_leaf = torch.repeat_interleave(torch.arange(num_leaves, device=dev),
                                       nblk)
    first_blk = torch.cumsum(nblk, 0) - nblk
    within = torch.arange(total, device=dev) - first_blk[blk_leaf]
    pos = (start[blk_leaf] + within * block)[:, None] \
        + torch.arange(block, device=dev)[None, :]
    valid = pos < (start + counts)[blk_leaf][:, None]
    rows = torch.where(valid, order[pos.clamp(max=max(n - 1, 0))],
                       torch.full_like(pos, n))
    width = max(int(nblk.max()) if num_leaves else 0, 1)
    slot = first_blk[:, None] + torch.arange(width, device=dev)[None, :]
    blocks = torch.where(torch.arange(width, device=dev)[None, :]
                         < nblk[:, None], slot, torch.full_like(slot, total))
    return LeafLayout(rows=rows, blocks=blocks)


def leaf_sums(values: torch.Tensor, layout: LeafLayout) -> torch.Tensor:
    """[L] float64 sum of ``values`` [N] over each leaf's rows, in the
    layout's fixed order."""
    v = torch.cat([values.to(torch.float64),
                   values.new_zeros(1, dtype=torch.float64)])
    per_block = v[layout.rows].sum(dim=1)
    per_block = torch.cat([per_block, per_block.new_zeros(1)])
    return per_block[layout.blocks].sum(dim=1)


def leaf_outputs(sg: np.ndarray, sh: np.ndarray, l1: float, l2: float,
                 max_delta_step: float, shrinkage: float):
    """CalculateSplittedLeafOutput of per-leaf gradient and hessian sums
    (float64 arrays or tensors), clipped and shrunk."""
    lib = torch if isinstance(sg, torch.Tensor) else np
    out = -lib.sign(sg) * lib.clip(lib.abs(sg) - l1, 0.0, None) \
        / (sh + l2 + _EPS)
    if max_delta_step > 0:
        out = lib.clip(out, -max_delta_step, max_delta_step)
    return out * shrinkage


def refit_metadata(n: int, label, weight=None, group=None) -> Metadata:
    """The fresh window's metadata, as the objective takes it."""
    from ..basic import _to_1d
    md = Metadata(n)
    md.set_label(_to_1d(label))
    if weight is not None:
        md.set_weight(_to_1d(weight))
    if group is not None:
        md.set_query(np.asarray(group, np.int64))
    return md


def refit_objective(booster):
    """The booster's objective, copied (its per-row tensors are re-bound by
    ``init`` on every window); raises for a custom objective."""
    impl = booster._impl
    check(impl is not None and len(impl.models) > 0,
          "Cannot refit: no trained model")
    check(impl.objective is not None,
          "Cannot refit a model trained with a custom objective")
    return copy.deepcopy(impl.objective)


def refitted_booster(device: torch.device, model_str: str, old_trees: List,
                     new_leaves: List[np.ndarray]):
    """A booster of ``model_str`` on ``device`` whose trees are
    ``old_trees`` with their first ``len(new_leaves[i])`` leaf values
    replaced (float64)."""
    from ..basic import Booster
    trees = []
    for ht, vals in zip(old_trees, new_leaves):
        nh = copy.deepcopy(ht)
        nh.leaf_value = np.array(ht.leaf_value, np.float64, copy=True)
        nh.leaf_value[:len(vals)] = vals
        trees.append(nh)
    out = Booster(model_str=model_str, device=device)
    out._impl.models = trees
    return out


class Refitter:
    """Device refitter bound to one model's structure.

    Packs the forest once; each :meth:`refit` call routes a fresh data
    window through it and returns a new ``Booster`` with identical tree
    structures and re-estimated leaf values. Hold the instance across
    cycles (the fleet's refit worker does) to pack once."""

    def __init__(self, booster):
        self._obj = refit_objective(booster)
        impl = booster._impl
        self._model_str = booster.model_to_string()
        self._models = list(impl.models)
        self.device = booster.device
        self.k = max(int(impl.num_tree_per_iteration), 1)
        self.iterations = len(self._models) // self.k
        forest, self.depth = pack_flat_forest(self._models)
        self._forest = to_device(forest, self.device)
        self._nl = [int(getattr(t, "num_leaves_actual", t.num_leaves))
                    for t in self._models]
        self._old64 = [torch.as_tensor(
            np.asarray(t.leaf_value, np.float64)[:nl], device=self.device)
            for t, nl in zip(self._models, self._nl)]
        self._shrink = [float(getattr(t, "shrinkage", 1.0))
                        for t in self._models]
        cfg = booster.config
        self._decay_default = float(cfg.refit_decay_rate)
        self._l1 = float(cfg.lambda_l1)
        self._l2 = float(cfg.lambda_l2)
        self._mds = float(cfg.max_delta_step)
        # the last window's routing and timings (route_s, loop_s), read by
        # callers that time the two halves
        self.last_timing = {}

    def route(self, x: np.ndarray) -> torch.Tensor:
        """[N, T] leaf ids of float64 rows ``x`` on the refitter's device."""
        xt = torch.as_tensor(np.ascontiguousarray(x, np.float64),
                             device=self.device)
        return forest_leaf_ids(self._forest, xt, self.depth)

    def refit(self, data, label, decay_rate: Optional[float] = None,
              weight=None, group=None):
        """One refit cycle: returns a NEW Booster, structure-identical to
        the bound model, with leaf values re-estimated on ``data``."""
        from ..basic import _to_2d_float
        x = _to_2d_float(data)
        n = x.shape[0]
        decay = self._decay_default if decay_rate is None \
            else float(decay_rate)
        self._obj.init(refit_metadata(n, label, weight, group), self.device)
        t0 = time.perf_counter()
        leaves = self.route(x)
        layouts = [leaf_layout(leaves[:, t], nl)
                   for t, nl in enumerate(self._nl)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        new = self._loop(leaves, layouts, decay)
        new_np = [v.cpu().numpy() for v in new]
        t2 = time.perf_counter()
        self.last_timing = {"route_s": t1 - t0, "loop_s": t2 - t1}
        return refitted_booster(self.device, self._model_str, self._models,
                                new_np)

    def _loop(self, leaves: torch.Tensor, layouts: List[LeafLayout],
              decay: float) -> List[torch.Tensor]:
        """The loop over iterations: one gradient refresh an iteration
        from the running float32 scores, then each class's tree's leaf
        sums, outputs and float64 blend; returns each tree's new leaf
        values (float64, ``num_leaves_actual`` of them)."""
        n, k = leaves.shape[0], self.k
        scores = torch.zeros((n, k), dtype=torch.float32, device=self.device)
        new = []
        for it in range(self.iterations):
            if k == 1:
                g, h = self._obj.get_gradients(scores[:, 0])
                g, h = g.reshape(-1, 1), h.reshape(-1, 1)
            else:
                g, h = self._obj.get_gradients(scores)
            for c in range(k):
                t = it * k + c
                out = leaf_outputs(leaf_sums(g[:, c], layouts[t]),
                                   leaf_sums(h[:, c], layouts[t]),
                                   self._l1, self._l2, self._mds,
                                   self._shrink[t])
                vals = decay * self._old64[t] + (1.0 - decay) * out
                new.append(vals)
                scores[:, c] += vals.to(torch.float32)[leaves[:, t]]
        return new


def refit_booster(booster, data, label, decay_rate: Optional[float] = None,
                  weight=None, group=None):
    """One-shot device refit (``Booster.refit`` dispatches here for dense
    inputs); build a :class:`Refitter` directly to pack the forest once
    across repeated cycles."""
    return Refitter(booster).refit(data, label, decay_rate=decay_rate,
                                   weight=weight, group=group)
