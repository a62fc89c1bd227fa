"""Device RenewTreeOutput: per-leaf weighted-percentile leaf refit.

The port of ``lightgbm_tpu/core/renew.py`` (the reference's
SerialTreeLearner::RenewTreeOutput, serial_tree_learner.cpp:850-928, with
the objectives' percentile functions, regression_objective.hpp:20-75).
L1, quantile and MAPE replace each leaf's value after growth by a weighted
percentile of its rows' residuals. All leaves go at once, as one segmented
weighted percentile on the device:

- rows sort once by (leaf, residual): a stable sort on the residual, then
  a stable sort on the leaf id;
- each leaf's weighted CDF is a slice of one global float32 ``cumsum``
  (exact for integer weights up to 2**24 in all);
- every leaf's target ``seg_lo + alpha * (seg_hi - seg_lo)`` is found in
  that CDF by one ``searchsorted`` and clamped to the leaf's segment.

The value is the first sorted residual of the leaf whose cumulative weight
reaches ``alpha`` of the leaf's total, the JAX package's lower-percentile
rule. Nothing here reads the device from the host.
"""
from __future__ import annotations

import torch


def renew_leaf_values(resid: torch.Tensor, weight: torch.Tensor,
                      leaf_id: torch.Tensor, mask: torch.Tensor,
                      num_leaves: int, alpha: float,
                      orig_leaf_value: torch.Tensor) -> torch.Tensor:
    """[L] renewed leaf values: the weighted ``alpha``-percentile of
    ``resid`` over each leaf's masked rows; a leaf without rows keeps
    ``orig_leaf_value``.

    resid, weight [N] float32; leaf_id [N] integer; mask [N] (bool, or
    float where nonzero means the row takes part: the bagging mask);
    orig_leaf_value [L] float32.
    """
    n, dev = resid.shape[0], resid.device
    active = mask if mask.dtype == torch.bool else mask > 0
    # masked-out rows sort past every real leaf's segment
    lid = torch.where(active, leaf_id.to(torch.int64),
                      torch.full_like(leaf_id, num_leaves, dtype=torch.int64))
    w_eff = torch.where(active, weight, torch.zeros_like(weight))
    # (leaf, residual) order. Rows that tie on both keys may come in any
    # order: the cumulative weight at the end of a run of equal residuals
    # is the same whatever their order, so the residual picked is too.
    by_resid = torch.sort(resid, stable=True).indices
    by_leaf = torch.sort(lid.index_select(0, by_resid), stable=True).indices
    order = by_resid.index_select(0, by_leaf)
    srt_lid = lid.index_select(0, order)
    srt_resid = resid.index_select(0, order)
    cw = torch.cumsum(w_eff.index_select(0, order), 0)
    leaves = torch.arange(num_leaves, device=dev)
    begin = torch.searchsorted(srt_lid, leaves, side="left")
    end = torch.searchsorted(srt_lid, leaves, side="right")     # exclusive
    zero = torch.zeros((), dtype=cw.dtype, device=dev)
    seg_lo = torch.where(begin > 0, cw[(begin - 1).clamp(min=0)], zero)
    seg_hi = torch.where(end > 0, cw[(end - 1).clamp(min=0)], zero)
    # the global CDF is each segment's CDF shifted by seg_lo, so one
    # searchsorted serves every leaf
    target = seg_lo + alpha * (seg_hi - seg_lo)
    pos = torch.searchsorted(cw, target, side="left")
    pos = torch.minimum(torch.maximum(pos, begin),
                        torch.maximum(end - 1, begin))
    val = srt_resid[pos.clamp(0, max(n - 1, 0))]
    return torch.where(end > begin, val, orig_leaf_value)
