"""Row partition on the device: per-leaf contiguous ranges of row ids.

The port of ``lightgbm_tpu/core/partition.py`` (DataPartition,
data_partition.hpp:20-37 of the reference). ``order`` holds the row ids
grouped by leaf; ``leaf_begin`` / ``leaf_count`` give each leaf's range.
Splitting a leaf is one pass over its rows that both partitions the range
and builds the histograms of both children through six value channels
(``partition_and_hist``).

Where the JAX path walks a leaf in fixed ``row_chunk`` tiles inside a
``lax.while_loop``, PyTorch runs eagerly and the caller knows the leaf's
row count on the host, so one gather and one histogram launch cover the
whole range. The placement is the JAX path's scatter placement: rows going
left fill the range from its start in their order, rows going right fill
it from its end backwards. The resulting ``order``, ``leaf_begin`` and
``leaf_count`` are identical to the chunked walk's, whatever its chunk.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .histogram import hist_leaf_vals, hist_tile_vals


class RowPartition(NamedTuple):
    order: torch.Tensor       # [N] int64 row ids grouped by leaf
    leaf_begin: torch.Tensor  # [L] int64
    leaf_count: torch.Tensor  # [L] int64


def init_partition(num_data: int, num_leaves: int,
                   device: torch.device) -> RowPartition:
    order = torch.arange(num_data, dtype=torch.int64, device=device)
    leaf_begin = torch.zeros(num_leaves, dtype=torch.int64, device=device)
    leaf_count = torch.zeros(num_leaves, dtype=torch.int64, device=device)
    leaf_count[0] = num_data
    return RowPartition(order, leaf_begin, leaf_count)


def partition_and_hist(part: RowPartition, leaf: int, right_leaf: int,
                       begin: int, count: int, xb: torch.Tensor,
                       vals: torch.Tensor,
                       go_left_from_rows: Callable[[torch.Tensor],
                                                   torch.Tensor],
                       num_bins: int, impl: str, sums: str = "running",
                       xb_hist: torch.Tensor = None
                       ) -> Tuple[RowPartition, torch.Tensor, torch.Tensor]:
    """Split ``leaf`` (rows ``order[begin:begin + count]``) into ``leaf``
    and ``right_leaf`` and price both children in the same pass.

    xb [N, F] uint8 bins and vals [N, 3] (grad*mask, hess*mask, mask) of
    every row; ``go_left_from_rows(rows [count, F]) -> bool [count]`` is
    the split decision on the gathered bin bytes. The partition is updated
    in place. Returns (part, hist_left [F, B, 3], hist_right [F, B, 3]).

    ``xb_hist`` (default ``xb``) is the matrix the histograms read, a
    rank's own columns under feature-parallel. A leaf without rows here
    (a rank's shard may hold none) prices both children at zero.
    """
    xb_hist = xb if xb_hist is None else xb_hist
    if count == 0:
        part.leaf_begin[right_leaf] = begin
        part.leaf_count[right_leaf] = 0
        zero = vals.new_zeros((xb_hist.shape[1], num_bins, 3))
        return part, zero, zero.clone()
    idx = part.order[begin:begin + count]
    rows = xb.index_select(0, idx)                           # [count, F]
    v = vals.index_select(0, idx)                            # [count, 3]
    go_left = go_left_from_rows(rows)
    is_l = go_left.to(v.dtype)[:, None]
    v6 = torch.cat([v * is_l, v * (1.0 - is_l)], dim=1)      # [count, 6]
    hist = hist_tile_vals(rows if xb_hist is xb
                          else xb_hist.index_select(0, idx), v6, num_bins,
                          impl, sums)

    # left rows keep their order from the front of the range; right rows
    # fill it from the end backwards (the JAX scatter placement)
    cl = torch.cumsum(go_left, dim=0)
    j = torch.arange(1, count + 1, device=idx.device)
    n_left = cl[-1]
    pos = torch.where(go_left, begin + cl - 1, begin + count - (j - cl))
    new_range = torch.empty_like(idx)
    new_range[pos - begin] = idx
    part.order[begin:begin + count] = new_range
    part.leaf_begin[right_leaf] = begin + n_left
    part.leaf_count[leaf] = n_left
    part.leaf_count[right_leaf] = count - n_left
    return part, hist[:, :, :3], hist[:, :, 3:]


def hist_for_leaf(part: RowPartition, leaf: torch.Tensor, begin: int,
                  count: int, xb: torch.Tensor, vals: torch.Tensor,
                  num_bins: int, impl: str, sums: str = "running"
                  ) -> torch.Tensor:
    """[F, B, 3] (grad, hess, count) histogram of one leaf's rows (the JAX
    package's ``hist_for_leaf``, core/partition.py:282), for a forced split.

    ``leaf`` [1] is the leaf on the device; ``order[begin:begin + count]``
    is a range the host knows to hold its rows (its own, or its parent's
    before the split that made it). The range's rows are gathered and
    those outside the leaf's own range (``leaf_begin``, ``leaf_count`` on
    the device) add zeros, so the host need not read the leaf's range. One
    K=3 pass (``hist_leaf_vals``: histogram.cu's kernel on the card).
    An empty range (a rank's shard may hold none of the leaf's rows)
    gives zeros.
    """
    if count == 0:
        return vals.new_zeros((xb.shape[1], num_bins, 3))
    idx = part.order[begin:begin + count]
    rows = xb.index_select(0, idx)                           # [count, F]
    v = vals.index_select(0, idx)                            # [count, 3]
    pos = torch.arange(begin, begin + count, device=idx.device)
    lb = part.leaf_begin.index_select(0, leaf)
    inside = (pos >= lb) & (pos < lb + part.leaf_count.index_select(0, leaf))
    v = torch.where(inside[:, None], v, v.new_zeros(()))
    return hist_leaf_vals(rows, v, num_bins, impl, sums)


def leaf_id_from_partition(part: RowPartition, num_data: int,
                           num_leaves: int) -> torch.Tensor:
    """Per-row leaf id from the final ranges: the ranges tile [0, N), so
    position -> leaf is a search over the sorted begins, and row -> leaf is
    one scatter through ``order``."""
    dev = part.order.device
    begins = torch.where(part.leaf_count > 0, part.leaf_begin,
                         torch.full_like(part.leaf_begin, num_data + 1))
    sort_begins, sort_leaf = torch.sort(begins, stable=True)
    pos = torch.arange(num_data, dtype=torch.int64, device=dev)
    block = torch.searchsorted(sort_begins, pos, right=True) - 1
    pos_leaf = sort_leaf[block.clamp(0, num_leaves - 1)]
    leaf_id = torch.empty(num_data, dtype=torch.int64, device=dev)
    leaf_id[part.order] = pos_leaf
    return leaf_id
