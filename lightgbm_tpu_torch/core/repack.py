"""Stable in-tile row partition: the plain version and the kernel dispatch.

The port of ``lightgbm_tpu/core/repack_pallas.py`` ``partition_tiles``:
every ``row_tile`` tile of byte-packed rows is partitioned stably, its
go-left rows first and its go-right rows after them, each in their order,
and each tile's go-left count comes back beside the rows. The result is
exact: bytes are moved, never computed on.

The JAX package calls the function from no grower (its docstring names it
as the future permutation step of partitioned batched growth), so neither
does the port: the function is its own entry point. ``impl`` is dispatched
as in ``core/histogram.py``: the CUDA kernel (``core/csrc/repack.cu``) for
a CUDA tensor under ``auto``, the plain version otherwise, and never a
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernels
from .histogram import HIST_IMPLS


def partition_tiles_plain(rows: torch.Tensor, go_left: torch.Tensor,
                          row_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: each row's position from a per-tile ``cumsum`` of
    go_left, then one ``index_copy_``. rows [N, C]; go_left [N] bool."""
    n = rows.shape[0]
    t = n // row_tile
    gl = go_left.reshape(t, row_tile)
    lefts = gl.to(torch.int64).cumsum(dim=1)           # inclusive
    n_left = lefts[:, -1:]
    i = torch.arange(row_tile, device=rows.device)
    # a go-right row at i has i - lefts[i] go-right rows before it
    pos = torch.where(gl, lefts - 1, n_left + i - lefts)
    dest = (pos + torch.arange(t, device=rows.device)[:, None] * row_tile)
    out = torch.empty_like(rows).index_copy_(0, dest.reshape(-1), rows)
    return out, n_left.reshape(t).to(torch.int32)


def partition_tiles(rows: torch.Tensor, go_left: torch.Tensor,
                    row_tile: int = 512, impl: str = "auto"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stably partition every ``row_tile`` tile of byte-packed rows.

    rows [N, C] uint8 (N divisible by row_tile, C by 128, as the JAX
    function asks); go_left [N] bool, or numbers where > 0 means left.
    Returns (rows [N, C] uint8 with each tile's go-left rows first, left
    counts [N / row_tile] int32)."""
    if impl not in HIST_IMPLS:
        raise ValueError("partition impl must be one of %s, got %r"
                         % ("/".join(HIST_IMPLS), impl))
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("rows must be a 2-D uint8 tensor, got %s %s"
                         % (rows.dtype, tuple(rows.shape)))
    n, c = rows.shape
    if row_tile < 1 or n % row_tile:
        raise ValueError("the row count %d must be a multiple of row_tile "
                         "%d" % (n, row_tile))
    if c % 128:
        raise ValueError("the payload width %d must be a multiple of 128"
                         % c)
    if tuple(go_left.shape) != (n,):
        raise ValueError("go_left must have shape [%d], got %s"
                         % (n, tuple(go_left.shape)))
    gl = go_left if go_left.dtype == torch.bool else go_left > 0
    if impl == "auto" and rows.device.type == "cuda":
        return kernels.partition_tiles_cuda(rows.contiguous(),
                                            gl.contiguous(), row_tile)
    return partition_tiles_plain(rows, gl, row_tile)
