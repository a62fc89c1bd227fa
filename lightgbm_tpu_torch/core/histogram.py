"""Gradient histograms: the plain PyTorch version and the kernel dispatch.

The port of ``lightgbm_tpu/core/histogram.py`` (``build_histogram``,
``hist_tile_vals``) and of the entry points of
``lightgbm_tpu/core/histogram_pallas.py`` (``build_histogram_pallas``,
``build_histogram_pallas_vals``). Every function computes

    hist[f, b, k] = sum_n [xb[n, f] == b] * vals[n, k]          [F, B, K]

with K = 3 channels (grad*mask, hess*mask, mask) for one histogram, or
K = 6 for both children of a split (``core/partition.py``). The wave
growers (``core/grow_frontier.py``, ``core/grow_batched.py``) add a slot
axis, ``[S, F, B, K]`` in one pass, from
``lightgbm_tpu/core/histogram.py`` ``build_histogram_frontier`` and the
slot kernels' entry points (``build_histogram_slots``,
``build_histogram_slots6``). The partitioned batched grower
(``core/grow_batched_part.py``) takes the slot of each row from its row
tile instead (``hist_part_tiles``, from ``build_histogram_part_tiles``).

``impl`` mirrors the JAX package's ``tpu_hist_impl`` switch:

- ``"auto"``: the CUDA kernel (``core/kernels.py``) for a CUDA tensor, the
  plain version for a CPU tensor; float64 values (``gpu_use_dp``, exact
  growth only) go to histogram.cu's float64 variant, through wrappers of
  their own (``build_histogram_f64_cuda``, ``build_histogram_leaf_f64_cuda``);
- ``"plain"``: the plain version on any device (chip_smoke.py runs it on
  the card to compare the two paths).

A CUDA tensor never falls back to the plain version when the kernel fails:
the kernel's error propagates.

``packed_cols`` > 0 (``tpu_bin_packing``, ``core/binpack.py``): ``xb`` is
int32 [N, W] packed words holding that many code columns. The kernels read
the words in place (``build_histogram_words_cuda``,
``build_histogram_slots_words_cuda``, counted apart from the uint8
wrappers); the plain versions unpack them first, then sum as for the uint8
matrix, so both give the histograms of the unpacked codes.

``sums`` sets how a plain version adds a cell's rows
(``GrowParams.plain_sums``; internal, not a ``Config`` parameter; the
kernels ignore it):

- ``"running"`` (the default): one ``index_add_``, a single running sum
  per cell, as the JAX package's CPU scatter path is. On a cell of a
  million float32 rows that sum drifts by 1e-2 relative, where the
  kernels, which sum in blocks, and float64 sums agree.
- ``"blocked"``: each cell's rows, in row order, in runs of
  ``BLOCK_ROWS`` rows landing in that cell, the runs' sums added in order.
  A cell of fewer rows is the running sum; a cell of hundreds of
  thousands of rows (the default bin of a bundled column) no longer
  drifts from float64 as far as a small fault moves a histogram.
  chip_smoke.py's phase 5 holds the kernels' float32 paths to it.
- ``"f64"``: accumulate in float64 and round to the values' dtype at the
  end. It changes nothing for float64 values.
"""
from __future__ import annotations

import torch

from . import kernels
from .binpack import unpack_words

HIST_IMPLS = ("auto", "plain")
PLAIN_SUMS = ("running", "blocked", "f64")
BLOCK_ROWS = 16_384


def _add_cells(flat: torch.Tensor, src: torch.Tensor, cells: int,
               sums: str) -> torch.Tensor:
    """[cells, K] sums of the rows of ``src`` [m, K] into the cells
    ``flat`` [m] names: one ``index_add_``, or under ``"blocked"`` each
    cell's rows (in order) in runs of ``BLOCK_ROWS``, the runs' sums added
    in order."""
    if sums != "blocked":
        hist = torch.zeros((cells, src.shape[1]), dtype=src.dtype,
                           device=src.device)
        return hist.index_add_(0, flat, src)
    sorted_cells, order = torch.sort(flat, stable=True)
    pos = torch.arange(len(flat), device=flat.device)
    first = torch.ones_like(sorted_cells, dtype=torch.bool)
    first[1:] = sorted_cells[1:] != sorted_cells[:-1]
    run = torch.empty_like(pos)
    run[order] = (pos - torch.cummax(torch.where(first, pos, 0), 0).values
                  ) // BLOCK_ROWS
    runs = int(run.max()) + 1 if len(run) else 1
    hist = torch.zeros((runs * cells, src.shape[1]), dtype=src.dtype,
                       device=src.device)
    hist.index_add_(0, run * cells + flat, src)
    hist = hist.view(runs, cells, src.shape[1])
    out = hist[0]
    for r in range(1, runs):
        out = out + hist[r]
    return out


def _sums(vals: torch.Tensor, sums: str) -> torch.Tensor:
    if sums not in PLAIN_SUMS:
        raise ValueError("plain sums must be one of %s, got %r"
                         % ("/".join(PLAIN_SUMS), sums))
    return vals.double() if sums == "f64" else vals


def hist_plain(xb: torch.Tensor, vals: torch.Tensor, num_bins: int,
               sums: str = "running") -> torch.Tensor:
    """Plain version: one flat ``index_add_`` over ``f * B + xb[n, f]``.

    xb [n, F] uint8 with every bin < num_bins; vals [n, K] float ->
    [F, B, K] in the dtype of ``vals``, summed as
    ``sums`` says (``PLAIN_SUMS``).
    """
    n, f = xb.shape
    k = vals.shape[1]
    offs = torch.arange(f, device=xb.device, dtype=torch.int64) * num_bins
    flat = (xb.to(torch.int64) + offs).reshape(-1)
    acc = _sums(vals, sums)
    src = acc.unsqueeze(1).expand(n, f, k).reshape(n * f, k)
    hist = _add_cells(flat, src, f * num_bins, sums)
    return hist.reshape(f, num_bins, k).to(vals.dtype)


def _use_kernel(impl: str, xb: torch.Tensor) -> bool:
    if impl not in HIST_IMPLS:
        raise ValueError("histogram impl must be one of %s, got %r"
                         % ("/".join(HIST_IMPLS), impl))
    return impl == "auto" and xb.device.type == "cuda"


def hist_tile_vals(xb_rows: torch.Tensor, vals: torch.Tensor, num_bins: int,
                   impl: str = "auto", sums: str = "running",
                   packed_cols: int = 0) -> torch.Tensor:
    """[rows, F] bins + pre-stacked [rows, K] values -> [F, B, K] (the
    fused two-child pass of ``core/partition.py`` gives K = 6), in the
    values' dtype (float32, or float64 under ``gpu_use_dp``). With
    ``packed_cols`` the bins are packed words (float32 values)."""
    if packed_cols:
        if _use_kernel(impl, xb_rows):
            return kernels.build_histogram_words_cuda(xb_rows, vals,
                                                      num_bins, packed_cols)
        return hist_plain(unpack_words(xb_rows, packed_cols), vals,
                          num_bins, sums)
    if _use_kernel(impl, xb_rows):
        if vals.dtype == torch.float64:
            return kernels.build_histogram_f64_cuda(xb_rows, vals, num_bins)
        return kernels.build_histogram_cuda(xb_rows, vals, num_bins)
    return hist_plain(xb_rows, vals, num_bins, sums)


def hist_leaf_vals(xb_rows: torch.Tensor, vals: torch.Tensor,
                   num_bins: int, impl: str = "auto",
                   sums: str = "running") -> torch.Tensor:
    """``hist_tile_vals`` for one leaf's rebuilt histogram (a forced split,
    ``core/partition.py`` ``hist_for_leaf``): the same kernel, launched
    through its own wrapper so its launches are counted apart from the
    split pass's."""
    if _use_kernel(impl, xb_rows):
        if vals.dtype == torch.float64:
            return kernels.build_histogram_leaf_f64_cuda(xb_rows, vals,
                                                         num_bins)
        return kernels.build_histogram_leaf_cuda(xb_rows, vals, num_bins)
    return hist_plain(xb_rows, vals, num_bins, sums)


def stack_vals(grad: torch.Tensor, hess: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """[N, 3] (grad*mask, hess*mask, mask), the row layout every histogram
    pass reads (the ordered-gradients copy, dataset.cpp
    ConstructHistograms)."""
    m = mask.to(grad.dtype)
    return torch.stack([grad * m, hess * m, m], dim=1).contiguous()


def build_histogram(xb: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                    mask: torch.Tensor, num_bins: int,
                    impl: str = "auto", packed_cols: int = 0
                    ) -> torch.Tensor:
    """(grad, hess, count) histograms of every feature over all rows:
    xb [N, F] uint8 (or int32 [N, W] words of ``packed_cols`` = F code
    columns); grad, hess, mask [N] float32 -> [F, B, 3]."""
    return hist_tile_vals(xb, stack_vals(grad, hess, mask), num_bins, impl,
                          packed_cols=packed_cols)


# ---- per-slot histograms (the wave growers) ------------------------------
#
#     hist[s, f, b, k] = sum_n [min(slot[n], S-1) == s] [xb[n, f] == b] v[n, k]
#
# with slot -1 (any negative) marking a row that adds nothing, as the TPU
# slot kernels clamp and mask (histogram_pallas.py:234, :475).


def hist_slots_plain(xb: torch.Tensor, slot: torch.Tensor,
                     vals: torch.Tensor, num_bins: int,
                     num_slots: int, sums: str = "running") -> torch.Tensor:
    """Plain version: one ``index_add_`` over ``slot*F*B + f*B + bin``.
    Inactive rows go to one spare slot past the end that is dropped, so
    nothing is read back to pick the active rows.

    xb [n, F] uint8 with every bin < num_bins; slot [n] int; vals [n, K]
    -> [S, F, B, K] in the dtype of ``vals``, summed as
    ``sums`` says (``PLAIN_SUMS``).
    """
    n, f = xb.shape
    k = vals.shape[1]
    s = torch.where(slot >= 0, slot.to(torch.int64).clamp(max=num_slots - 1),
                    num_slots)
    offs = torch.arange(f, device=xb.device, dtype=torch.int64) * num_bins
    flat = ((s * (f * num_bins))[:, None] + offs + xb.to(torch.int64))
    acc = _sums(vals, sums)
    src = acc.unsqueeze(1).expand(n, f, k).reshape(n * f, k)
    hist = _add_cells(flat.reshape(-1), src, (num_slots + 1) * f * num_bins,
                      sums)
    return hist[:num_slots * f * num_bins].reshape(
        num_slots, f, num_bins, k).to(vals.dtype)


def hist_slots6_plain(xb: torch.Tensor, slot: torch.Tensor, sel: torch.Tensor,
                      vals3: torch.Tensor, num_bins: int,
                      num_slots: int, sums: str = "running") -> torch.Tensor:
    """Plain version of the parent-slot pass: channels vals3 * sel then
    vals3 * (1 - sel), both children of every parent slot ->
    [S, F, B, 6]."""
    s = sel.to(vals3.dtype)[:, None]
    return hist_slots_plain(xb, slot, torch.cat([vals3 * s, vals3 * (1.0 - s)],
                                                dim=1), num_bins, num_slots,
                            sums)


def hist_slots(xb: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor,
               num_bins: int, num_slots: int, impl: str = "auto",
               sums: str = "running", packed_cols: int = 0) -> torch.Tensor:
    """[N, F] bins + [N] slot ids + stacked [N, 3] values -> [S, F, B, 3]:
    the slot kernel for a CUDA tensor under ``auto``, else the plain
    version. With ``packed_cols`` the bins are packed words."""
    if packed_cols:
        if _use_kernel(impl, xb):
            return kernels.build_histogram_slots_words_cuda(
                xb, slot.to(torch.int32).contiguous(), vals, num_bins,
                num_slots, packed_cols)
        return hist_slots_plain(unpack_words(xb, packed_cols), slot, vals,
                                num_bins, num_slots, sums)
    if _use_kernel(impl, xb):
        return kernels.build_histogram_slots_cuda(
            xb, slot.to(torch.int32).contiguous(), vals, num_bins, num_slots)
    return hist_slots_plain(xb, slot, vals, num_bins, num_slots, sums)


def hist_slots6(xb: torch.Tensor, slot: torch.Tensor, sel: torch.Tensor,
                vals3: torch.Tensor, num_bins: int, num_slots: int,
                impl: str = "auto", sums: str = "running") -> torch.Tensor:
    """Parent slots + go-left selector -> [S, F, B, 6] (left channels,
    then right), dispatched as ``hist_slots``."""
    if _use_kernel(impl, xb):
        return kernels.build_histogram_slots6_cuda(
            xb, slot.to(torch.int32).contiguous(),
            sel.to(torch.float32).contiguous(), vals3, num_bins, num_slots)
    return hist_slots6_plain(xb, slot, sel, vals3, num_bins, num_slots,
                             sums)


def hist_part_tiles_plain(xb_fm: torch.Tensor, sel: torch.Tensor,
                          vals3: torch.Tensor, tile_slot: torch.Tensor,
                          tile_first: torch.Tensor, num_bins: int,
                          n_slots: int, row_tile: int,
                          sums: str = "running") -> torch.Tensor:
    """Plain version of the partitioned-layout pass: every row takes its
    tile's slot, then the parent-slot pass runs over the row-major view.
    ``tile_first`` is implied by ``tile_slot`` and not read."""
    row_slot = tile_slot.repeat_interleave(row_tile)
    return hist_slots6_plain(xb_fm.t(), row_slot, sel, vals3.t(), num_bins,
                             n_slots, sums)


def hist_part_tiles(xb_fm: torch.Tensor, sel: torch.Tensor,
                    vals3: torch.Tensor, tile_slot: torch.Tensor,
                    tile_first: torch.Tensor, num_bins: int, n_slots: int,
                    row_tile: int, impl: str = "auto",
                    sums: str = "running"
                    ) -> torch.Tensor:
    """Both children of every splitting leaf over the partitioned layout
    (``build_histogram_part_tiles``, histogram_pallas.py:327), in the JAX
    layout: xb_fm [F, Np] uint8 feature-major, rows grouped into
    ``row_tile``-aligned leaf segments (Np a multiple of row_tile); sel
    [Np] go-left selector; vals3 [3, Np] (g*m, h*m, m); tile_slot [T]
    each tile's slot in [0, S) or -1 (tile skipped), every slot's tiles
    one contiguous run; tile_first [T] the first tile of each run ->
    [S, F, B, 6], channels vals3 * sel then vals3 * (1 - sel).

    A slot that owns no tile comes out zero on both routes. That is
    stricter than the TPU kernel, which leaves such a slot's block
    uninitialised. Dispatched as ``hist_slots``."""
    if _use_kernel(impl, xb_fm):
        return kernels.build_histogram_part_tiles_cuda(
            xb_fm, sel.to(torch.float32).contiguous(), vals3,
            tile_slot.to(torch.int32).contiguous(),
            tile_first.to(torch.int32).contiguous(), num_bins, n_slots,
            row_tile)
    return hist_part_tiles_plain(xb_fm, sel, vals3, tile_slot, tile_first,
                                 num_bins, n_slots, row_tile, sums)


def build_histogram_frontier(xb: torch.Tensor, slot: torch.Tensor,
                             grad: torch.Tensor, hess: torch.Tensor,
                             mask: torch.Tensor, num_bins: int,
                             num_slots: int, impl: str = "auto",
                             packed_cols: int = 0) -> torch.Tensor:
    """Histograms of every live frontier leaf in one pass over the rows
    (``lightgbm_tpu/core/histogram.py:189``): slot [N] in [0, num_slots)
    or -1; grad, hess, mask [N] float32 -> [num_slots, F, B, 3]
    (sum_grad, sum_hess, count); xb packed words with ``packed_cols``."""
    return hist_slots(xb, slot, stack_vals(grad, hess, mask), num_bins,
                      num_slots, impl, packed_cols=packed_cols)
