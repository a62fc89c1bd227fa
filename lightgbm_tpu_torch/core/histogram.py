"""Gradient histograms: the plain PyTorch version and the kernel dispatch.

The port of ``lightgbm_tpu/core/histogram.py`` (``build_histogram``,
``hist_tile_vals``) and of the entry points of
``lightgbm_tpu/core/histogram_pallas.py`` (``build_histogram_pallas``,
``build_histogram_pallas_vals``). Every function computes

    hist[f, b, k] = sum_n [xb[n, f] == b] * vals[n, k]          [F, B, K]

with K = 3 channels (grad*mask, hess*mask, mask) for one histogram, or
K = 6 for both children of a split (``core/partition.py``).

``impl`` mirrors the JAX package's ``tpu_hist_impl`` switch:

- ``"auto"``: the CUDA kernel (``core/kernels.py``) for a CUDA tensor, the
  plain version for a CPU tensor;
- ``"plain"``: the plain version on any device (chip_smoke.py runs it on
  the card to compare the two paths).

A CUDA tensor never falls back to the plain version when the kernel fails:
the kernel's error propagates.
"""
from __future__ import annotations

import torch

from . import kernels

HIST_IMPLS = ("auto", "plain")


def hist_plain(xb: torch.Tensor, vals: torch.Tensor,
               num_bins: int) -> torch.Tensor:
    """Plain version: one flat ``index_add_`` over ``f * B + xb[n, f]``.

    xb [n, F] uint8 with every bin < num_bins; vals [n, K] float ->
    [F, B, K] in the dtype of ``vals``.
    """
    n, f = xb.shape
    k = vals.shape[1]
    offs = torch.arange(f, device=xb.device, dtype=torch.int64) * num_bins
    flat = (xb.to(torch.int64) + offs).reshape(-1)
    src = vals.unsqueeze(1).expand(n, f, k).reshape(n * f, k)
    hist = torch.zeros((f * num_bins, k), dtype=vals.dtype, device=xb.device)
    hist.index_add_(0, flat, src)
    return hist.reshape(f, num_bins, k)


def _use_kernel(impl: str, xb: torch.Tensor) -> bool:
    if impl not in HIST_IMPLS:
        raise ValueError("histogram impl must be one of %s, got %r"
                         % ("/".join(HIST_IMPLS), impl))
    return impl == "auto" and xb.device.type == "cuda"


def hist_tile_vals(xb_rows: torch.Tensor, vals: torch.Tensor, num_bins: int,
                   impl: str = "auto") -> torch.Tensor:
    """[rows, F] bins + pre-stacked [rows, K] values -> [F, B, K] (the
    fused two-child pass of ``core/partition.py`` gives K = 6)."""
    if _use_kernel(impl, xb_rows):
        return kernels.build_histogram_cuda(xb_rows, vals, num_bins)
    return hist_plain(xb_rows, vals, num_bins)


def stack_vals(grad: torch.Tensor, hess: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """[N, 3] (grad*mask, hess*mask, mask), the row layout every histogram
    pass reads (the ordered-gradients copy, dataset.cpp
    ConstructHistograms)."""
    m = mask.to(grad.dtype)
    return torch.stack([grad * m, hess * m, m], dim=1).contiguous()


def build_histogram(xb: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                    mask: torch.Tensor, num_bins: int,
                    impl: str = "auto") -> torch.Tensor:
    """(grad, hess, count) histograms of every feature over all rows:
    xb [N, F] uint8; grad, hess, mask [N] float32 -> [F, B, 3]."""
    return hist_tile_vals(xb, stack_vals(grad, hess, mask), num_bins, impl)
