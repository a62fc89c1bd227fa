"""ctypes bindings of the hand-written CUDA kernels.

Each wrapper checks what its kernel takes (device, dtype, shape,
contiguity) and raises on anything else, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream, raises when the
launch reports a CUDA error, and counts its launches in a plain integer
attribute (``<wrapper>.launches``) so a run can show that its main path
went through the kernel. The library is built from ``core/csrc`` at first
use (``device.load_library``); nothing is built when this module is
imported.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..device import current_stream, load_library

HIST_LIBRARY = ("lgbt_histogram", ["histogram.cu"])
# every library of the port: {name: source files under core/csrc}
LIBRARIES = dict([HIST_LIBRARY])
HIST_SMEM_BUDGET = 48 * 1024     # bytes of shared memory per block
HIST_MIN_ROWS_PER_BLOCK = 1024   # below this a block is mostly set-up
HIST_MAX_ROW_BLOCKS = 256        # caps the [R, F, B, K] partial scratch

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _hist_lib() -> ctypes.CDLL:
    lib = load_library(*HIST_LIBRARY)
    if not getattr(lib, "_lgbt_bound", False):
        lib.lgbt_hist_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
            _c_void_p]
        lib.lgbt_hist_launch.restype = _c_int
        lib.lgbt_error_string.argtypes = [_c_int]
        lib.lgbt_error_string.restype = ctypes.c_char_p
        lib._lgbt_bound = True
    return lib


def hist_launch_plan(n: int, num_features: int, num_bins: int, k: int,
                     sm_count: int) -> Tuple[int, int, int]:
    """(feature_tile, row_blocks, rows_per_block) for one histogram call:
    the widest feature tile whose [Ft, B, K] f32 sub-histogram fits the
    shared-memory budget, then enough row slices to give the card about
    four blocks per SM, none shorter than HIST_MIN_ROWS_PER_BLOCK rows."""
    ft = max(1, min(num_features, HIST_SMEM_BUDGET // (num_bins * k * 4)))
    tiles = -(-num_features // ft)
    r = min(max(1, -(-n // HIST_MIN_ROWS_PER_BLOCK)),
            max(1, -(-4 * sm_count // tiles)), HIST_MAX_ROW_BLOCKS)
    rows_per_block = max(1, -(-n // r))
    return ft, r, rows_per_block


def build_histogram_cuda(xb: torch.Tensor, vals: torch.Tensor,
                         num_bins: int) -> torch.Tensor:
    """out[f, b, k] = sum_n [xb[n, f] == b] * vals[n, k] on the card.

    xb [n, F] uint8 contiguous; vals [n, K] float32 contiguous, K in {3, 6};
    both on one CUDA device; 1 <= num_bins <= 256. Returns [F, B, K] f32.
    """
    if xb.device.type != "cuda" or vals.device != xb.device:
        raise ValueError("build_histogram_cuda takes CUDA tensors on one "
                         "device, got %s and %s" % (xb.device, vals.device))
    if xb.dtype != torch.uint8 or xb.dim() != 2:
        raise ValueError("xb must be a 2-D uint8 tensor, got %s %s"
                         % (xb.dtype, tuple(xb.shape)))
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[0] != xb.shape[0] or vals.shape[1] not in (3, 6):
        raise ValueError("vals must be float32 [n, 3] or [n, 6] with n = %d, "
                         "got %s %s" % (xb.shape[0], vals.dtype,
                                        tuple(vals.shape)))
    if not (xb.is_contiguous() and vals.is_contiguous()):
        raise ValueError("xb and vals must be contiguous")
    if not 1 <= num_bins <= 256:
        raise ValueError("num_bins must be in [1, 256], got %d" % num_bins)
    n, f = xb.shape
    k = vals.shape[1]
    if f == 0 or n == 0:
        return torch.zeros((f, num_bins, k), dtype=torch.float32,
                           device=xb.device)
    if n >= 2 ** 31:
        raise ValueError("build_histogram_cuda takes fewer than 2^31 rows")
    lib = _hist_lib()
    sm_count = torch.cuda.get_device_properties(xb.device).multi_processor_count
    ft, r, rows_per_block = hist_launch_plan(n, f, num_bins, k, sm_count)
    partial = torch.empty((r, f, num_bins, k), dtype=torch.float32,
                          device=xb.device)
    out = torch.empty((f, num_bins, k), dtype=torch.float32, device=xb.device)
    rc = lib.lgbt_hist_launch(
        xb.data_ptr(), vals.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, f, num_bins, k, ft, r, rows_per_block, current_stream(xb.device))
    if rc != 0:
        raise RuntimeError("histogram kernel launch failed: CUDA error %d (%s)"
                           % (rc, lib.lgbt_error_string(rc).decode()))
    build_histogram_cuda.launches += 1
    return out


build_histogram_cuda.launches = 0


def hist_bytes(n: int, num_features: int, num_bins: int, k: int) -> int:
    """Bytes the histogram function must move: each input read once
    (n*F bin bytes, 4*n*K value bytes), the output written once."""
    return n * num_features + 4 * n * k + 4 * num_features * num_bins * k
