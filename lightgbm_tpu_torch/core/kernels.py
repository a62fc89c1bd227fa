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
SLOTS_LIBRARY = ("lgbt_hist_slots", ["hist_slots.cu"])
# every library of the port: {name: source files under core/csrc}
LIBRARIES = dict([HIST_LIBRARY, SLOTS_LIBRARY])
HIST_SMEM_BUDGET = 48 * 1024     # bytes of shared memory per block
HIST_MIN_ROWS_PER_BLOCK = 1024   # below this a block is mostly set-up
HIST_MAX_ROW_BLOCKS = 256        # caps the [R, F, B, K] partial scratch
# slot kernels: sorted-row chunks per SM (about half the rows are active)
# and the cap on chunks, which bounds the [C + S - 1, F, B, K] partial
SLOT_CHUNKS_PER_SM = 8
SLOT_MAX_CHUNKS = 512

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


def _slots_lib() -> ctypes.CDLL:
    lib = load_library(*SLOTS_LIBRARY)
    if not getattr(lib, "_lgbt_bound", False):
        lib.lgbt_hist_slots_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
            _c_int, _c_int, _c_void_p]
        lib.lgbt_hist_slots_launch.restype = _c_int
        lib.lgbt_slots_error_string.argtypes = [_c_int]
        lib.lgbt_slots_error_string.restype = ctypes.c_char_p
        lib._lgbt_bound = True
    return lib


def slot_hist_launch_plan(n: int, num_features: int, num_bins: int, k: int,
                          sm_count: int) -> Tuple[int, int, int]:
    """(feature_tile, chunks, rows_per_chunk) for one slot histogram call:
    equal feature tiles whose [Ft, B, K] f32 sub-histogram fits
    HIST_SMEM_BUDGET, then the rows (sorted by slot) cut into chunks that
    give the card about SLOT_CHUNKS_PER_SM blocks per SM, none shorter
    than HIST_MIN_ROWS_PER_BLOCK rows. Sized from n, not from the active
    rows, so nothing is read back."""
    tiles = -(-num_features // max(1, min(
        num_features, HIST_SMEM_BUDGET // (num_bins * k * 4))))
    ft = -(-num_features // tiles)
    c = min(max(1, -(-n // HIST_MIN_ROWS_PER_BLOCK)),
            max(1, -(-SLOT_CHUNKS_PER_SM * sm_count // tiles)),
            SLOT_MAX_CHUNKS)
    return ft, c, max(1, -(-n // c))


def _check_slot_inputs(name: str, xb: torch.Tensor, slot: torch.Tensor,
                       vals: torch.Tensor, num_bins: int,
                       n_slots: int) -> None:
    dev = xb.device
    if dev.type != "cuda" or slot.device != dev or vals.device != dev:
        raise ValueError("%s takes CUDA tensors on one device, got %s, %s "
                         "and %s" % (name, dev, slot.device, vals.device))
    if xb.dtype != torch.uint8 or xb.dim() != 2:
        raise ValueError("xb must be a 2-D uint8 tensor, got %s %s"
                         % (xb.dtype, tuple(xb.shape)))
    n = xb.shape[0]
    if slot.dtype != torch.int32 or tuple(slot.shape) != (n,):
        raise ValueError("slot must be int32 [%d], got %s %s"
                         % (n, slot.dtype, tuple(slot.shape)))
    if vals.dtype != torch.float32 or tuple(vals.shape) != (n, 3):
        raise ValueError("vals must be float32 [%d, 3], got %s %s"
                         % (n, vals.dtype, tuple(vals.shape)))
    if not (xb.is_contiguous() and slot.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("xb, slot and vals must be contiguous")
    if not 1 <= num_bins <= 256:
        raise ValueError("num_bins must be in [1, 256], got %d" % num_bins)
    if n_slots < 1:
        raise ValueError("n_slots must be >= 1, got %d" % n_slots)
    if n + 3 * n_slots + 1 >= 2 ** 31:
        raise ValueError("%s takes fewer than 2^31 rows and slots" % name)


def _launch_slots(wrapper, xb, slot, vals, sel, num_bins: int, n_slots: int,
                  k: int) -> torch.Tensor:
    """Launch hist_slots.cu's pass (count, scan, scatter, hist, reduce)
    and count the launch on ``wrapper``."""
    n, f = xb.shape
    out_shape = (n_slots, f, num_bins, k)
    if f == 0 or n == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=xb.device)
    lib = _slots_lib()
    sm_count = torch.cuda.get_device_properties(xb.device).multi_processor_count
    ft, chunks, rows_per_chunk = slot_hist_launch_plan(n, f, num_bins, k,
                                                       sm_count)
    # counts [S], offsets [S + 1], cursors [S], perm [n]
    ints = torch.empty(3 * n_slots + 1 + n, dtype=torch.int32,
                       device=xb.device)
    partial = torch.empty((chunks + n_slots - 1, f, num_bins, k),
                          dtype=torch.float32, device=xb.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=xb.device)
    rc = lib.lgbt_hist_slots_launch(
        xb.data_ptr(), slot.data_ptr(), vals.data_ptr(),
        sel.data_ptr() if sel is not None else None, ints.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, f, num_bins, n_slots, k, ft,
        chunks, rows_per_chunk, current_stream(xb.device))
    if rc != 0:
        raise RuntimeError("slot histogram kernel launch failed: CUDA error "
                           "%d (%s)" % (rc, lib.lgbt_slots_error_string(rc)
                                        .decode()))
    wrapper.launches += 1
    return out


def build_histogram_slots_cuda(xb: torch.Tensor, slot: torch.Tensor,
                               vals: torch.Tensor, num_bins: int,
                               n_slots: int) -> torch.Tensor:
    """out[s, f, b, k] = sum_n [min(slot[n], S-1) == s] [xb[n, f] == b]
    * vals[n, k] on the card; rows with a negative slot add nothing.

    xb [n, F] uint8, slot [n] int32, vals [n, 3] float32, all contiguous
    on one CUDA device; 1 <= num_bins <= 256. Returns [S, F, B, 3] f32.
    """
    _check_slot_inputs("build_histogram_slots_cuda", xb, slot, vals,
                       num_bins, n_slots)
    return _launch_slots(build_histogram_slots_cuda, xb, slot, vals, None,
                         num_bins, n_slots, 3)


build_histogram_slots_cuda.launches = 0


def build_histogram_slots6_cuda(xb: torch.Tensor, slot: torch.Tensor,
                                sel: torch.Tensor, vals3: torch.Tensor,
                                num_bins: int, n_slots: int) -> torch.Tensor:
    """Both children of every splitting parent slot in one pass:
    channels vals3 * sel then vals3 * (1 - sel), as
    ``build_histogram_slots_cuda`` otherwise.

    sel [n] float32 contiguous on the same device. Returns [S, F, B, 6] f32.
    """
    _check_slot_inputs("build_histogram_slots6_cuda", xb, slot, vals3,
                       num_bins, n_slots)
    if sel.device != xb.device or sel.dtype != torch.float32 \
            or tuple(sel.shape) != (xb.shape[0],) or not sel.is_contiguous():
        raise ValueError("sel must be contiguous float32 [%d] on %s, got %s "
                         "%s on %s" % (xb.shape[0], xb.device, sel.dtype,
                                       tuple(sel.shape), sel.device))
    return _launch_slots(build_histogram_slots6_cuda, xb, slot, vals3, sel,
                         num_bins, n_slots, 6)


build_histogram_slots6_cuda.launches = 0


def slot_hist_bytes(n: int, n_active: int, num_features: int, num_bins: int,
                    k: int, n_slots: int) -> int:
    """Bytes a slot histogram must move: every row's slot id, the bin
    bytes and three value floats of each active row (and its sel float
    when K = 6: an inactive row's selector is never needed), the output
    written once."""
    sel = 4 * n_active if k == 6 else 0
    return (4 * n + n_active * (num_features + 12) + sel
            + 4 * n_slots * num_features * num_bins * k)
