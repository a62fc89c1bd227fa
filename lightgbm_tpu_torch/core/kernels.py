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
PART_LIBRARY = ("lgbt_hist_part", ["hist_part.cu"])
REPACK_LIBRARY = ("lgbt_repack", ["repack.cu"])
# every library of the port: {name: source files under core/csrc}
LIBRARIES = dict([HIST_LIBRARY, SLOTS_LIBRARY, PART_LIBRARY, REPACK_LIBRARY])
HIST_SMEM_BUDGET = 48 * 1024     # bytes of shared memory per block
HIST_MIN_ROWS_PER_BLOCK = 1024   # below this a block is mostly set-up
HIST_MAX_ROW_BLOCKS = 256        # caps the [R, F, B, K] partial scratch
# slot and partitioned kernels: row chunks per SM (about half the rows are
# active) and the cap on chunks, which bounds the [C + S - 1, F, B, K]
# partial
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


def _equal_feature_tiles(num_features: int, num_bins: int,
                         k: int) -> Tuple[int, int]:
    """(feature_tile, tiles): the fewest equal feature tiles whose
    [Ft, B, K] f32 sub-histogram fits HIST_SMEM_BUDGET."""
    tiles = -(-num_features // max(1, min(
        num_features, HIST_SMEM_BUDGET // (num_bins * k * 4))))
    return -(-num_features // tiles), tiles


def slot_hist_launch_plan(n: int, num_features: int, num_bins: int, k: int,
                          sm_count: int) -> Tuple[int, int, int]:
    """(feature_tile, chunks, rows_per_chunk) for one slot histogram call:
    equal feature tiles whose [Ft, B, K] f32 sub-histogram fits
    HIST_SMEM_BUDGET, then the rows (sorted by slot) cut into chunks that
    give the card about SLOT_CHUNKS_PER_SM blocks per SM, none shorter
    than HIST_MIN_ROWS_PER_BLOCK rows. Sized from n, not from the active
    rows, so nothing is read back."""
    ft, tiles = _equal_feature_tiles(num_features, num_bins, k)
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


def _part_lib() -> ctypes.CDLL:
    lib = load_library(*PART_LIBRARY)
    if not getattr(lib, "_lgbt_bound", False):
        lib.lgbt_hist_part_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_void_p, ctypes.c_longlong, _c_int, _c_int, _c_int, _c_int,
            _c_int, _c_int, _c_int, _c_int, _c_void_p]
        lib.lgbt_hist_part_launch.restype = _c_int
        lib.lgbt_part_error_string.argtypes = [_c_int]
        lib.lgbt_part_error_string.restype = ctypes.c_char_p
        lib._lgbt_bound = True
    return lib


def part_hist_launch_plan(n_tiles: int, num_features: int, num_bins: int,
                          sm_count: int) -> Tuple[int, int, int]:
    """(feature_tile, chunks, tiles_per_chunk) for one partitioned-layout
    call: equal feature tiles whose [Ft, B, 6] f32 sub-histogram fits
    HIST_SMEM_BUDGET, then the row tiles cut into runs of consecutive
    tiles that give the card about SLOT_CHUNKS_PER_SM blocks per SM, at
    most SLOT_MAX_CHUNKS of them. Sized from the tile count, which the
    host knows, so nothing is read back."""
    ft, tiles = _equal_feature_tiles(num_features, num_bins, 6)
    c = min(n_tiles, max(1, -(-SLOT_CHUNKS_PER_SM * sm_count // tiles)),
            SLOT_MAX_CHUNKS)
    per = -(-n_tiles // c)
    return ft, -(-n_tiles // per), per


def build_histogram_part_tiles_cuda(xb_fm: torch.Tensor, sel: torch.Tensor,
                                    vals3: torch.Tensor,
                                    tile_slot: torch.Tensor,
                                    tile_first: torch.Tensor, num_bins: int,
                                    n_slots: int,
                                    row_tile: int) -> torch.Tensor:
    """Both children of every splitting leaf over the partitioned layout on
    the card: out[s, f, b, k] = sum over the rows n of the tiles of slot s
    of [xb_fm[f, n] == b] * vals3[k, n] * sel[n], and vals3 * (1 - sel)
    in channels 3-5. A tile with a negative slot adds nothing, a slot past
    the last folds into S - 1, and a slot that owns no tile comes out
    zero. Every slot's tiles must form one contiguous run of tiles, as the
    partitioned layout keeps them (``core/grow_batched_part.py``).

    xb_fm [F, Np] uint8; sel [Np] and vals3 [3, Np] float32; tile_slot and
    tile_first [Np / row_tile] int32 (tile_first is implied by tile_slot
    and not read); all contiguous on one CUDA device, 16-byte aligned;
    row_tile a multiple of 16 that divides Np; 1 <= num_bins <= 256.
    Returns [S, F, B, 6] f32.
    """
    dev = xb_fm.device
    name = "build_histogram_part_tiles_cuda"
    tensors = (xb_fm, sel, vals3, tile_slot, tile_first)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("%s takes CUDA tensors on one device, got %s"
                         % (name, ", ".join(str(t.device) for t in tensors)))
    if xb_fm.dtype != torch.uint8 or xb_fm.dim() != 2:
        raise ValueError("xb_fm must be a 2-D uint8 tensor, got %s %s"
                         % (xb_fm.dtype, tuple(xb_fm.shape)))
    f, np_ = xb_fm.shape
    if row_tile <= 0 or row_tile % 16 or np_ % row_tile:
        raise ValueError("row_tile must be a positive multiple of 16 that "
                         "divides Np = %d, got %d" % (np_, row_tile))
    t = np_ // row_tile
    if sel.dtype != torch.float32 or tuple(sel.shape) != (np_,):
        raise ValueError("sel must be float32 [%d], got %s %s"
                         % (np_, sel.dtype, tuple(sel.shape)))
    if vals3.dtype != torch.float32 or tuple(vals3.shape) != (3, np_):
        raise ValueError("vals3 must be float32 [3, %d], got %s %s"
                         % (np_, vals3.dtype, tuple(vals3.shape)))
    for label, m in (("tile_slot", tile_slot), ("tile_first", tile_first)):
        if m.dtype != torch.int32 or tuple(m.shape) != (t,):
            raise ValueError("%s must be int32 [%d], got %s %s"
                             % (label, t, m.dtype, tuple(m.shape)))
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("xb_fm, sel, vals3, tile_slot and tile_first must "
                         "be contiguous")
    if any(x.data_ptr() % 16 for x in (xb_fm, sel, vals3)):
        raise ValueError("xb_fm, sel and vals3 must be 16-byte aligned")
    if not 1 <= num_bins <= 256:
        raise ValueError("num_bins must be in [1, 256], got %d" % num_bins)
    if n_slots < 1:
        raise ValueError("n_slots must be >= 1, got %d" % n_slots)
    out_shape = (n_slots, f, num_bins, 6)
    if f == 0 or np_ == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=dev)
    if t + 3 * n_slots >= 2 ** 31:
        raise ValueError("%s takes fewer than 2^31 tiles and slots" % name)
    lib = _part_lib()
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    ft, chunks, per = part_hist_launch_plan(t, f, num_bins, sm_count)
    # run_of_tile [T], slot_run [S], run_c0 [S], run_c1 [S]
    ints = torch.empty(t + 3 * n_slots, dtype=torch.int32, device=dev)
    partial = torch.empty((chunks + n_slots - 1, f, num_bins, 6),
                          dtype=torch.float32, device=dev)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    rc = lib.lgbt_hist_part_launch(
        xb_fm.data_ptr(), sel.data_ptr(), vals3.data_ptr(),
        tile_slot.data_ptr(), ints.data_ptr(), partial.data_ptr(),
        out.data_ptr(), np_, f, num_bins, n_slots, row_tile, t, ft, chunks,
        per, current_stream(dev))
    if rc != 0:
        raise RuntimeError("partitioned histogram kernel launch failed: CUDA "
                           "error %d (%s)"
                           % (rc, lib.lgbt_part_error_string(rc).decode()))
    build_histogram_part_tiles_cuda.launches += 1
    return out


build_histogram_part_tiles_cuda.launches = 0


def part_hist_bytes(active_tiles: int, n_tiles: int, row_tile: int,
                    num_features: int, num_bins: int, n_slots: int) -> int:
    """Bytes the partitioned-layout pass must move: the bin bytes, the
    selector float and three value floats of every row of an active tile,
    both tile maps, the output written once."""
    return (active_tiles * row_tile * (num_features + 4 + 12) + 8 * n_tiles
            + 4 * n_slots * num_features * num_bins * 6)


def _repack_lib() -> ctypes.CDLL:
    lib = load_library(*REPACK_LIBRARY)
    if not getattr(lib, "_lgbt_bound", False):
        lib.lgbt_partition_tiles_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
            _c_int, _c_void_p]
        lib.lgbt_partition_tiles_launch.restype = _c_int
        lib.lgbt_repack_error_string.argtypes = [_c_int]
        lib.lgbt_repack_error_string.restype = ctypes.c_char_p
        lib._lgbt_bound = True
    return lib


REPACK_MAX_ROW_TILE = 8192   # the block's [row_tile] int32 destinations


def partition_tiles_cuda(rows: torch.Tensor, go_left: torch.Tensor,
                         row_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable partition of every ``row_tile`` tile of byte rows on the card:
    each tile's go-left rows first, then its go-right rows, each in their
    order. rows [N, C] uint8 with C a multiple of 16, go_left [N] bool,
    both contiguous on one CUDA device, N a multiple of row_tile. Returns
    (rows [N, C] uint8, left counts [N / row_tile] int32)."""
    if rows.device.type != "cuda" or go_left.device != rows.device:
        raise ValueError("partition_tiles_cuda takes CUDA tensors on one "
                         "device, got %s and %s"
                         % (rows.device, go_left.device))
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("rows must be a 2-D uint8 tensor, got %s %s"
                         % (rows.dtype, tuple(rows.shape)))
    n, c = rows.shape
    if go_left.dtype != torch.bool or tuple(go_left.shape) != (n,):
        raise ValueError("go_left must be bool [%d], got %s %s"
                         % (n, go_left.dtype, tuple(go_left.shape)))
    if not (rows.is_contiguous() and go_left.is_contiguous()):
        raise ValueError("rows and go_left must be contiguous")
    if not 1 <= row_tile <= REPACK_MAX_ROW_TILE or n % row_tile:
        raise ValueError("row_tile must be in [1, %d] and divide N = %d, got "
                         "%d" % (REPACK_MAX_ROW_TILE, n, row_tile))
    if c == 0 or c % 16 or rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned with a width that is "
                         "a positive multiple of 16, got width %d" % c)
    t = n // row_tile
    out = torch.empty_like(rows)
    counts = torch.empty(t, dtype=torch.int32, device=rows.device)
    if t == 0:
        return out, counts
    lib = _repack_lib()
    rc = lib.lgbt_partition_tiles_launch(
        rows.data_ptr(), go_left.data_ptr(), out.data_ptr(),
        counts.data_ptr(), t, row_tile, c, current_stream(rows.device))
    if rc != 0:
        raise RuntimeError("partition kernel launch failed: CUDA error %d (%s)"
                           % (rc, lib.lgbt_repack_error_string(rc).decode()))
    partition_tiles_cuda.launches += 1
    return out, counts


partition_tiles_cuda.launches = 0


def partition_bytes(n: int, c: int, row_tile: int) -> int:
    """Bytes the in-tile partition must move: every row read and written
    once, its go-left byte read, one int32 count a tile written."""
    return 2 * n * c + n + 4 * (n // row_tile)
