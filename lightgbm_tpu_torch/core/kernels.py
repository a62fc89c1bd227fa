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
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..device import current_stream, load_library

HIST_LIBRARY = ("lgbt_histogram", ["histogram.cu"])
SLOTS_LIBRARY = ("lgbt_hist_slots", ["hist_slots.cu"])
PART_LIBRARY = ("lgbt_hist_part", ["hist_part.cu"])
REPACK_LIBRARY = ("lgbt_repack", ["repack.cu"])
# every library of the port: {name: source files under core/csrc}
LIBRARIES = dict([HIST_LIBRARY, SLOTS_LIBRARY, PART_LIBRARY, REPACK_LIBRARY])
# histogram.cu: the direct variant up to this many rows, the block variant
# above; on the H100 their device times cross between 4,096 and 16,384
# rows (chip_smoke.py phase 3 times both at every shape)
HIST_DIRECT_MAX_ROWS = 8_192
HIST_DIRECT_THREADS = 128
HIST_BLOCK_THREADS = 1024
HIST_SMEM_OPT_IN = 232_448       # sm_90: 227 KB a block, opted in
HIST_MAX_REPLICAS = 4            # copies of the block's sub-histogram
# hist_slots.cu: rows of one count or scatter block (~4 blocks of 512
# threads an SM at 1M rows), and the hist pass's one block of 1,024
# threads an SM with up to two replicas of a slot's histogram
SLOT_SORT_ROWS = 2048
SLOT_SORT_SLOTS = 4096           # slots one count or scatter block covers
SLOT_MAX_REPLICAS = 2

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _hist_lib() -> ctypes.CDLL:
    lib = load_library(*HIST_LIBRARY)
    if not getattr(lib, "_lgbt_bound", False):
        lib.lgbt_hist_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
            ctypes.c_longlong, _c_void_p]
        lib.lgbt_hist_launch.restype = _c_int
        lib.lgbt_error_string.argtypes = [_c_int]
        lib.lgbt_error_string.restype = ctypes.c_char_p
        lib._lgbt_bound = True
    return lib


class HistPlan(NamedTuple):
    """One histogram.cu call: the variant, its grid (``grid_x`` blocks of
    ``threads``; for ``block``, ``grid_x`` feature tiles of
    ``feature_tile`` features by ``grid_y`` row slices of
    ``rows_per_block`` rows) and the block variant's dynamic shared
    memory, ``replicas`` copies of a [feature_tile, B, K] histogram of the
    values' dtype."""
    variant: str
    threads: int
    grid_x: int
    grid_y: int
    feature_tile: int
    rows_per_block: int
    replicas: int
    smem_bytes: int


HIST_VARIANTS = ("direct", "block")
# the value dtypes histogram.cu takes, by its dtype code
HIST_DTYPES = (torch.float32, torch.float64)


def _pad16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


@functools.lru_cache(maxsize=4096)
def hist_launch_plan(n: int, num_features: int, num_bins: int, k: int,
                     sm_count: int, variant: Optional[str] = None,
                     elem_bytes: int = 4, ld: int = 0) -> HistPlan:
    """The plan of one ``histogram.cu`` call over n >= 1 rows.

    ``direct`` runs at n <= HIST_DIRECT_MAX_ROWS (about half of exact
    growth's split passes): one thread per aligned 4-byte word of the flat
    [n * F] bin array adds each element's triple straight into the output
    with global atomics (a REDG.E.ADD.F32x2 and a REDG.E.ADD.F32 in the
    SASS, served at the L2), so the grid scales with n * F (225 blocks at
    4,096 x 28) and nothing is zeroed or flushed but the output. It is
    bound by the L2's rate for scattered reductions and, at the smallest
    n, by the launch. ``block`` runs above: one block of 1,024 threads an
    SM (``sm_count`` row slices, split further into feature tiles only
    where F * B * K * 4 bytes exceed the 227 KB opt-in) holds the
    histogram of its features in shared memory, in as many replicas as
    fit (up to HIST_MAX_REPLICAS), and adds its non-zero cells into the
    output once (REDG.E.ADD.F32x4). It is bound by the shared f32
    atomics, compare-and-swap loops on this card (ATOMS.CAST.SPIN).
    Neither uses device-memory scratch. Both add in an order that varies
    from run to run, so a cell's f32 sum may move by a few ulps between
    runs; 0/1 channels stay exact. ``variant`` forces one (chip_smoke.py
    and the card's tests run both at every shape).

    ``elem_bytes`` 8 plans the float64 variant (``gpu_use_dp``): the same
    grids, with a shared replica twice as large, so at F=28, B=255 one
    replica fits at K=3 (171 KB) and K=6 takes two feature tiles of 14.

    ``ld`` is the row stride in bytes where it is not F (packed words:
    4 W); the direct grid covers its n * ld bytes."""
    if variant is None:
        variant = "direct" if n <= HIST_DIRECT_MAX_ROWS else "block"
    if variant == "direct":
        words = -(-n * (ld or num_features) // 4) + 1   # +1: misaligned
        return HistPlan("direct", HIST_DIRECT_THREADS,
                        -(-words // HIST_DIRECT_THREADS), 1, num_features,
                        n, 1, 0)
    if variant != "block":
        raise ValueError("variant must be one of %s, got %r"
                         % ("/".join(HIST_VARIANTS), variant))
    feature_bytes = num_bins * k * elem_bytes
    ft = max(1, min(num_features, HIST_SMEM_OPT_IN // feature_bytes))
    tiles = -(-num_features // ft)
    ft = -(-num_features // tiles)                # equal tiles
    replica_bytes = _pad16(ft * feature_bytes)
    replicas = max(1, min(HIST_MAX_REPLICAS,
                          HIST_SMEM_OPT_IN // replica_bytes))
    r = min(max(1, -(-sm_count // tiles)), n)
    rows_per_block = -(-n // r)
    return HistPlan("block", HIST_BLOCK_THREADS, tiles,
                    -(-n // rows_per_block), ft, rows_per_block, replicas,
                    replicas * replica_bytes)


_SM_COUNT: Dict[int, int] = {}


def _code_bytes(xb: torch.Tensor, packed_cols: int) -> Tuple[torch.Tensor,
                                                              int]:
    """(the uint8 [n, ld] bytes a kernel reads, the code columns F): the
    uint8 matrix itself (ld = F), or with ``packed_cols`` > 0 the bytes of
    int32 [n, W] packed words (ld = 4 W >= F), read in place."""
    if packed_cols:
        if xb.dtype != torch.int32 or xb.dim() != 2 \
                or not 0 < packed_cols <= 4 * xb.shape[1]:
            raise ValueError("packed words must be int32 [n, W] holding %d "
                             "columns, got %s %s" % (packed_cols, xb.dtype,
                                                     tuple(xb.shape)))
        return xb.view(torch.uint8), int(packed_cols)
    if xb.dtype != torch.uint8 or xb.dim() != 2:
        raise ValueError("xb must be a 2-D uint8 tensor, got %s %s"
                         % (xb.dtype, tuple(xb.shape)))
    return xb, xb.shape[1]


def _sm_count(dev: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    count = _SM_COUNT.get(idx)
    if count is None:
        count = torch.cuda.get_device_properties(idx).multi_processor_count
        _SM_COUNT[idx] = count
    return count


def _launch_histogram(name: str, xb: torch.Tensor, vals: torch.Tensor,
                      num_bins: int, variant: Optional[str],
                      dtype: torch.dtype = torch.float32,
                      packed_cols: int = 0) -> Tuple[torch.Tensor, bool]:
    """Check, allocate and launch histogram.cu for ``name``'s wrapper,
    which takes values of ``dtype``: returns (out, whether the kernel was
    launched). ``packed_cols`` > 0: xb is int32 [n, W] packed words holding
    that many code columns, launched as their uint8 [n, 4 W] bytes at a
    row stride of 4 W."""
    dev = xb.device
    if dev.type != "cuda" or vals.device != dev:
        raise ValueError("%s takes CUDA tensors on one device, got %s and "
                         "%s" % (name, dev, vals.device))
    xb, f = _code_bytes(xb, packed_cols)
    if vals.dtype != dtype or vals.dim() != 2 \
            or vals.shape[0] != xb.shape[0] or vals.shape[1] not in (3, 6):
        raise ValueError("%s takes vals %s [n, 3] or [n, 6] with n = %d, "
                         "got %s %s" % (name, dtype, xb.shape[0], vals.dtype,
                                        tuple(vals.shape)))
    if not (xb.is_contiguous() and vals.is_contiguous()):
        raise ValueError("xb and vals must be contiguous")
    if not 1 <= num_bins <= 256:
        raise ValueError("num_bins must be in [1, 256], got %d" % num_bins)
    n, ld = xb.shape
    k = vals.shape[1]
    if f == 0 or n == 0:
        return torch.zeros((f, num_bins, k), dtype=dtype, device=dev), False
    if n * ld >= 2 ** 31:
        raise ValueError("%s takes fewer than 2^31 bin bytes (n * row "
                         "stride)" % name)
    plan = hist_launch_plan(n, f, num_bins, k, _sm_count(dev), variant,
                            vals.element_size(), ld)
    lib = _hist_lib()
    out = torch.empty((f, num_bins, k), dtype=dtype, device=dev)
    rc = lib.lgbt_hist_launch(
        xb.data_ptr(), vals.data_ptr(), out.data_ptr(), n, f, ld, num_bins, k,
        HIST_DTYPES.index(dtype),
        HIST_VARIANTS.index(plan.variant), plan.grid_x, plan.grid_y,
        plan.feature_tile, plan.rows_per_block, plan.replicas,
        plan.smem_bytes, current_stream(dev))
    if rc != 0:
        raise RuntimeError("histogram kernel launch failed: CUDA error %d (%s)"
                           % (rc, lib.lgbt_error_string(rc).decode()))
    return out, True


def build_histogram_cuda(xb: torch.Tensor, vals: torch.Tensor,
                         num_bins: int,
                         variant: Optional[str] = None) -> torch.Tensor:
    """out[f, b, k] = sum_n [xb[n, f] == b] * vals[n, k] on the card.

    xb [n, F] uint8 contiguous; vals [n, K] float32 contiguous, K in {3, 6};
    both on one CUDA device; 1 <= num_bins <= 256; n * F < 2^31. Returns
    [F, B, K] f32. One memset and one kernel launch, of the variant
    ``hist_launch_plan`` picks (``variant`` forces one), counted once in
    ``build_histogram_cuda.launches``. At K=6 a row may feed both triples,
    but the kernel is fastest when it feeds one (the partition's case).
    The order of the f32 additions varies from run to run (atomics);
    a channel of 0/1 values is exact.
    """
    out, launched = _launch_histogram("build_histogram_cuda", xb, vals,
                                      num_bins, variant)
    build_histogram_cuda.launches += launched
    return out


build_histogram_cuda.launches = 0


def build_histogram_words_cuda(xw: torch.Tensor, vals: torch.Tensor,
                               num_bins: int, packed_cols: int,
                               variant: Optional[str] = None
                               ) -> torch.Tensor:
    """``build_histogram_cuda`` over packed bin words (``tpu_bin_packing``,
    ``core/binpack.py``): xw int32 [n, W] contiguous, ``packed_cols`` = F
    <= 4 W code columns in little-endian lanes. histogram.cu reads the
    words' bytes in place at a row stride of 4 W and skips the tail lanes;
    nothing is unpacked. Returns [F, B, K] f32, its launches counted in
    ``build_histogram_words_cuda.launches`` (the root of a frontier tree on
    packed words, in memory or once a streamed chunk)."""
    out, launched = _launch_histogram("build_histogram_words_cuda", xw,
                                      vals, num_bins, variant,
                                      packed_cols=packed_cols)
    build_histogram_words_cuda.launches += launched
    return out


build_histogram_words_cuda.launches = 0


def build_histogram_leaf_cuda(xb: torch.Tensor, vals: torch.Tensor,
                              num_bins: int,
                              variant: Optional[str] = None) -> torch.Tensor:
    """``build_histogram_cuda`` for one leaf's rebuilt histogram (a forced
    split, ``core/partition.py`` ``hist_for_leaf``): the same checks and
    kernel, its launches counted in
    ``build_histogram_leaf_cuda.launches``."""
    out, launched = _launch_histogram("build_histogram_leaf_cuda", xb, vals,
                                      num_bins, variant)
    build_histogram_leaf_cuda.launches += launched
    return out


build_histogram_leaf_cuda.launches = 0


def build_histogram_f64_cuda(xb: torch.Tensor, vals: torch.Tensor,
                             num_bins: int,
                             variant: Optional[str] = None) -> torch.Tensor:
    """``build_histogram_cuda`` in float64 (``gpu_use_dp``): vals [n, K]
    float64 -> [F, B, K] float64, summed in float64 by histogram.cu's f64
    variant (scalar f64 atomics), its launches counted in
    ``build_histogram_f64_cuda.launches``. Its sums still add in an order
    that varies from run to run, but each rounds at 2^-53."""
    out, launched = _launch_histogram("build_histogram_f64_cuda", xb, vals,
                                      num_bins, variant, torch.float64)
    build_histogram_f64_cuda.launches += launched
    return out


build_histogram_f64_cuda.launches = 0


def build_histogram_leaf_f64_cuda(xb: torch.Tensor, vals: torch.Tensor,
                                  num_bins: int,
                                  variant: Optional[str] = None
                                  ) -> torch.Tensor:
    """``build_histogram_leaf_cuda`` in float64: one leaf's rebuilt
    histogram under ``gpu_use_dp``, counted in
    ``build_histogram_leaf_f64_cuda.launches``."""
    out, launched = _launch_histogram("build_histogram_leaf_f64_cuda", xb,
                                      vals, num_bins, variant, torch.float64)
    build_histogram_leaf_f64_cuda.launches += launched
    return out


build_histogram_leaf_f64_cuda.launches = 0


def hist_bytes(n: int, num_features: int, num_bins: int, k: int,
               elem_bytes: int = 4, ld: int = 0) -> int:
    """Bytes the histogram function must move: each input read once
    (n*F bin bytes, or n*ld for packed words of ld bytes a row;
    elem_bytes*n*K value bytes), the output written once."""
    return (n * (ld or num_features) + elem_bytes * n * k
            + elem_bytes * num_features * num_bins * k)


def _slots_lib() -> ctypes.CDLL:
    lib = load_library(*SLOTS_LIBRARY)
    if not getattr(lib, "_lgbt_bound", False):
        lib.lgbt_hist_slots_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
            _c_int, _c_int, _c_int, _c_int, ctypes.c_longlong, _c_void_p]
        lib.lgbt_hist_slots_launch.restype = _c_int
        lib.lgbt_slots_error_string.argtypes = [_c_int]
        lib.lgbt_slots_error_string.restype = ctypes.c_char_p
        lib._lgbt_bound = True
    return lib


class SlotPlan(NamedTuple):
    """One hist_slots.cu call: ``sort_blocks`` count and scatter blocks of
    ``rows_per_sort_block`` rows for each of ``slot_windows`` windows of
    SLOT_SORT_SLOTS slots, then ``hist_blocks`` blocks of 1,024 threads
    for each of the ``tiles`` feature tiles of ``feature_tile`` features,
    each with ``smem_bytes`` of dynamic shared memory: ``replicas`` copies
    of a slot's [feature_tile, B, K] f32 histogram, each after a lead of
    up to 3 floats and padded to 16 bytes."""
    sort_blocks: int
    rows_per_sort_block: int
    slot_windows: int
    hist_blocks: int
    tiles: int
    feature_tile: int
    replicas: int
    smem_bytes: int


def _slot_replica_bytes(feature_tile: int, num_bins: int, k: int) -> int:
    """Bytes of one shared replica (hist_slots.cu replica_floats)."""
    return 4 * ((feature_tile * num_bins * k + 3 + 3) & ~3)


@functools.lru_cache(maxsize=4096)
def slot_hist_launch_plan(n: int, num_features: int, num_bins: int, k: int,
                          n_slots: int, sm_count: int) -> SlotPlan:
    """The plan of one slot histogram call over n >= 1 rows and any
    n_slots >= 1: the count and scatter blocks cover the n rows in
    SLOT_SORT_ROWS-row blocks, once for each window of SLOT_SORT_SLOTS
    slots (one window up to 4,096 slots); the hist pass keeps a slot's
    histogram of a whole feature tile (all F = 28 features at K = 3 and
    6) in opted-in shared memory, in as many replicas as fit up to
    SLOT_MAX_REPLICAS, with one block an SM (``sm_count`` blocks over the
    tiles) that each take an equal share of the sorted active rows, so
    one plan serves S = 1 (one segment over every SM) and S = 254 alike.
    Sized from n, not from the active rows, so nothing is read back."""
    feature_bytes = num_bins * k * 4
    ft = max(1, min(num_features, (HIST_SMEM_OPT_IN - 16) // feature_bytes))
    tiles = -(-num_features // ft)
    ft = -(-num_features // tiles)                # equal tiles
    replica_bytes = _slot_replica_bytes(ft, num_bins, k)
    replicas = max(1, min(SLOT_MAX_REPLICAS,
                          HIST_SMEM_OPT_IN // replica_bytes))
    sort_blocks = -(-n // SLOT_SORT_ROWS)
    return SlotPlan(sort_blocks, -(-n // sort_blocks),
                    -(-n_slots // SLOT_SORT_SLOTS),
                    min(max(1, -(-sm_count // tiles)), n), tiles, ft,
                    replicas, replicas * replica_bytes)


def _check_slot_inputs(name: str, xb: torch.Tensor, slot: torch.Tensor,
                       vals: torch.Tensor, num_bins: int,
                       n_slots: int, packed_cols: int = 0
                       ) -> Tuple[torch.Tensor, int]:
    """Raise on what hist_slots.cu does not take; returns the uint8 [n, ld]
    bytes it reads and the code columns F (``_code_bytes``)."""
    dev = xb.device
    if dev.type != "cuda" or slot.device != dev or vals.device != dev:
        raise ValueError("%s takes CUDA tensors on one device, got %s, %s "
                         "and %s" % (name, dev, slot.device, vals.device))
    xb, f = _code_bytes(xb, packed_cols)
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
    if n + 3 * n_slots + 1 >= 2 ** 31 or n * xb.shape[1] >= 2 ** 31:
        raise ValueError("%s takes fewer than 2^31 rows and slots, and "
                         "fewer than 2^31 bin bytes (n * row stride)" % name)
    return xb, f


def _launch_slots(wrapper, xb, f: int, slot, vals, sel, num_bins: int,
                  n_slots: int, k: int) -> torch.Tensor:
    """Launch hist_slots.cu's pass (two memsets, then count, scan,
    scatter and hist) over the uint8 [n, ld] bytes ``xb`` of F code
    columns, and count the launch on ``wrapper``."""
    n, ld = xb.shape
    out_shape = (n_slots, f, num_bins, k)
    if f == 0 or n == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=xb.device)
    lib = _slots_lib()
    plan = slot_hist_launch_plan(n, f, num_bins, k, n_slots,
                                 _sm_count(xb.device))
    # counts [S], offsets [S + 1], cursors [S], perm [n]
    ints = torch.empty(3 * n_slots + 1 + n, dtype=torch.int32,
                       device=xb.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=xb.device)
    rc = lib.lgbt_hist_slots_launch(
        xb.data_ptr(), slot.data_ptr(), vals.data_ptr(),
        sel.data_ptr() if sel is not None else None, ints.data_ptr(),
        out.data_ptr(), n, f, ld, num_bins, n_slots, k, plan.sort_blocks,
        plan.rows_per_sort_block, plan.slot_windows, plan.hist_blocks,
        plan.feature_tile, plan.replicas, plan.smem_bytes,
        current_stream(xb.device))
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
    on one CUDA device; 1 <= num_bins <= 256; n * F < 2^31; any S >= 1.
    Returns [S, F, B, 3] f32. Two memsets and four launches of the plan
    ``slot_hist_launch_plan`` gives, counted once in
    ``build_histogram_slots_cuda.launches``. The order of the f32
    additions varies from run to run (atomics); a channel of 0/1 values
    is exact.
    """
    xb, f = _check_slot_inputs("build_histogram_slots_cuda", xb, slot, vals,
                               num_bins, n_slots)
    return _launch_slots(build_histogram_slots_cuda, xb, f, slot, vals, None,
                         num_bins, n_slots, 3)


build_histogram_slots_cuda.launches = 0


def build_histogram_slots_words_cuda(xw: torch.Tensor, slot: torch.Tensor,
                                     vals: torch.Tensor, num_bins: int,
                                     n_slots: int,
                                     packed_cols: int) -> torch.Tensor:
    """``build_histogram_slots_cuda`` over packed bin words: xw int32
    [n, W] contiguous holding ``packed_cols`` = F <= 4 W code columns
    (``core/binpack.py``), read in place at a row stride of 4 W, every
    row starting on a word; the tail lanes add nothing. Returns
    [S, F, B, 3] f32, its launches counted in
    ``build_histogram_slots_words_cuda.launches`` (a frontier wave on
    packed words, in memory or once a streamed chunk)."""
    xb, f = _check_slot_inputs("build_histogram_slots_words_cuda", xw, slot,
                               vals, num_bins, n_slots, packed_cols)
    return _launch_slots(build_histogram_slots_words_cuda, xb, f, slot, vals,
                         None, num_bins, n_slots, 3)


build_histogram_slots_words_cuda.launches = 0


def build_histogram_slots6_cuda(xb: torch.Tensor, slot: torch.Tensor,
                                sel: torch.Tensor, vals3: torch.Tensor,
                                num_bins: int, n_slots: int) -> torch.Tensor:
    """Both children of every splitting parent slot in one pass:
    channels vals3 * sel then vals3 * (1 - sel), as
    ``build_histogram_slots_cuda`` otherwise.

    sel [n] float32 contiguous on the same device. Returns [S, F, B, 6] f32.
    """
    xb, f = _check_slot_inputs("build_histogram_slots6_cuda", xb, slot,
                               vals3, num_bins, n_slots)
    if sel.device != xb.device or sel.dtype != torch.float32 \
            or tuple(sel.shape) != (xb.shape[0],) or not sel.is_contiguous():
        raise ValueError("sel must be contiguous float32 [%d] on %s, got %s "
                         "%s on %s" % (xb.shape[0], xb.device, sel.dtype,
                                       tuple(sel.shape), sel.device))
    return _launch_slots(build_histogram_slots6_cuda, xb, f, slot, vals3,
                         sel, num_bins, n_slots, 6)


build_histogram_slots6_cuda.launches = 0


def slot_hist_bytes(n: int, n_active: int, num_features: int, num_bins: int,
                    k: int, n_slots: int, ld: int = 0) -> int:
    """Bytes a slot histogram must move: every row's slot id, the bin
    bytes (ld a row for packed words) and three value floats of each
    active row (and its sel float when K = 6: an inactive row's selector
    is never needed), the output written once."""
    sel = 4 * n_active if k == 6 else 0
    return (4 * n + n_active * ((ld or num_features) + 12) + sel
            + 4 * n_slots * num_features * num_bins * k)


def _part_lib() -> ctypes.CDLL:
    lib = load_library(*PART_LIBRARY)
    if not getattr(lib, "_lgbt_bound", False):
        lib.lgbt_hist_part_launch.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            ctypes.c_longlong, _c_int, _c_int, _c_int, _c_int, _c_int,
            _c_int, _c_int, ctypes.c_longlong, _c_void_p]
        lib.lgbt_hist_part_launch.restype = _c_int
        lib.lgbt_part_error_string.argtypes = [_c_int]
        lib.lgbt_part_error_string.restype = ctypes.c_char_p
        lib._lgbt_bound = True
    return lib


class PartPlan(NamedTuple):
    """One hist_part.cu call: ``hist_blocks`` blocks of 1,024 threads for
    each of the ``tiles`` feature tiles of ``feature_tile`` features, each
    with ``smem_bytes`` of dynamic shared memory (a [feature_tile, B, 6]
    f32 histogram after a lead of up to 3 floats, padded to 16 bytes, then
    a [feature_tile, B] uint32 of left and right 16-bit counts), and the
    list's int32 scratch of ``scratch_ints``."""
    hist_blocks: int
    tiles: int
    feature_tile: int
    smem_bytes: int
    scratch_ints: int


def _part_hist_floats(feature_tile: int, num_bins: int) -> int:
    """Floats of the shared histogram (hist_part.cu hist_floats)."""
    return (feature_tile * num_bins * 6 + 3 + 3) & ~3


@functools.lru_cache(maxsize=4096)
def part_hist_launch_plan(n_tiles: int, num_features: int, num_bins: int,
                          sm_count: int) -> PartPlan:
    """The plan of one partitioned-layout call over n_tiles row tiles: the
    fewest equal feature tiles whose shared histogram and counts fit the
    227 KB opt-in (one at F = 28, B = 255), one block an SM for each, and
    the
    plan kernel's list of the active tiles and their slots (1 + 2T ints).
    The blocks take equal shares of the active rows, which the card
    counts, so the plan depends on neither S nor the active tiles and
    nothing is read back."""
    feature_bytes = 4 * num_bins * 7              # 6 f32 cells, 1 count
    ft = max(1, min(num_features, (HIST_SMEM_OPT_IN - 24) // feature_bytes))
    tiles = -(-num_features // ft)
    ft = -(-num_features // tiles)                # equal tiles
    return PartPlan(sm_count, tiles, ft,
                    4 * (_part_hist_floats(ft, num_bins) + ft * num_bins),
                    1 + 2 * n_tiles)


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
    if 2 * t + 1 >= 2 ** 31:
        raise ValueError("%s takes fewer than 2^30 tiles" % name)
    lib = _part_lib()
    plan = part_hist_launch_plan(t, f, num_bins, _sm_count(dev))
    ints = torch.empty(plan.scratch_ints, dtype=torch.int32, device=dev)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    rc = lib.lgbt_hist_part_launch(
        xb_fm.data_ptr(), sel.data_ptr(), vals3.data_ptr(),
        tile_slot.data_ptr(), ints.data_ptr(), out.data_ptr(), np_, f,
        num_bins, n_slots, row_tile, t, plan.feature_tile, plan.hist_blocks,
        plan.smem_bytes, current_stream(dev))
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


# ------------------------------------------------------------ accounting
def _hist_launch_costs(args) -> Tuple[float, float]:
    """(bytes, additions) of one histogram.cu launch from its arguments
    (xb, vals, out, n, f, ld, num_bins, k, dtype index, ...)."""
    n, f, ld, num_bins, k, dtype_idx = args[3:9]
    elem = HIST_DTYPES[dtype_idx].itemsize
    return hist_bytes(n, f, num_bins, k, elem, ld), n * f * k


def _slots_launch_costs(args) -> Tuple[float, float]:
    """(bytes, additions) of one hist_slots.cu launch (xb, slot, vals, sel,
    ints, out, n, f, ld, num_bins, n_slots, k, ...), every row counted as
    active: which rows are lives on the card."""
    n, f, ld, num_bins, n_slots, k = args[6:12]
    return slot_hist_bytes(n, n, f, num_bins, k, n_slots, ld), n * f * k


def _part_launch_costs(args) -> Tuple[float, float]:
    """(bytes, additions) of one hist_part.cu launch (xb_fm, sel, vals3,
    tile_slot, ints, out, Np, f, num_bins, n_slots, row_tile, tiles, ...),
    every tile counted as active."""
    np_, f, num_bins, n_slots, row_tile, tiles = args[6:12]
    return (part_hist_bytes(tiles, tiles, row_tile, f, num_bins, n_slots),
            np_ * f * 6)


# loader -> (its launch function, the cost-model entry, its costs)
_ACCOUNTED = {
    "_hist_lib": ("lgbt_hist_launch", HIST_LIBRARY[1][0], _hist_launch_costs),
    "_slots_lib": ("lgbt_hist_slots_launch", SLOTS_LIBRARY[1][0],
                   _slots_launch_costs),
    "_part_lib": ("lgbt_hist_part_launch", PART_LIBRARY[1][0],
                  _part_launch_costs),
}


class _CountingLib:
    """A loaded kernel library whose launch function records each launch's
    bytes and additions in a cost model before it launches."""

    def __init__(self, lib, launch: str, entry: str, costs, cost_model):
        self._lib = lib
        fn = getattr(lib, launch)

        def counted(*args):
            cost_model.record_launch(entry, *costs(args))
            return fn(*args)
        setattr(self, launch, counted)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def account_launches(cost_model):
    """Record every launch of histogram.cu, hist_slots.cu and hist_part.cu
    in ``cost_model`` (``obs/costmodel.py``) until the returned function is
    called. The libraries' loaders are swapped for counting ones, so
    without this call a wrapper does no accounting work at all. A second
    call while one is active changes nothing and returns a no-op."""
    g = globals()
    if any(isinstance(g[name], functools.partial) for name in _ACCOUNTED):
        return lambda: None
    originals = {name: g[name] for name in _ACCOUNTED}

    def counting_loader(load, launch, entry, costs, cache):
        lib = load()
        if cache.get("lib") is not lib:
            cache["lib"] = lib
            cache["counting"] = _CountingLib(lib, launch, entry, costs,
                                             cost_model)
        return cache["counting"]

    for name, (launch, entry, costs) in _ACCOUNTED.items():
        g[name] = functools.partial(counting_loader, originals[name], launch,
                                    entry, costs, {})

    def stop() -> None:
        g.update(originals)
    return stop
