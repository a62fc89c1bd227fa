#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lightgbm_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every CUDA kernel of the port from the sources in this checkout,
   one nvcc per library, all started together;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time kernel, plain version, the one-call
   library yardstick and the memory bound: the histogram kernel
   (histogram.cu), both of its variants, at the root and at five split
   shapes of exact growth (512 to 262,144 rows), with the profiler's
   device time beside the event-timed one and an exact count channel,
   the slot kernel (hist_slots.cu, K=3) at 1,000,000 x 28 x 255 bins with
   half the rows active at S = 2, 16, 128 and 254 slots and its K=6
   parent-slot variant at S = 16, each with the profiler's device time by
   launch, the wrapper's host time and an exact count channel, the
   partitioned-layout kernel (hist_part.cu) on the
   layout of 1,000,000 rows at 255 leaves (745 tiles of 2,048 rows) at the
   four shapes of a 255-leaf tree's steps (PART_SHAPES: S = 1 and 16 with
   every row-holding tile active, S = 16 with a half and an eighth of
   them), each with the profiler's device time by launch, the wrapper's
   host time and an exact count channel, and the in-tile
   partition (repack.cu) at 1,048,576 x 128 bytes, 512-row tiles, 30% of
   the rows going left, which must come back byte-equal;
4. the main paths at full width, one per growth mode: bench.py's workload
   (1,000,000 x 28, numpy seed 0), objective=binary, num_leaves=255,
   max_bin=255, through ``lightgbm_tpu_torch.train`` for 5 iterations on
   CUDA and ``Booster.predict`` on the same rows:
     4a ``tree_growth=exact`` (the histogram kernel),
     4b ``tree_growth=frontier`` (the slot kernel, one launch per wave),
     4c ``tree_growth=batched``, ``tree_batch_splits=16`` (the K=6 slot
        kernel, one launch per step),
     4d the same with ``tpu_batched_part=true`` (the partitioned-layout
        kernel, one launch per step);
   every kernel's launch count is reset just before each path and read
   just after, each path must launch its kernels, and its train AUC is
   held against the JAX package's on the same data and parameters;
5. the kernel path against the plain path on the card (200,000 rows, 2
   iterations) for exact, frontier, batched, batched with
   ``tpu_batched_pack=true`` (which launches the slot kernel on its
   batched branch) and batched_part: trees identical up to f32 gain ties
   (tests/test_parity.py's rule), and raw predictions within 1e-5 when
   the trees are identical;
6. a ``kernels`` JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}``. No grower calls the in-tile
   partition (nor does the JAX package's), so its entry's path launches
   are 0 and its phase-3 calls are its only launches.

Exits non-zero without a result when no CUDA device is available.
"""
from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import device as port_device
from lightgbm_tpu_torch.core import grow_batched_part
from lightgbm_tpu_torch.core import histogram as hist
from lightgbm_tpu_torch.core import kernels
from lightgbm_tpu_torch.core import repack
from lightgbm_tpu_torch.metrics import auc

# Train AUC of the JAX package (lightgbm_tpu) on phase 4's data and
# parameters for each growth mode, taken on the CPU backend with
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --growth MODE
JAX_REFERENCE_AUC = {"exact": 0.962396956613171,
                     "frontier": 0.9551457678522898,
                     "batched": 0.9622125789247733,
                     "batched_part": 0.9622125789247733}
AUC_TOLERANCE = 2e-3

MAIN_ROWS, NUM_FEATURES, NUM_ITERS = 1_000_000, 28, 5
PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "verbosity": -1}
# the growth modes the port covers, each a path of its own
GROWTH_PARAMS = {"exact": {"tree_growth": "exact"},
                 "frontier": {"tree_growth": "frontier"},
                 "batched": {"tree_growth": "batched",
                             "tree_batch_splits": 16},
                 "batched_part": {"tree_growth": "batched",
                                  "tree_batch_splits": 16,
                                  "tpu_batched_part": "true"}}
COMPARE_ROWS, COMPARE_ITERS = 200_000, 2

# histogram shapes of the main path: the root (K=3 over every row) and the
# fused two-child pass of a split (K=6) at the leaf sizes exact growth
# meets (its median split pass has ~7,400 rows)
HIST_SHAPES = [(1_000_000, 28, 255, 3), (512, 28, 255, 6),
               (4_096, 28, 255, 6), (16_384, 28, 255, 6),
               (65_536, 28, 255, 6), (262_144, 28, 255, 6)]
HIST_REL_TOL, HIST_ABS_TOL = 1e-5, 1e-6   # |d| <= rel * sum_bin|v| + abs
# slot histogram shapes (n, F, B, K, S): the frontier's waves at 255
# leaves (S = the wave's splits, from the first waves' 1 or 2 up to 254)
# and the batched step's parent-slot pass (K=6, S = tree_batch_splits =
# 16)
SLOT_SHAPES = [(1_000_000, 28, 255, 3, 2), (1_000_000, 28, 255, 3, 16),
               (1_000_000, 28, 255, 3, 128), (1_000_000, 28, 255, 3, 254),
               (1_000_000, 28, 255, 6, 16)]
SLOT_ACTIVE = 0.5             # share of rows in a slot
# the partitioned-layout kernel on the layout of MAIN_ROWS rows at 255
# leaves: (label, S, share of the row-holding tiles active), the steps of a
# K=16 tree: A its first step, B the step where S reaches 16, C the middle
# steps, D the late ones (16 splits among 100+ leaves)
PART_SHAPES = [("A", 1, 1.0), ("B", 16, 1.0), ("C", 16, 0.5),
               ("D", 16, 0.125)]
# the in-tile partition: rows, width, tile, left share
REPACK_SHAPE = (1_048_576, 128, 512, 0.3)
MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 64 << 20     # more than the 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_data(n: int, f: int = NUM_FEATURES, seed: int = 0):
    """bench.py's workload (bench.py:162-165)."""
    r = np.random.RandomState(seed)
    x = r.randn(n, f).astype(np.float32)
    y = ((x[:, 0] + x[:, 1] * x[:, 2] + 0.5 * np.sin(x[:, 3] * 3)
          + 0.3 * r.randn(n)) > 0).astype(np.float32)
    return x, y


def time_ms(fn, flush, reps: int = 20) -> float:
    """Median device time of one call, measured with CUDA events, with the
    L2 cache evicted before each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the float32 additions over the card's float32 rate."""
    by_bytes, by_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def host_ms(fn, reps: int = 200) -> float:
    """Wall time of one call in a run of back-to-back calls that ends in a
    synchronise: the wrapper's host time where that exceeds the device
    time, the device time otherwise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# a kernel of core/csrc as the profiler names it: its function in the
# sources' anonymous namespace
OWN_KERNEL_KEY = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")


def device_split(fn, flush, reps: int = 10):
    """Mean device time of one call by launch, from torch.profiler:
    {kernel function of core/csrc or "memset": ms}, with the L2 evicted
    before each call (by a fill kernel of PyTorch's, which is not counted).
    None when the profiler recorded fewer of the port's kernels than
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    split, kernels_seen = collections.Counter(), 0
    for a in prof.key_averages():
        if a.device_type != DeviceType.CUDA:
            continue
        own = OWN_KERNEL_KEY.match(a.key)
        if own:
            kernels_seen += a.count
            split[own.group(1)] += a.self_device_time_total / 1e3 / reps
        elif "Memset" in a.key:
            split["memset"] += a.self_device_time_total / 1e3 / reps
    if kernels_seen < reps:
        return None                   # the profiler lost events: not measured
    return dict(split)


def device_ms(fn, flush, reps: int = 10):
    """Mean device time of one call (the port's kernels and the memsets),
    from ``device_split``; None where that is not measured."""
    split = device_split(fn, flush, reps)
    return None if split is None else sum(split.values())


def fmt(ms) -> str:
    return "not measured" if ms is None else "%.4f" % ms


def fmt_split(split) -> str:
    return "not measured" if split is None else ", ".join(
        "%s %.4f" % kv for kv in sorted(split.items()))


def hist_inputs(r, n, f, b, k):
    """Bins and values as the main path stacks them (``stack_vals``): grad,
    hess and a 0/1 count channel, about 10% of the rows masked out; at K=6
    each row's triple goes to the left or the right child."""
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    m = (r.rand(n) < 0.9).astype(np.float32)
    vals = np.stack([r.randn(n) * m, r.rand(n) * m, m], axis=1)
    if k == 6:
        left = (r.rand(n) < 0.5)[:, None]
        vals = np.concatenate([vals * left, vals * ~left], axis=1)
    return xb, vals.astype(np.float32)


def check_histogram_kernel(dev, flush):
    """Phase 3: the histogram kernel against its plain version, each variant
    at every shape (the plan's choice is the one the main path runs)."""
    rows = []
    for n, f, b, k in HIST_SHAPES:
        xb_np, vals = hist_inputs(np.random.RandomState(n + k), n, f, b, k)
        xb = torch.as_tensor(xb_np, device=dev)
        v = torch.as_tensor(vals, device=dev)
        want = hist.hist_tile_vals(xb, v, b, "plain")
        absum = hist.hist_tile_vals(xb, v.abs(), b, "plain")
        picked = kernels.hist_launch_plan(
            n, f, b, k, torch.cuda.get_device_properties(dev)
            .multi_processor_count).variant
        err, variants = None, {}
        for variant in kernels.HIST_VARIANTS:
            def call(variant=variant):
                return kernels.build_histogram_cuda(xb, v, b, variant)
            got = call()
            torch.cuda.synchronize()
            d = (got - want).abs()
            bad = int((d > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
            counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
            if bad or not counts_exact:
                raise AssertionError(
                    "histogram kernel (%s) disagrees with the plain version "
                    "in %d cells at n=%d K=%d (count channel exact: %s)"
                    % (variant, bad, n, k, counts_exact))
            variants[variant] = {
                "ms": time_ms(call, flush),
                "device_ms": device_ms(call, flush)}
            if variant == picked:
                err = d
        flat = (xb.to(torch.int64)
                + torch.arange(f, device=dev) * b).reshape(-1)
        src = v.unsqueeze(1).expand(n, f, k).reshape(n * f, k).contiguous()

        def library():
            return torch.zeros((f * b, k), device=dev).index_add_(0, flat,
                                                                   src)
        bound_ms, bound_by = bound(kernels.hist_bytes(n, f, b, k), n * f * k)
        row = {
            "n": n, "F": f, "B": b, "K": k, "variant": picked,
            "max_abs_err": float(err.max()),
            # the plan's variant, as the main path calls it
            "ms": variants[picked]["ms"],
            "device_ms": variants[picked]["device_ms"],
            "host_ms": host_ms(lambda: kernels.build_histogram_cuda(xb, v,
                                                                    b)),
            "variants": variants,
            "plain_ms": time_ms(lambda: hist.hist_tile_vals(
                xb, v, b, "plain"), flush),
            "library_ms": time_ms(library, flush),
            "library_host_ms": host_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("hist n=%d F=%d B=%d K=%d (%s): max_abs_err=%.3g, count channel "
            "exact, kernel %.4f ms (device %s, host %.4f; variants, event "
            "/ device ms: %s), plain %.4f ms, index_add_ %.4f ms (host "
            "%.4f), bound %.4f ms (%s)"
            % (n, f, b, k, picked, row["max_abs_err"], row["ms"],
               fmt(row["device_ms"]), row["host_ms"],
               ", ".join("%s %.4f / %s" % (name, t["ms"],
                                            fmt(t["device_ms"]))
                         for name, t in variants.items()),
               row["plain_ms"], row["library_ms"], row["library_host_ms"],
               row["bound_ms"], row["bound_by"]))
        rows.append(row)
        del xb, v, got, want, absum, flat, src, err, d
    return rows


def slot_inputs(dev, n, f, b, k, s):
    """Bins, slots with SLOT_ACTIVE of the rows active (slot S // 2 absent
    where S > 2), values as the main path stacks them (grad, hess and a
    count channel of ones) and a go-left selector, made with numpy from a
    seed."""
    r = np.random.RandomState(n + 7 * s + k)
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    slot = r.randint(0, s, n).astype(np.int32)
    if s > 2:
        slot[slot == s // 2] = s - 1
    slot[r.rand(n) >= SLOT_ACTIVE] = -1
    vals = np.stack([r.randn(n), r.rand(n), np.ones(n)], axis=1)
    sel = (r.rand(n) < 0.5).astype(np.float32)
    return [torch.as_tensor(a, device=dev)
            for a in (xb, slot, vals.astype(np.float32), sel)]


def slot_call(kern, xb, slot, v, sel, b, s, k):
    """One call of the K=3 or K=6 slot wrapper of ``kern`` (a kernels
    module: this checkout's, or another's when comparing two)."""
    if k == 3:
        return kern.build_histogram_slots_cuda(xb, slot, v, b, s)
    return kern.build_histogram_slots6_cuda(xb, slot, sel, v, b, s)


def slot_plain(xb, slot, v, sel, b, s, k):
    if k == 3:
        return hist.hist_slots(xb, slot, v, b, s, "plain")
    return hist.hist_slots6(xb, slot, sel, v, b, s, "plain")


def check_slot_result(got, want, absum, s, k) -> float:
    """Raises unless |got - want| <= 1e-5 * sum|v| + 1e-6 in every cell,
    the count channels are exact and (S > 2) slot S // 2 is zero; returns
    the largest difference."""
    err = (got - want).abs()
    bad = int((err > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
    counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
    absent = s > 2 and bool(got[s // 2].any())
    if bad or not counts_exact or absent:
        raise AssertionError("slot kernel K=%d disagrees with the plain "
                             "version in %d cells at S=%d (count channel "
                             "exact: %s, absent slot nonzero: %s)"
                             % (k, bad, s, counts_exact, absent))
    return float(err.max())


def slot_library(xb, slot, v, sel, b, s, k):
    """The library yardstick of a slot shape: one index_add_ over a
    prebuilt combined (slot, feature, bin) index of the active rows.
    Returns the call and the active-row count."""
    f, dev = xb.shape[1], xb.device
    src_rows = v if k == 3 else torch.cat(
        [v * sel[:, None], v * (1 - sel[:, None])], dim=1)
    act = torch.nonzero(slot >= 0).squeeze(1)
    n_active = int(act.numel())
    flat = ((slot.index_select(0, act).to(torch.int64)[:, None] * f
             + torch.arange(f, device=dev)) * b
            + xb.index_select(0, act).to(torch.int64)).reshape(-1)
    src = src_rows.index_select(0, act).unsqueeze(1).expand(
        n_active, f, k).reshape(-1, k).contiguous()

    def library():
        return torch.zeros((s * f * b, k), device=dev).index_add_(0, flat,
                                                                   src)
    return library, n_active


def check_slot_kernels(dev, flush):
    """Phase 3: both slot kernels against their plain versions
    (``slot_inputs``), each timed with events, by launch with the profiler,
    and back to back on the host."""
    rows = []
    for n, f, b, k, s in SLOT_SHAPES:
        xb, slot, v, sel = slot_inputs(dev, n, f, b, k, s)

        def kernel():
            return slot_call(kernels, xb, slot, v, sel, b, s, k)

        def plain(vals=v):
            return slot_plain(xb, slot, vals, sel, b, s, k)
        got, want, absum = kernel(), plain(), plain(v.abs())
        torch.cuda.synchronize()
        max_err = check_slot_result(got, want, absum, s, k)
        library, n_active = slot_library(xb, slot, v, sel, b, s, k)
        bound_ms, bound_by = bound(
            kernels.slot_hist_bytes(n, n_active, f, b, k, s),
            n_active * f * k)
        split = device_split(kernel, flush)
        row = {
            "n": n, "active": n_active, "F": f, "B": b, "K": k, "S": s,
            "max_abs_err": max_err,
            "ms": time_ms(kernel, flush),
            "device_ms": None if split is None else sum(split.values()),
            "device_split": split,
            "host_ms": host_ms(kernel),
            "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "library_host_ms": host_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("slots n=%d active=%d F=%d B=%d K=%d S=%d: max_abs_err=%.3g, "
            "count channel exact, kernel %.4f ms (device %s: %s; host "
            "%.4f), plain %.4f ms, index_add_ %.4f ms (host %.4f), bound "
            "%.4f ms (%s)" % (n, n_active, f, b, k, s, max_err, row["ms"],
                              fmt(row["device_ms"]), fmt_split(split),
                              row["host_ms"], row["plain_ms"],
                              row["library_ms"], row["library_host_ms"],
                              bound_ms, bound_by))
        rows.append(row)
        del xb, slot, v, sel, got, want, absum, library
    return rows


def part_layout(r, n, num_leaves, f, b, n_slots, share=0.5):
    """A partitioned layout of ``n`` rows at ``num_leaves`` leaves, made with
    numpy: ``share`` of the row-holding tiles in contiguous runs of every
    slot but S // 2 (of as many slots as there are such tiles), an inactive
    tile after each run, each run ending in zero-valued segment padding.
    Values as the main path stacks them: grad, hess and a count channel of
    ones, all zero on the padding. Returns numpy (xb_fm, sel, vals3,
    tile_slot, tile_first) and the row tile."""
    tile = grow_batched_part.PART_TILE
    np_ = grow_batched_part._part_capacity(n, num_leaves, tile)
    n_tiles = np_ // tile
    xb_fm = r.randint(0, b, (f, np_)).astype(np.uint8)
    sel = (r.rand(np_) < 0.5).astype(np.float32)
    vals3 = np.stack([r.randn(np_), r.rand(np_),
                      np.ones(np_)]).astype(np.float32)
    active = max(1, int(round(-(-n // tile) * share)))
    owners = [s for s in r.permutation(n_slots) if s != n_slots // 2
              or n_slots <= 2][:active]
    cuts = np.sort(r.choice(np.arange(1, active), len(owners) - 1,
                            replace=False))
    bounds = np.concatenate([[0], cuts, [active]]).astype(int)
    tile_slot = np.full(n_tiles, -1, np.int32)
    t = 0
    for s, a, z in zip(owners, bounds[:-1], bounds[1:]):
        tile_slot[t:t + z - a] = s
        end = (t + z - a) * tile
        vals3[:, end - r.randint(1, tile):end] = 0.0
        t += z - a + 1
    prev = np.concatenate([[-2], tile_slot[:-1]])
    first = ((tile_slot >= 0) & (tile_slot != prev)).astype(np.int32)
    return (xb_fm, sel, vals3, tile_slot, first), tile


def part_inputs(dev, s, share):
    """chip_smoke's part layout of MAIN_ROWS rows at 255 leaves on ``dev``:
    torch (xb_fm, sel, vals3, tile_slot, tile_first) and the row tile."""
    arrays, tile = part_layout(np.random.RandomState(11 + s), MAIN_ROWS, 255,
                               NUM_FEATURES, 255, s, share)
    return [torch.as_tensor(a, device=dev) for a in arrays], tile


def part_call(kern, inputs, b, s, tile):
    """One call of the part wrapper of ``kern`` (a kernels module: this
    checkout's, or another's when comparing two)."""
    return kern.build_histogram_part_tiles_cuda(*inputs, b, s, tile)


def part_plain(inputs, b, s, tile, vals=None):
    xb_fm, sel, vals3, tile_slot, first = inputs
    return hist.hist_part_tiles(xb_fm, sel, vals3 if vals is None else vals,
                                tile_slot, first, b, s, tile, "plain")


def check_part_result(got, want, absum, tile_slot, s) -> float:
    """Raises unless |got - want| <= 1e-5 * sum|v| + 1e-6 in every cell,
    the count channels are exact and every slot that owns no tile (S // 2
    where S > 2) is zero; returns the largest difference."""
    err = (got - want).abs()
    bad = int((err > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
    counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
    owned = torch.zeros(s, dtype=torch.bool, device=got.device)
    owned[tile_slot[tile_slot >= 0].clamp(max=s - 1).long()] = True
    absent = bool(got[~owned].any())
    if bad or not counts_exact or absent:
        raise AssertionError("part kernel disagrees with the plain version "
                             "in %d cells at S=%d (count channel exact: %s, "
                             "absent slot nonzero: %s)"
                             % (bad, s, counts_exact, absent))
    return float(err.max())


def part_library(inputs, b, s, tile):
    """The library yardstick of a part shape: one index_add_ over a prebuilt
    combined (slot, child, feature, bin) index of the active tiles' rows.
    Returns the call, the active tiles and the active rows."""
    xb_fm, sel, vals3, tile_slot, _ = inputs
    f, dev = xb_fm.shape[0], xb_fm.device
    row_slot = tile_slot.to(torch.int64).repeat_interleave(tile)
    act = torch.nonzero(row_slot >= 0).squeeze(1)
    n_act = int(act.numel())
    child = (sel.index_select(0, act) == 0).to(torch.int64)
    flat = (((row_slot.index_select(0, act) * 2 + child)[:, None] * f
             + torch.arange(f, device=dev)) * b
            + xb_fm.index_select(1, act).t().to(torch.int64)).reshape(-1)
    src = vals3.index_select(1, act).t().unsqueeze(1).expand(
        n_act, f, 3).reshape(-1, 3).contiguous()

    def library():
        return torch.zeros((2 * s * f * b, 3), device=dev).index_add_(
            0, flat, src)
    return library, int((tile_slot >= 0).sum()), n_act


def check_part_kernel(dev, flush):
    """Phase 3: the partitioned-layout kernel against its plain version at
    each of PART_SHAPES, timed with events, by launch with the profiler,
    and back to back on the host."""
    rows = []
    f, b = NUM_FEATURES, 255
    for label, s, share in PART_SHAPES:
        inputs, tile = part_inputs(dev, s, share)

        def kernel():
            return part_call(kernels, inputs, b, s, tile)

        def plain(vals=None):
            return part_plain(inputs, b, s, tile, vals)
        got, want, absum = kernel(), plain(), plain(inputs[2].abs())
        torch.cuda.synchronize()
        max_err = check_part_result(got, want, absum, inputs[3], s)
        library, active_tiles, n_act = part_library(inputs, b, s, tile)
        n_tiles = int(inputs[3].numel())
        bound_ms, bound_by = bound(
            kernels.part_hist_bytes(active_tiles, n_tiles, tile, f, b, s),
            n_act * f * 6)
        split = device_split(kernel, flush)
        row = {
            "shape": label, "Np": int(inputs[0].shape[1]), "tiles": n_tiles,
            "active_tiles": active_tiles, "F": f, "B": b, "S": s,
            "max_abs_err": max_err,
            "ms": time_ms(kernel, flush),
            "device_ms": None if split is None else sum(split.values()),
            "device_split": split,
            "host_ms": host_ms(kernel),
            "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "library_host_ms": host_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("part %s Np=%d tiles=%d active=%d F=%d B=%d S=%d: "
            "max_abs_err=%.3g, count channel exact, kernel %.4f ms (device "
            "%s: %s; host %.4f), plain %.4f ms, index_add_ %.4f ms (host "
            "%.4f), bound %.4f ms (%s)"
            % (label, row["Np"], n_tiles, active_tiles, f, b, s, max_err,
               row["ms"], fmt(row["device_ms"]), fmt_split(split),
               row["host_ms"], row["plain_ms"], row["library_ms"],
               row["library_host_ms"], bound_ms, bound_by))
        rows.append(row)
        del inputs, got, want, absum, library
    return rows


def check_partition_kernel(dev, flush):
    """Phase 3: the in-tile partition against its plain version, byte for
    byte."""
    n, c, tile, p_left = REPACK_SHAPE
    r = np.random.RandomState(13)
    rows = torch.as_tensor(r.randint(0, 256, (n, c)).astype(np.uint8),
                           device=dev)
    gl = torch.as_tensor(r.rand(n) < p_left, device=dev)

    def kernel():
        return kernels.partition_tiles_cuda(rows, gl, tile)

    def plain():
        return repack.partition_tiles(rows, gl, tile, "plain")
    (got, got_cnt), (want, want_cnt) = kernel(), plain()
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got_cnt, want_cnt)):
        raise AssertionError("partition kernel is not byte-equal to the "
                             "plain version")
    # the library yardstick: the gather the JAX grower moves rows with, on
    # a prebuilt permutation (each tile's go-left rows first, stably)
    key = torch.arange(n, device=dev) // tile * 2 + (~gl).to(torch.int64)
    perm = torch.argsort(key, stable=True)
    if not torch.equal(rows.index_select(0, perm), want):
        raise AssertionError("the yardstick's permutation is not the "
                             "partition")
    bound_ms, bound_by = bound(kernels.partition_bytes(n, c, tile), 0)
    row = {"n": n, "C": c, "row_tile": tile, "p_left": p_left,
           "max_abs_err": 0.0,
           "ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
           "library_ms": time_ms(lambda: rows.index_select(0, perm), flush),
           "bound_ms": bound_ms, "bound_by": bound_by}
    log("partition n=%d C=%d tile=%d: byte-equal, kernel %.4f ms, plain "
        "%.4f ms, index_select %.4f ms, bound %.4f ms (%s)"
        % (n, c, tile, row["ms"], row["plain_ms"], row["library_ms"],
           bound_ms, bound_by))
    return [row]


# the kernel wrappers, each with its launch count
COUNTED = (kernels.build_histogram_cuda, kernels.build_histogram_slots_cuda,
           kernels.build_histogram_slots6_cuda,
           kernels.build_histogram_part_tiles_cuda,
           kernels.partition_tiles_cuda)
# the kernels each main path must launch
PATH_KERNELS = {
    "exact": ("build_histogram_cuda",),
    "frontier": ("build_histogram_cuda", "build_histogram_slots_cuda"),
    "batched": ("build_histogram_cuda", "build_histogram_slots6_cuda"),
    "batched_part": ("build_histogram_cuda",
                     "build_histogram_part_tiles_cuda"),
}
# the wrapper launched once per wave or step of a wave path
WAVE_KERNEL = {"frontier": "build_histogram_slots_cuda",
               "batched": "build_histogram_slots6_cuda",
               "batched_part": "build_histogram_part_tiles_cuda"}


def reset_counts() -> None:
    for wrapper in COUNTED:
        wrapper.launches = 0


def read_counts():
    return {w.__name__: w.launches for w in COUNTED}


def drive_path(growth: str, ds, x, y):
    """Phase 4: one growth mode's main path at full width, with the launch
    counts set to 0 just before and read just after."""
    params = dict(PARAMS, **GROWTH_PARAMS[growth])
    # the partitioned grower's steps, each of which calls hist_part_tiles
    steps = []
    dispatch = grow_batched_part.hist_part_tiles

    def counted(*args):
        steps.append(1)
        return dispatch(*args)
    grow_batched_part.hist_part_tiles = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=NUM_ITERS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        grow_batched_part.hist_part_tiles = dispatch
    t0 = time.perf_counter()
    prob = bst.predict(x)
    predict_s = time.perf_counter() - t0
    launches = read_counts()
    train_auc = auc(prob, y)
    leaves = [t.num_leaves_actual for t in bst.models]
    # one slot-kernel launch per frontier wave or batched step
    waves = launches[WAVE_KERNEL[growth]] if growth in WAVE_KERNEL else None
    log("path %s: train %.2f s (%d iterations, %.3f s per iteration), "
        "predict %.3f s, trees %s leaves%s" % (
            growth, train_s, len(bst.models), train_s / len(bst.models),
            predict_s, leaves,
            ", %.1f waves per tree" % (waves / len(bst.models))
            if waves is not None else ""))
    log("path %s: train AUC %.6f (JAX package %.6f), launches %s"
        % (growth, train_auc, JAX_REFERENCE_AUC[growth], launches))
    for name in PATH_KERNELS[growth]:
        if launches[name] <= 0:
            raise AssertionError("path %s never launched %s" % (growth, name))
    if launches["build_histogram_cuda"] < len(bst.models):
        raise AssertionError("path %s built fewer root histograms than "
                             "trees" % growth)
    if growth == "batched_part" and launches[WAVE_KERNEL[growth]] != \
            len(steps):
        raise AssertionError("path batched_part launched the part kernel "
                             "%d times in %d steps"
                             % (launches[WAVE_KERNEL[growth]], len(steps)))
    if prob.shape != (len(x),) or not np.isfinite(prob).all():
        raise AssertionError("predictions are not finite [n] probabilities")
    if len(bst.models) != NUM_ITERS:
        raise AssertionError("expected %d trees, got %d"
                             % (NUM_ITERS, len(bst.models)))
    if abs(train_auc - JAX_REFERENCE_AUC[growth]) > AUC_TOLERANCE:
        raise AssertionError("path %s: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f"
                             % (growth, train_auc, AUC_TOLERANCE,
                                JAX_REFERENCE_AUC[growth]))
    return {"train_s": train_s, "s_per_iter": train_s / len(bst.models),
            "predict_s": predict_s, "auc": train_auc, "leaves": leaves,
            "waves_per_tree": (waves / len(bst.models)
                               if waves is not None else None),
            "launches": launches}


# phase 5: (label, parameters over PARAMS, the wrapper the kernel run must
# launch)
COMPARE_RUNS = [
    ("exact", GROWTH_PARAMS["exact"], "build_histogram_cuda"),
    ("frontier", GROWTH_PARAMS["frontier"], "build_histogram_slots_cuda"),
    ("batched", GROWTH_PARAMS["batched"], "build_histogram_slots6_cuda"),
    ("batched_pack", dict(GROWTH_PARAMS["batched"], tpu_batched_pack=True),
     "build_histogram_slots_cuda"),
    ("batched_part", GROWTH_PARAMS["batched_part"],
     "build_histogram_part_tiles_cuda"),
]


def compare_paths(ds, xs):
    """Phase 5: kernel path against plain path for each growth mode."""
    out = {}
    for label, extra, wrapper in COMPARE_RUNS:
        forests = {}
        for impl in ("plain", "auto"):
            reset_counts()
            forests[impl] = lgb.train(dict(PARAMS, tpu_hist_impl=impl,
                                           **extra),
                                      ds, num_boost_round=COMPARE_ITERS)
            counts = read_counts()
            if (counts[wrapper] > 0) != (impl == "auto"):
                raise AssertionError("%s %s path: %s launched %d times"
                                     % (label, impl, wrapper,
                                        counts[wrapper]))
        identical = trees_match(forests["auto"].models,
                                forests["plain"].models)
        raw_diff = float(np.abs(forests["auto"].predict(xs, raw_score=True)
                                - forests["plain"].predict(xs, raw_score=True))
                         .max())
        log("kernel vs plain path, %s: trees %s, max raw prediction diff "
            "%.3g, %s launches %d" % (
                label, "identical" if identical
                else "equal up to f32 gain ties", raw_diff, wrapper,
                counts[wrapper]))
        if identical and raw_diff > 1e-5:
            raise AssertionError("%s: identical trees but raw predictions "
                                 "differ by %.3g" % (label, raw_diff))
        out[label] = {"identical": identical, "max_raw_diff": raw_diff}
    return out


def trees_match(a, b) -> bool:
    """True when the forests are structurally identical. Otherwise they
    must satisfy the tie rule of tests/test_parity.py, or this raises."""
    identical = True
    for ta, tb in zip(a, b):
        nn = ta.num_leaves_actual - 1
        if tb.num_leaves_actual - 1 != nn:
            raise AssertionError("kernel and plain trees differ in size")
        same = all(np.array_equal(getattr(ta, k)[:nn], getattr(tb, k)[:nn])
                   for k in ("split_feature", "threshold_bin", "left_child",
                             "right_child"))
        if same:
            continue
        identical = False
        mism = np.flatnonzero(ta.split_feature[:nn] != tb.split_feature[:nn])
        ca = collections.Counter(zip(ta.split_feature[:nn].tolist(),
                                     np.round(ta.threshold[:nn], 9)))
        cb = collections.Counter(zip(tb.split_feature[:nn].tolist(),
                                     np.round(tb.threshold[:nn], 9)))
        sym = sum(((ca - cb) + (cb - ca)).values())
        gain_rel = abs(ta.split_gain[:nn].sum() - tb.split_gain[:nn].sum()) \
            / max(abs(tb.split_gain[:nn].sum()), 1e-30)
        log("tie flip: %d positional mismatches, %d substituted splits, "
            "gain sum rel diff %.2g" % (len(mism), sym, gain_rel))
        if len(mism) > 6 or sym > 4 or gain_rel > 1e-3:
            raise AssertionError("kernel and plain trees differ beyond the "
                                 "f32 tie rule")
    return identical


def kernel_entry(name, source, replaces, launches, rows, headline):
    """One kernel of the ``kernels`` line: its headline shape's times and
    every shape it was checked at."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": headline["ms"], "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"],
            "library_ms": headline["library_ms"], "shapes": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU",
              file=sys.stderr)
        return 2

    # ---- 1. the card ---------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    log("card: %s" % card)
    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                           torch.version.cuda,
                                           sys.version.split()[0]))

    # ---- 2. build every kernel from the sources ------------------------
    t0 = time.perf_counter()
    builds = port_device.build_libraries(dict(kernels.LIBRARIES))
    log("build: %.2f s for %s" % (time.perf_counter() - t0,
                                   sorted(builds) or "(cached)"))
    for rec in builds.values():
        for line in rec.log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log("  ptxas %s: %s" % (rec.name, line.strip()))
        log("  %s built in %.2f s" % (rec.name, rec.seconds))

    # ---- 3. kernels against plain, timed -------------------------------
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    hist_rows = check_histogram_kernel(dev, flush)
    slot_rows = check_slot_kernels(dev, flush)
    part_rows = check_part_kernel(dev, flush)
    repack_rows = check_partition_kernel(dev, flush)
    del flush

    # ---- 4. the main paths at full width -------------------------------
    x, y = bench_data(MAIN_ROWS)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, label=y, params=PARAMS).construct()
    log("binning: %.2f s for %d x %d" % (time.perf_counter() - t0,
                                          *x.shape))
    paths = {g: drive_path(g, ds, x, y) for g in GROWTH_PARAMS}
    del ds

    # ---- 5. kernel path against plain path -----------------------------
    xs, ys = x[:COMPARE_ROWS], y[:COMPARE_ROWS]
    compare_paths(lgb.Dataset(xs, label=ys, params=PARAMS).construct(), xs)

    # ---- 6. result lines -----------------------------------------------
    def launches(name):
        return sum(p["launches"][name] for p in paths.values())

    k3 = [r for r in slot_rows if r["K"] == 3]
    k6 = [r for r in slot_rows if r["K"] == 6]
    print(json.dumps({"kernels": [
        kernel_entry("histogram", "lightgbm_tpu_torch/core/csrc/histogram.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:67",
                     launches("build_histogram_cuda"), hist_rows,
                     hist_rows[0]),
        kernel_entry("hist_slots",
                     "lightgbm_tpu_torch/core/csrc/hist_slots.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:384",
                     launches("build_histogram_slots_cuda"), k3,
                     max(k3, key=lambda r: r["S"])),
        kernel_entry("hist_slots6",
                     "lightgbm_tpu_torch/core/csrc/hist_slots.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:175",
                     launches("build_histogram_slots6_cuda"), k6, k6[0]),
        kernel_entry("hist_part", "lightgbm_tpu_torch/core/csrc/hist_part.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:264",
                     launches("build_histogram_part_tiles_cuda"), part_rows,
                     next(r for r in part_rows if r["shape"] == "C")),
        dict(kernel_entry("partition_tiles",
                          "lightgbm_tpu_torch/core/csrc/repack.cu",
                          "lightgbm_tpu/core/repack_pallas.py:31",
                          launches("partition_tiles_cuda"), repack_rows,
                          repack_rows[0]),
             note="no grower calls partition_tiles (the JAX package's do "
                  "not either), so no path launches it; its phase-3 calls "
                  "are its only launches")],
        "paths": paths}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
