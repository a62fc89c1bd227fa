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
   (histogram.cu) at the root and split shapes of exact growth, the slot
   kernel (hist_slots.cu, K=3) at 1,000,000 x 28 x 255 bins with half the
   rows active at S = 16, 128 and 254 slots, and its K=6 parent-slot
   variant at S = 16;
4. the main paths at full width, one per growth mode: bench.py's workload
   (1,000,000 x 28, numpy seed 0), objective=binary, num_leaves=255,
   max_bin=255, through ``lightgbm_tpu_torch.train`` for 5 iterations on
   CUDA and ``Booster.predict`` on the same rows:
     4a ``tree_growth=exact`` (the histogram kernel),
     4b ``tree_growth=frontier`` (the slot kernel, one launch per wave),
     4c ``tree_growth=batched``, ``tree_batch_splits=16`` (the K=6 slot
        kernel, one launch per step);
   every kernel's launch count is reset just before each path and read
   just after, each path must launch its kernels, and its train AUC is
   held against the JAX package's on the same data and parameters;
5. the kernel path against the plain path on the card (200,000 rows, 2
   iterations) for exact, frontier, batched and batched with
   ``tpu_batched_pack=true`` (which launches the slot kernel on its
   batched branch): trees identical up to f32 gain ties
   (tests/test_parity.py's rule), and raw predictions within 1e-5 when
   the trees are identical;
6. a ``kernels`` JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is available.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import device as port_device
from lightgbm_tpu_torch.core import histogram as hist
from lightgbm_tpu_torch.core import kernels
from lightgbm_tpu_torch.metrics import auc

# Train AUC of the JAX package (lightgbm_tpu) on phase 4's data and
# parameters for each growth mode, taken on the CPU backend with
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --growth MODE
JAX_REFERENCE_AUC = {"exact": 0.962396956613171,
                     "frontier": 0.9551457678522898,
                     "batched": 0.9622125789247733}
AUC_TOLERANCE = 2e-3

MAIN_ROWS, NUM_FEATURES, NUM_ITERS = 1_000_000, 28, 5
PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "verbosity": -1}
# the growth modes the port covers, each a path of its own
GROWTH_PARAMS = {"exact": {"tree_growth": "exact"},
                 "frontier": {"tree_growth": "frontier"},
                 "batched": {"tree_growth": "batched",
                             "tree_batch_splits": 16}}
COMPARE_ROWS, COMPARE_ITERS = 200_000, 2

# histogram shapes of the main path: the root (K=3 over every row) and the
# fused two-child pass of a split (K=6) at a small and a large leaf
HIST_SHAPES = [(1_000_000, 28, 255, 3), (4_096, 28, 255, 6),
               (262_144, 28, 255, 6)]
HIST_REL_TOL, HIST_ABS_TOL = 1e-5, 1e-6   # |d| <= rel * sum_bin|v| + abs
# slot histogram shapes (n, F, B, K, S): the frontier's waves at 255
# leaves (S = the wave's splits, up to 254) and the batched step's
# parent-slot pass (K=6, S = tree_batch_splits = 16)
SLOT_SHAPES = [(1_000_000, 28, 255, 3, 16), (1_000_000, 28, 255, 3, 128),
               (1_000_000, 28, 255, 3, 254), (1_000_000, 28, 255, 6, 16)]
SLOT_ACTIVE = 0.5             # share of rows in a slot
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


def check_histogram_kernel(dev, flush):
    """Phase 3: the histogram kernel against its plain version."""
    rows = []
    for n, f, b, k in HIST_SHAPES:
        r = np.random.RandomState(n + k)
        xb = torch.as_tensor(r.randint(0, b, (n, f)).astype(np.uint8),
                             device=dev)
        vals = r.randn(n, k).astype(np.float32)
        if k == 6:
            left = r.rand(n) < 0.5
            vals[:, :3] *= left[:, None]
            vals[:, 3:] *= ~left[:, None]
        v = torch.as_tensor(vals, device=dev)
        got = kernels.build_histogram_cuda(xb, v, b)
        want = hist.hist_tile_vals(xb, v, b, "plain")
        absum = hist.hist_tile_vals(xb, v.abs(), b, "plain")
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
        if bad:
            raise AssertionError("histogram kernel disagrees with the plain "
                                 "version in %d cells at n=%d K=%d"
                                 % (bad, n, k))
        flat = (xb.to(torch.int64)
                + torch.arange(f, device=dev) * b).reshape(-1)
        src = v.unsqueeze(1).expand(n, f, k).reshape(n * f, k).contiguous()
        bound_ms, bound_by = bound(kernels.hist_bytes(n, f, b, k), n * f * k)
        row = {
            "n": n, "F": f, "B": b, "K": k,
            "max_abs_err": float(err.max()),
            "ms": time_ms(lambda: kernels.build_histogram_cuda(xb, v, b),
                          flush),
            "plain_ms": time_ms(lambda: hist.hist_tile_vals(
                xb, v, b, "plain"), flush),
            "library_ms": time_ms(lambda: torch.zeros(
                (f * b, k), device=dev).index_add_(0, flat, src), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("hist n=%d F=%d B=%d K=%d: max_abs_err=%.3g kernel %.4f ms, "
            "plain %.4f ms, index_add_ %.4f ms, bound %.4f ms (%s)"
            % (n, f, b, k, row["max_abs_err"], row["ms"], row["plain_ms"],
               row["library_ms"], row["bound_ms"], row["bound_by"]))
        rows.append(row)
        del xb, v, got, want, absum, flat, src
    return rows


def check_slot_kernels(dev, flush):
    """Phase 3: both slot kernels against their plain versions. Inputs: bins,
    slots with SLOT_ACTIVE of the rows active and slot S // 2 absent,
    values and a go-left selector, made with numpy from a seed."""
    rows = []
    for n, f, b, k, s in SLOT_SHAPES:
        r = np.random.RandomState(n + 7 * s + k)
        xb = torch.as_tensor(r.randint(0, b, (n, f)).astype(np.uint8),
                             device=dev)
        slot_np = r.randint(0, s, n).astype(np.int32)
        slot_np[slot_np == s // 2] = s - 1
        slot_np[r.rand(n) >= SLOT_ACTIVE] = -1
        slot = torch.as_tensor(slot_np, device=dev)
        v = torch.as_tensor(r.randn(n, 3).astype(np.float32), device=dev)
        sel = torch.as_tensor((r.rand(n) < 0.5).astype(np.float32),
                              device=dev)
        if k == 3:
            def kernel():
                return kernels.build_histogram_slots_cuda(xb, slot, v, b, s)

            def plain(vals=v):
                return hist.hist_slots(xb, slot, vals, b, s, "plain")
            src_rows = v
        else:
            def kernel():
                return kernels.build_histogram_slots6_cuda(xb, slot, sel, v,
                                                           b, s)

            def plain(vals=v):
                return hist.hist_slots6(xb, slot, sel, vals, b, s, "plain")
            src_rows = torch.cat([v * sel[:, None], v * (1 - sel[:, None])],
                                 dim=1)
        got, want, absum = kernel(), plain(), plain(v.abs())
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
        if bad or got[s // 2].any():
            raise AssertionError("slot kernel K=%d disagrees with the plain "
                                 "version in %d cells at S=%d (absent slot "
                                 "nonzero: %s)" % (k, bad, s,
                                                   bool(got[s // 2].any())))
        # the library yardstick: one index_add_ over a prebuilt combined
        # (slot, feature, bin) index of the active rows
        act = torch.nonzero(slot >= 0).squeeze(1)
        n_active = int(act.numel())
        flat = ((slot.index_select(0, act).to(torch.int64)[:, None] * f
                 + torch.arange(f, device=dev)) * b
                + xb.index_select(0, act).to(torch.int64)).reshape(-1)
        src = src_rows.index_select(0, act).unsqueeze(1).expand(
            n_active, f, k).reshape(-1, k).contiguous()
        bound_ms, bound_by = bound(
            kernels.slot_hist_bytes(n, n_active, f, b, k, s),
            n_active * f * k)
        row = {
            "n": n, "active": n_active, "F": f, "B": b, "K": k, "S": s,
            "max_abs_err": float(err.max()),
            "ms": time_ms(kernel, flush),
            "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(lambda: torch.zeros(
                (s * f * b, k), device=dev).index_add_(0, flat, src), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("slots n=%d active=%d F=%d B=%d K=%d S=%d: max_abs_err=%.3g "
            "kernel %.4f ms, plain %.4f ms, index_add_ %.4f ms, bound %.4f "
            "ms (%s)" % (n, n_active, f, b, k, s, row["max_abs_err"],
                         row["ms"], row["plain_ms"], row["library_ms"],
                         bound_ms, bound_by))
        rows.append(row)
        del xb, slot, v, sel, src_rows, got, want, absum, flat, src
    return rows


# the kernel wrappers, each with its launch count
COUNTED = (kernels.build_histogram_cuda, kernels.build_histogram_slots_cuda,
           kernels.build_histogram_slots6_cuda)
# the kernels each main path must launch
PATH_KERNELS = {
    "exact": ("build_histogram_cuda",),
    "frontier": ("build_histogram_cuda", "build_histogram_slots_cuda"),
    "batched": ("build_histogram_cuda", "build_histogram_slots6_cuda"),
}


def reset_counts() -> None:
    for wrapper in COUNTED:
        wrapper.launches = 0


def read_counts():
    return {w.__name__: w.launches for w in COUNTED}


def drive_path(growth: str, ds, x, y):
    """Phase 4: one growth mode's main path at full width, with the launch
    counts set to 0 just before and read just after."""
    params = dict(PARAMS, **GROWTH_PARAMS[growth])
    reset_counts()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, num_boost_round=NUM_ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = bst.predict(x)
    predict_s = time.perf_counter() - t0
    launches = read_counts()
    train_auc = auc(prob, y)
    leaves = [t.num_leaves_actual for t in bst.models]
    # one slot-kernel launch per frontier wave or batched step
    waves = {"frontier": launches["build_histogram_slots_cuda"],
             "batched": launches["build_histogram_slots6_cuda"]}.get(growth)
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
                     launches("build_histogram_slots6_cuda"), k6, k6[0])],
        "paths": paths}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
