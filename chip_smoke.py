#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lightgbm_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every CUDA kernel of the port from the sources in this checkout;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version, the one-call
   library yardstick and the memory bound;
4. the main path at full width: bench.py's workload (1,000,000 x 28, numpy
   seed 0), objective=binary, num_leaves=255, max_bin=255, through
   ``lightgbm_tpu_torch.train`` for 5 iterations on CUDA and
   ``Booster.predict`` on the same rows; the kernels' launch counts are
   reset just before and read just after, and the train AUC is held
   against the JAX package's on the same data and parameters;
5. the kernel path against the plain path on the card (200,000 rows, 2
   iterations): trees identical up to f32 gain ties (tests/test_parity.py's
   rule), and raw predictions within 1e-5 when the trees are identical;
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
# parameters, taken on the CPU backend with
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py
JAX_REFERENCE_AUC = 0.962396956613171
AUC_TOLERANCE = 2e-3

MAIN_ROWS, NUM_FEATURES, NUM_ITERS = 1_000_000, 28, 5
PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "verbosity": -1}
COMPARE_ROWS, COMPARE_ITERS = 200_000, 2

# histogram shapes of the main path: the root (K=3 over every row) and the
# fused two-child pass of a split (K=6) at a small and a large leaf
HIST_SHAPES = [(1_000_000, 28, 255, 3), (4_096, 28, 255, 6),
               (262_144, 28, 255, 6)]
HIST_REL_TOL, HIST_ABS_TOL = 1e-5, 1e-6   # |d| <= rel * sum_bin|v| + abs
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
        nbytes = kernels.hist_bytes(n, f, b, k)
        ops = n * f * k
        bound_ms = max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        row = {
            "n": n, "F": f, "B": b, "K": k,
            "max_abs_err": float(err.max()),
            "ms": time_ms(lambda: kernels.build_histogram_cuda(xb, v, b),
                          flush),
            "plain_ms": time_ms(lambda: hist.hist_tile_vals(
                xb, v, b, "plain"), flush),
            "library_ms": time_ms(lambda: torch.zeros(
                (f * b, k), device=dev).index_add_(0, flat, src), flush),
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / MEM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations"),
        }
        log("hist n=%d F=%d B=%d K=%d: max_abs_err=%.3g kernel %.4f ms, "
            "plain %.4f ms, index_add_ %.4f ms, bound %.4f ms (%s)"
            % (n, f, b, k, row["max_abs_err"], row["ms"], row["plain_ms"],
               row["library_ms"], row["bound_ms"], row["bound_by"]))
        rows.append(row)
        del xb, v, got, want, absum, flat, src
    return rows


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

    # ---- 3. kernel against plain, timed --------------------------------
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    hist_rows = check_histogram_kernel(dev, flush)

    # ---- 4. the main path at full width --------------------------------
    x, y = bench_data(MAIN_ROWS)
    kernels.build_histogram_cuda.launches = 0
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, label=y, params=PARAMS).construct()
    bin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bst = lgb.train(PARAMS, ds, num_boost_round=NUM_ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = bst.predict(x)
    predict_s = time.perf_counter() - t0
    launches = kernels.build_histogram_cuda.launches
    train_auc = auc(prob, y)
    leaves = [t.num_leaves_actual for t in bst.models]
    log("main path: binning %.2f s, train %.2f s (%d iterations, %.3f s per "
        "iteration), predict %.3f s, trees %s leaves" % (
            bin_s, train_s, len(bst.models), train_s / len(bst.models),
            predict_s, leaves))
    log("main path: train AUC %.6f (JAX package %.6f), histogram kernel "
        "launches %d" % (train_auc, JAX_REFERENCE_AUC, launches))
    if launches <= 0:
        raise AssertionError("the main path never launched the histogram "
                             "kernel")
    if prob.shape != (MAIN_ROWS,) or not np.isfinite(prob).all():
        raise AssertionError("predictions are not finite [n] probabilities")
    if len(bst.models) != NUM_ITERS:
        raise AssertionError("expected %d trees, got %d"
                             % (NUM_ITERS, len(bst.models)))
    if abs(train_auc - JAX_REFERENCE_AUC) > AUC_TOLERANCE:
        raise AssertionError("train AUC %.6f is more than %g from the JAX "
                             "package's %.6f" % (train_auc, AUC_TOLERANCE,
                                                 JAX_REFERENCE_AUC))
    del ds, bst

    # ---- 5. kernel path against plain path -----------------------------
    xs, ys = x[:COMPARE_ROWS], y[:COMPARE_ROWS]
    forests = {}
    for impl in ("plain", "auto"):
        params = dict(PARAMS, tpu_hist_impl=impl)
        forests[impl] = lgb.train(params, lgb.Dataset(xs, label=ys),
                                  num_boost_round=COMPARE_ITERS)
    identical = trees_match(forests["auto"].models, forests["plain"].models)
    raw_diff = float(np.abs(forests["auto"].predict(xs, raw_score=True)
                            - forests["plain"].predict(xs, raw_score=True))
                     .max())
    log("kernel vs plain path: trees %s, max raw prediction diff %.3g"
        % ("identical" if identical else "equal up to f32 gain ties",
           raw_diff))
    if identical and raw_diff > 1e-5:
        raise AssertionError("identical trees but raw predictions differ by "
                             "%.3g" % raw_diff)

    # ---- 6. result lines -----------------------------------------------
    root = hist_rows[0]
    print(json.dumps({"kernels": [{
        "name": "histogram",
        "route": "cuda",
        "source": "lightgbm_tpu_torch/core/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/core/histogram_pallas.py:67",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in hist_rows),
        "ms": root["ms"], "plain_ms": root["plain_ms"],
        "bound_ms": root["bound_ms"], "bound_by": root["bound_by"],
        "library_ms": root["library_ms"],
        "shapes": hist_rows}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
