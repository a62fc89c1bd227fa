"""What training observability costs an iteration on the card.

Trains chip_smoke.py's main-path workload (``chip_smoke.bench_data`` and
``chip_smoke.PARAMS``: bench.py's 1,000,000 x 28 data, numpy seed 0;
binary, num_leaves=255, max_bin=255) under one growth mode at
``observability=none``, ``basic`` and ``full`` in turns (A B C C B A ...),
so that all see the same host and card: each turn builds a booster, warms
it up with one iteration and times one call of
``GBDT.train_many(--block)`` (the loop ``engine.train`` runs: a block at
none and basic, one iteration at a time at full), ended by a device
synchronise; ``--blocks`` turns of each. A fresh booster a turn keeps the
kernels' launch accounting, on under basic and full and process-wide, out
of the none turns. Then one more turn of each under ``torch.profiler``
counts its CUDA launches and synchronisations an iteration, as
``scripts/profile_main_path.py`` counts them. Each turn's forest is
fingerprinted by its trees' structure (split features, bins and
children): the card's f32 sums do not repeat, so runs of one level may
part at gain ties, and the fingerprints show whether a level parts from
none more often than none parts from itself. Prints one JSON line: the
card's name and power limit, and for each level its milliseconds an
iteration per call, their median and quartiles, the launches and syncs
an iteration, and its forests' fingerprints:

    python3 scripts/obs_overhead.py [--growth exact|frontier] \
        [--blocks K] [--block B] [--rows N]

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import statistics
import sys
import time

LEVELS = ("none", "basic", "full")


def profiled(bst, block: int) -> dict:
    """CUDA launches and syncs an iteration of one ``train_many(block)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bst._impl.train_many(block)
        torch.cuda.synchronize()
    events = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events())
    return {"launches_per_iter": sum(events[n] for n in (
                "cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchKernelExC")) / block,
            "syncs_per_iter": sum(events[n] for n in (
                "cudaStreamSynchronize", "cudaDeviceSynchronize")) / block}


def fingerprint(bst) -> str:
    """A short hash of the forest's structure."""
    h = hashlib.sha256()
    for t in bst._impl.models:
        nn = int(t.num_leaves_actual) - 1
        for field in ("split_feature", "threshold_bin", "left_child",
                      "right_child"):
            h.update(getattr(t, field)[:nn].tobytes())
    return h.hexdigest()[:12]


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("obs_overhead: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as port_device
    from lightgbm_tpu_torch.core import kernels
    ap = argparse.ArgumentParser()
    ap.add_argument("--growth", default="frontier",
                    choices=sorted(chip_smoke.GROWTH_PARAMS))
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--rows", type=int, default=chip_smoke.MAIN_ROWS)
    args = ap.parse_args()
    port_device.build_libraries(dict(kernels.LIBRARIES))
    x, y = chip_smoke.bench_data(args.rows)
    params = dict(chip_smoke.PARAMS, verbosity=-1,
                  **chip_smoke.GROWTH_PARAMS[args.growth])
    ds = lgb.Dataset(x, label=y, params=params).construct()

    def booster(level):
        bst = lgb.Booster(params=dict(params, observability=level),
                          train_set=ds)
        bst._impl.train_many(1)                     # warm-up iteration
        torch.cuda.synchronize()
        return bst

    ms = {level: [] for level in LEVELS}
    forests = {level: [] for level in LEVELS}
    for i in range(args.blocks):
        for level in (LEVELS if i % 2 == 0 else LEVELS[::-1]):
            bst = booster(level)
            t0 = time.perf_counter()
            bst._impl.train_many(args.block)
            torch.cuda.synchronize()
            ms[level].append((time.perf_counter() - t0) * 1e3 / args.block)
            forests[level].append(fingerprint(bst))
            bst._impl.obs.finish()
    out = {"card": chip_smoke.card_line(), "growth": args.growth,
           "rows": args.rows, "block": args.block, "levels": {}}
    for level in LEVELS:
        q = statistics.quantiles(ms[level], n=4)
        bst = booster(level)
        out["levels"][level] = dict(
            ms_per_iter=[round(v, 3) for v in ms[level]],
            median_ms=round(statistics.median(ms[level]), 3),
            quartiles_ms=[round(q[0], 3), round(q[2], 3)],
            forests=forests[level],
            **profiled(bst, args.block))
        bst._impl.obs.finish()
    base = out["levels"]["none"]["median_ms"]
    for level in LEVELS[1:]:
        out["levels"][level]["median_over_none"] = round(
            out["levels"][level]["median_ms"] / base, 4)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
