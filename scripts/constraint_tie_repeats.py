"""How often phase 5's constraint rows meet chip_smoke.py's tie rule.

Trains each constraint row of chip_smoke.py's phase 5 (bench.py's data,
200,000 rows, 2 iterations: every grower but batched_pack under
MONOTONE_CONSTRAINTS, and exact with forced splits and CEGB) once on the
plain path with float64 histogram sums, then ``--reps`` times on the
kernel path, and holds each repetition to the float64 forest with
``chip_smoke.trees_match`` under the row's ``chip_smoke.tie_limits``.
With ``--replain`` each repetition retrains the float64 plain forest too
(its ``index_add_`` atomics add in another order each run as well), and
with ``--dump FILE`` every repetition that breaks the rule is pickled
there (row, repetition, both forests, the ties, the error).
The kernels' float32 atomics add in another order each run, so the
repetitions are different summation orders. Prints, per row, how many
repetitions break the rule, the kinds of tie the others parted at
(``chip_smoke.parting_tie``), and the largest difference, relative to the
root's gain and to their own, of the gains of tree 0's splits that both
forests make on the same rows.

With ``--profile-cost`` it then times one exact iteration at 1,000,000
rows under torch.profiler, and the two ways of counting its launches and
synchronisations: the profiler's summary (``key_averages``) and a count of
its raw events (``chip_smoke.iteration_counts``).

    python3 scripts/constraint_tie_repeats.py [--reps N] [--replain]
        [--dump FILE] [--profile-cost]

Needs a CUDA device; exits non-zero without one, or when a row breaks the
rule.
"""
from __future__ import annotations

import argparse
import collections
import os
import pickle
import sys
import tempfile
import time


def profile_cost(cs, lgb) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    x, y = cs.bench_data(cs.MAIN_ROWS)
    ds = lgb.Dataset(x, label=y, params=cs.PARAMS).construct()
    bst = lgb.Booster(params=dict(cs.PARAMS, **cs.GROWTH_PARAMS["exact"]),
                      train_set=ds)
    bst.update()
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
             "cudaStreamSynchronize", "cudaDeviceSynchronize")
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bst.update()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        events = collections.Counter(
            e.name() for e in prof.profiler.kineto_results.events())
        raw = {k: events[k] for k in names}
        t2 = time.perf_counter()
        summary = {a.key: a.count for a in prof.key_averages()
                   if a.key in names}
        t3 = time.perf_counter()
        print("profiled exact iteration %d: %.2f s; raw event count %.2f s "
              "%s; key_averages %.2f s %s" % (rep, t1 - t0, t2 - t1, raw,
                                              t3 - t2, summary), flush=True)


def shared_gains(cs, ta, tb, rows) -> tuple:
    """The largest difference of two trees' gains on the splits both make
    on the same rows (``chip_smoke.node_rows``), relative to the root's
    gain and to the split's own."""
    index, out = {}, [0.0, 0.0]
    for t, side in ((tb, 1), (ta, 0)):
        nn = int(t.num_leaves_actual) - 1
        split, right = cs.node_rows(t, nn, rows)
        for i in range(nn):
            key = (int(split[i]), int(right[i]), int(t.split_feature[i]),
                   int(t.threshold_bin[i]))
            if side:
                index[key] = i
            elif key in index:
                diff = abs(float(t.split_gain[i]
                                 - tb.split_gain[index[key]]))
                out = [max(out[0], diff / abs(float(tb.split_gain[0]))),
                       max(out[1], diff / max(abs(float(
                           tb.split_gain[index[key]])), 1e-30))]
    return tuple(out)


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as port_device
    from lightgbm_tpu_torch.core import kernels
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--replain", action="store_true")
    ap.add_argument("--dump")
    ap.add_argument("--profile-cost", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print("card: %s" % cs.card_line(), flush=True)
    port_device.build_libraries(dict(kernels.LIBRARIES))
    x, y = cs.bench_data(cs.COMPARE_ROWS)
    ds = lgb.Dataset(x, label=y, params=cs.PARAMS).construct()
    rows = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    failed, dumped = 0, []
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra, _ in cs.constraint_compare_runs(tmp):
            params = dict(cs.PARAMS, tpu_hist_impl="plain", **extra)
            plain = cs.train_compared(params, ds, True).models
            fails, kinds, shared = 0, collections.Counter(), (0.0, 0.0)
            for rep in range(args.reps):
                if args.replain and rep:
                    plain = cs.train_compared(params, ds, True).models
                models = cs.train_compared(dict(params, tpu_hist_impl="auto"),
                                           ds, False).models
                ties = []
                try:
                    cs.trees_match(models, plain, ties,
                                   *cs.tie_limits(params, False), rows)
                except AssertionError as e:
                    fails += 1
                    print("row %s, repetition %d breaks the rule: %s"
                          % (label, rep, e), flush=True)
                    if args.dump:
                        dumped.append({"row": label, "rep": rep,
                                       "kernel": models, "plain": plain,
                                       "ties": ties, "error": str(e)})
                        with open(args.dump, "wb") as f:
                            pickle.dump(dumped, f)
                kinds.update(t["parting_tie"][1] for t in ties
                             if t["parting_tie"] is not None)
                shared = tuple(map(max, shared, shared_gains(
                    cs, models[0], plain[0], rows)))
            failed += fails
            print("row %s: %d of %d repetitions break the rule; located "
                  "ties %s; tree 0's shared splits' gains up to %.3g of "
                  "the root's apart, %.3g of their own"
                  % (label, fails, args.reps, dict(kinds), *shared),
                  flush=True)
    if args.profile_cost:
        profile_cost(cs, lgb)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
