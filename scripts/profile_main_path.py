"""Where one training iteration of the PyTorch port spends its time.

Trains chip_smoke.py's main-path workload (bench.py's 1,000,000 x 28 data,
numpy seed 0; binary, num_leaves=255, max_bin=255) on the CUDA device,
under one growth mode (``--growth``: chip_smoke.GROWTH_PARAMS, exact,
frontier, batched with tree_batch_splits=16, or batched_part, the same
with tpu_batched_part=true): one warm-up iteration,
``--iters`` timed iterations, then ``--iters`` more under torch.profiler.
Prints the iteration wall time (timed without the profiler), the device
busy time (kernels only) and idle share, the device time by kernel, the
host time by operator, the counts of kernel launches and device-to-host
synchronisations, and the port's own kernels' launches per iteration
(one slot-kernel or part-kernel launch per frontier wave or batched
step), then one JSON line.

With ``--objective`` (regression, huber, quantile, regression_l1, ...) it
trains that objective on bench.py's target before its threshold
(``chip_smoke.regression_data``) instead of the binary labels, so the
regression paths' renewal and score updates show in the profile;
``--objective multiclass`` (or ``multiclassova``) trains chip_smoke.py's
multiclass workload (``chip_smoke.multiclass_data``: 500,000 rows by
default, 5 classes, 5 trees an iteration), its paths 4r-4u.
``--data bundled`` trains the binary labels of chip_smoke.py's bundled
workload instead (``chip_smoke.bundled_data``: HIGGS's b-tags and 8
one-hot blocks of 32, 284 features stored in 34 columns), its paths
4i-4l; ``--data categorical`` its categorical workload
(``chip_smoke.categorical_data``: 28 features and four id columns passed
as ``categorical_feature``), its paths 4m-4p. ``--data ranking`` trains
lambdarank (``--objective lambdarank``, the default there) on its ranking
workload (``chip_smoke.ranking_data``: 500,000 rows in consecutive queries
of 50-150 docs, relevance 0-4, with its ranking metrics), its paths 4v-4y;
``--objective xentropy`` or ``xentlambda`` trains on
``chip_smoke.xentropy_data`` (labels ``sigmoid(t)``, xentlambda with its
weights), its paths 4z-4za.

Row sampling, as chip_smoke.py's paths 4zb-4zg set it: ``--boosting
gbdt|goss|dart|rf`` and ``--bagging-fraction``, ``--bagging-freq``,
``--feature-fraction``, ``--top-rate``, ``--other-rate``,
``--learning-rate``, ``--drop-rate``, ``--skip-drop`` set the parameters
of those names. Under GOSS the warm-up runs ``int(1 / learning_rate)``
iterations, so that the profiled ones sample.

``--gpu-use-dp`` sets ``gpu_use_dp=true``: float64 histograms through
histogram.cu's f64 variant, in exact growth (chip_smoke.py's paths
4zn-4zp; other growth modes fall back to exact, as the JAX package's do).

    python3 scripts/profile_main_path.py [--growth MODE] [--rows N] \
        [--iters K] [--objective binary|multiclass|OBJECTIVE] \
        [--data dense|bundled|categorical|ranking] \
        [--boosting gbdt|goss|dart|rf] [--bagging-fraction F] \
        [--bagging-freq K] [--feature-fraction F] [--top-rate F] \
        [--other-rate F] [--learning-rate F] [--drop-rate F] \
        [--skip-drop F] [--gpu-use-dp]

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings


# the device functions of core/csrc: histogram.cu, hist_slots.cu,
# hist_part.cu, then repack.cu
OWN_KERNELS = ("hist_direct_kernel", "hist_block_kernel", "count_kernel",
               "scan_kernel", "scatter_kernel", "slot_hist_kernel",
               "part_list_kernel", "part_run_hist_kernel",
               "partition_tile_kernel")


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int,
                    help="rows (1,000,000; multiclass 500,000)")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--growth", choices=sorted(chip_smoke.GROWTH_PARAMS),
                    default="exact")
    ap.add_argument("--objective", default="binary",
                    help="binary (bench.py's labels), multiclass or "
                    "multiclassova (its target in 5 classes) or one of the "
                    "regression family (its target before the threshold)")
    ap.add_argument("--data", choices=("dense", "bundled", "categorical",
                                       "ranking"), default="dense")
    ap.add_argument("--boosting", choices=("gbdt", "goss", "dart", "rf"),
                    default="gbdt")
    sampling = ("bagging_fraction", "bagging_freq", "feature_fraction",
                "top_rate", "other_rate", "learning_rate", "drop_rate",
                "skip_drop")
    for name in sampling:
        ap.add_argument("--" + name.replace("_", "-"),
                        type=int if name == "bagging_freq" else float)
    ap.add_argument("--gpu-use-dp", action="store_true")
    args = ap.parse_args()
    if args.data == "ranking" and args.objective == "binary":
        args.objective = "lambdarank"
    if args.rows is None:
        args.rows = (chip_smoke.MULTICLASS_ROWS
                     if args.objective in chip_smoke.MULTICLASS_OBJECTIVES
                     else chip_smoke.RANKING_ROWS if args.data == "ranking"
                     else chip_smoke.MAIN_ROWS)
    if args.data == "ranking" and args.objective != "lambdarank":
        ap.error("--data ranking takes the lambdarank objective")
    if args.data not in ("dense", "ranking") and args.objective != "binary":
        ap.error("--data %s takes the binary objective" % args.data)
    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgb
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    group = weight = None
    if args.data == "ranking":
        x, y, group = chip_smoke.ranking_data(args.rows)
    elif args.objective in ("xentropy", "xentlambda"):
        x, y, weight = chip_smoke.xentropy_data(args.rows)
        if args.objective == "xentropy":
            weight = None
    else:
        x, y = (chip_smoke.bundled_data(args.rows) if args.data == "bundled"
                else chip_smoke.categorical_data(args.rows)
                if args.data == "categorical"
                else chip_smoke.workload(args.objective, args.rows))
    params = dict(chip_smoke.PARAMS, objective=args.objective,
                  **chip_smoke.objective_params(args.objective),
                  **chip_smoke.GROWTH_PARAMS[args.growth])
    if args.data == "ranking":
        params.update(chip_smoke.RANKING_PARAMS)
    params["boosting"] = args.boosting
    params.update({name: getattr(args, name) for name in sampling
                   if getattr(args, name) is not None})
    if args.gpu_use_dp:
        params["gpu_use_dp"] = True
    cat = (chip_smoke.CATEGORICAL_FEATURES if args.data == "categorical"
           else "auto")
    ds = lgb.Dataset(x, label=y, weight=weight, group=group, params=params,
                     categorical_feature=cat).construct()
    bst = lgb.Booster(params=params, train_set=ds)
    warm_up = (max(1, int(1.0 / bst.config.learning_rate))
               if args.boosting == "goss" else 1)
    for _ in range(warm_up):                       # warm-up iterations
        bst.update()
    torch.cuda.synchronize()
    chip_smoke.reset_counts()
    plain_ms = []                                  # without the profiler
    for _ in range(args.iters):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    own_launches = {k: v / args.iters
                    for k, v in chip_smoke.read_counts().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            bst.update()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    wall_ms = sum(plain_ms) / len(plain_ms)
    # one more iteration with CUDA's sync debug mode: every call site that
    # makes the host wait for the device, once each
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        bst.update()
        torch.cuda.set_sync_debug_mode("default")
    sync_sites = collections.Counter(
        "%s:%d" % (os.path.relpath(w.filename, root), w.lineno)
        for w in caught if "synchroniz" in str(w.message))
    avgs = prof.key_averages()
    # kernels only: an operator's entry repeats the time of its kernels
    dev = sorted((a for a in avgs if a.device_type == DeviceType.CUDA
                  and a.self_device_time_total > 0),
                 key=lambda a: -a.self_device_time_total)
    busy_ms = sum(a.self_device_time_total for a in dev) / 1e3 / args.iters
    host = sorted(avgs, key=lambda a: -a.self_cpu_time_total)

    def count(*names):
        return sum(a.count for a in avgs if a.key in names) // args.iters

    # splits an iteration (of every class's tree), after the warm-up's
    k = bst.num_model_per_iteration()
    splits = sum(t.num_leaves_actual - 1 for t in bst.models[warm_up * k:])
    splits //= max(len(bst.models) // k - warm_up, 1)
    # the port's own kernels: the launches of the core/csrc libraries, and
    # the memsets their launchers issue (PyTorch zeroes with fill kernels)
    own = [a for a in dev if a.key.startswith("Memset") or (
        "at::native" not in a.key
        and any("::%s" % k in a.key for k in OWN_KERNELS))]
    hist_ms = sum(a.self_device_time_total for a in own) / 1e3 / args.iters
    print("card: %s" % card)
    print("growth %s; the port's kernels per iteration: %s; their device "
          "time %.3f ms:" % (args.growth, own_launches, hist_ms))
    for a in own:
        print("  %9.3f %6d  %s" % (a.self_device_time_total / 1e3
                                   / args.iters, a.count // args.iters,
                                   a.key[:90]))
    print("iteration wall %.1f ms (%s; %.1f ms under the profiler), device "
          "busy %.1f ms (idle share %.3f), %d splits -> %.3f ms per split"
          % (wall_ms, " ".join("%.1f" % t for t in plain_ms), prof_ms,
             busy_ms, 1 - busy_ms / wall_ms, splits,
             wall_ms / max(splits, 1)))
    print("device time by kernel (ms per iteration, calls):")
    for a in dev[:12]:
        print("  %9.3f %6d  %s" % (a.self_device_time_total / 1e3
                                   / args.iters, a.count // args.iters,
                                   a.key[:90]))
    print("host time by operator (ms per iteration, calls):")
    for a in host[:15]:
        print("  %9.3f %6d  %s" % (a.self_cpu_time_total / 1e3 / args.iters,
                                   a.count // args.iters, a.key[:90]))
    summary = {
        "card": card, "growth": args.growth, "objective": args.objective,
        "data": args.data, "rows": args.rows, "gpu_use_dp": args.gpu_use_dp,
        "sampling": {k: params[k] for k in ("boosting",) + sampling
                     if k in params},
        "iters": args.iters, "own_kernel_launches": own_launches,
        "iteration_ms": wall_ms, "iteration_ms_each": plain_ms,
        "iteration_ms_profiled": prof_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms, "splits": splits,
        "histogram_kernel_ms": hist_ms,
        "kernel_launches": count("cudaLaunchKernel", "cuLaunchKernel",
                                 "cudaLaunchKernelExC"),
        "syncs": count("cudaStreamSynchronize", "cudaDeviceSynchronize"),
        "memcpy_calls": count("cudaMemcpyAsync"),
    }
    print("host-device synchronisations by call site (one iteration):")
    for site, n in sync_sites.most_common(12):
        print("  %6d  %s" % (n, site))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
