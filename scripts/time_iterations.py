"""Wall time of the PyTorch port's training iterations, without a profiler.

Trains chip_smoke.py's main-path workload (``chip_smoke.bench_data`` and
``chip_smoke.PARAMS``: bench.py's 1,000,000 x 28 data, numpy seed 0;
binary, num_leaves=255, max_bin=255) on the CUDA device under one growth
mode (chip_smoke.GROWTH_PARAMS), one warm-up iteration and then ``--iters`` timed ones, each ended by
a device synchronise. Prints one JSON line: the card's name and power
limit, the growth mode, each iteration's milliseconds and their median.

It imports ``chip_smoke`` and ``lightgbm_tpu_torch`` from the directory it
is run from. With ``--against DIR`` it also loads the port of another
checkout (``DIR/lightgbm_tpu_torch``, under another module name) into the
same process, trains the same data with it, and times the two in turns
(A B B A A B ...), so that both see the same host, allocator and card:

    python3 scripts/time_iterations.py [--growth MODE] [--iters K] \
        [--rows N] [--objective OBJECTIVE] [--against OTHER_CHECKOUT]

``--objective`` (binary by default) trains one of the regression family
on bench.py's target before its threshold instead
(``chip_smoke.regression_data``), or ``multiclass``/``multiclassova`` on
chip_smoke.py's multiclass workload (``chip_smoke.multiclass_data``: the
target in 5 classes, 500,000 rows by default).

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time


def load_port(checkout: str, name: str):
    """The ``lightgbm_tpu_torch`` package of ``checkout``, imported as
    module ``name`` (the port imports itself only relatively)."""
    pkg = os.path.join(os.path.abspath(checkout), "lightgbm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def time_in_turns(ports, x, y, params, iters: int, device: str):
    """Train one booster per port on (x, y); after one warm-up iteration
    each, time ``iters`` iterations of each, alternating the order every
    round. Returns one list of milliseconds per port."""
    import torch
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    boosters = []
    for lgb in ports:
        ds = lgb.Dataset(x, label=y, params=params, device=device).construct()
        bst = lgb.Booster(params=params, train_set=ds, device=device)
        bst.update()                               # warm-up iteration
        boosters.append(bst)
    sync()
    times = [[] for _ in ports]
    for i in range(iters):
        order = range(len(ports)) if i % 2 == 0 else \
            reversed(range(len(ports)))
        for j in order:
            t0 = time.perf_counter()
            boosters[j].update()
            sync()
            times[j].append((time.perf_counter() - t0) * 1e3)
    return times


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--growth", choices=sorted(chip_smoke.GROWTH_PARAMS),
                    default="exact")
    ap.add_argument("--objective", default="binary",
                    help="binary (bench.py's labels), multiclass or "
                    "multiclassova (its target in 5 classes) or one of the "
                    "regression family (its target before the threshold)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rows", type=int,
                    help="rows (1,000,000; multiclass 500,000)")
    ap.add_argument("--against", default=None,
                    help="another checkout whose port is timed in turns")
    args = ap.parse_args()
    if args.rows is None:
        args.rows = (chip_smoke.MULTICLASS_ROWS
                     if args.objective in chip_smoke.MULTICLASS_OBJECTIVES
                     else chip_smoke.MAIN_ROWS)
    import torch
    if not torch.cuda.is_available():
        print("time_iterations: needs a CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    x, y = chip_smoke.workload(args.objective, args.rows)
    params = dict(chip_smoke.PARAMS, objective=args.objective,
                  **chip_smoke.objective_params(args.objective),
                  **chip_smoke.GROWTH_PARAMS[args.growth])
    ports = [lightgbm_tpu_torch]
    names = [os.getcwd()]
    if args.against:
        ports.append(load_port(args.against, "lightgbm_tpu_torch_against"))
        names.append(os.path.abspath(args.against))
    times = time_in_turns(ports, x, y, params, args.iters, "cuda")
    print(json.dumps({"card": card, "growth": args.growth,
                      "objective": args.objective, "rows": args.rows,
                      "runs": [{"checkout": n, "iteration_ms": t,
                                "median_ms": statistics.median(t)}
                               for n, t in zip(names, times)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
