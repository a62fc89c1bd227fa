#!/usr/bin/env python3
"""The cost of a checkpoint a round on one CUDA card.

    python3 scripts/checkpoint_cost.py [--rows 1000000] [--rounds 8]
        [--pairs 2] [--out chiprun_out/checkpoint_cost.json]

Trains chip_smoke.py's 4zza configuration (exact growth with float64
histograms, num_leaves=255, max_bin=255, on bench.py's features) for
``--rounds`` iterations with no checkpoint and with a checkpoint a round,
in turns (without, with, with, without, ...), ``--pairs`` pairs, in one
process with the card to itself. Prints each run's median seconds an
iteration (the card synchronised at both ends, the snapshot inside), each
snapshot's capture ms (the training state's copy to the host) and write ms
(npz, three sha256, fsync, renames, the manifest), and the card's name and
power limit, and writes them as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import lightgbm_tpu_torch as lgb  # noqa: E402
from lightgbm_tpu_torch import callback  # noqa: E402


def timed_run(ds, rounds: int, directory=None) -> dict:
    ckpt = None if directory is None else callback.checkpoint(directory)
    clock = cs.IterationClock(None if ckpt is None else ckpt.manager)
    lgb.train(cs.CKPT_PARAMS, ds, num_boost_round=rounds,
              callbacks=([ckpt] if ckpt else []) + clock.callbacks,
              verbose_eval=False)
    out = {"checkpoint": ckpt is not None,
           "iteration_s": [r["s"] for r in clock.rows],
           "median_s": cs.median_s(clock.rows)}
    if ckpt is not None:
        out["capture_ms"] = [r["capture_ms"] for r in clock.rows]
        out["write_ms"] = [r["write_ms"] for r in clock.rows]
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=cs.MAIN_ROWS)
    parser.add_argument("--rounds", type=int, default=cs.CKPT_ROUNDS)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "checkpoint_cost.json"))
    args = parser.parse_args()
    card = cs.card_line()
    x, y = cs.bench_data(args.rows)
    ds = lgb.Dataset(x, label=y, params=cs.CKPT_PARAMS).construct()
    timed_run(ds, 1)                      # kernels loaded, caches warm
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for pair in range(args.pairs):
            order = (False, True) if pair % 2 == 0 else (True, False)
            for with_ckpt in order:
                directory = (os.path.join(tmp, "run%d" % len(runs))
                             if with_ckpt else None)
                runs.append(timed_run(ds, args.rounds, directory))
                cs.log("%s a checkpoint a round: median %.4f s an "
                       "iteration%s" % (
                           "with" if with_ckpt else "without",
                           runs[-1]["median_s"],
                           "; capture median %.3f ms, write median %.3f ms"
                           % (statistics.median(runs[-1]["capture_ms"]),
                              statistics.median(runs[-1]["write_ms"]))
                           if with_ckpt else ""))
    result = {"card": card, "rows": args.rows, "rounds": args.rounds,
              "runs": runs}
    for key, flag in (("with", True), ("without", False)):
        result["median_s_" + key] = statistics.median(
            r["median_s"] for r in runs if r["checkpoint"] == flag)
    snaps = [r for r in runs if r["checkpoint"]]
    result["capture_ms_median"] = statistics.median(
        v for r in snaps for v in r["capture_ms"])
    result["write_ms_median"] = statistics.median(
        v for r in snaps for v in r["write_ms"])
    cs.log("median s an iteration: %.4f with a checkpoint a round, %.4f "
           "without (%+.1f%%); snapshot capture median %.3f ms, write median "
           "%.3f ms" % (result["median_s_with"], result["median_s_without"],
                        100 * (result["median_s_with"]
                               / result["median_s_without"] - 1),
                        result["capture_ms_median"],
                        result["write_ms_median"]))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    cs.log("%.1f s" % (time.perf_counter() - t0))
    sys.exit(rc)
