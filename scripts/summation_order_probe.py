"""How much two summation orders of the same histograms move the port's
trees.

Trains the port on chip_smoke.py's categorical workload
(``chip_smoke.categorical_data``, its id columns passed as
``categorical_feature``), or with ``--data dense`` on bench.py's, twice
under one growth mode, on the CPU with the plain histogram versions: once
as they are (float32 sums), once with every histogram accumulated in
float64 and rounded to float32. Nothing else differs. ``--sampled
bagged|GOSS`` adds the options of phase 5's sampled rows
(``chip_smoke.SAMPLED_COMPARE``). Prints, per tree, the first node where
the two trees part, whether both split the same rows there
(``chip_smoke.parting_tie``), how far apart the gains of the splits
before it and of the parting node are, the tie rule's counts (positional
mismatches, substituted splits), the trees' gain sums and their relative
difference, then both forests' train AUC.

    python scripts/summation_order_probe.py [--growth MODE] [--rows N] \
        [--iters K] [--threads T] [--data categorical|dense] \
        [--sampled bagged|GOSS]

This is what chip_smoke.py's phase 5 rules for categorical data and for
sampled rows rest on: the kernel path and the plain path are two
summation orders.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    import lightgbm_tpu_torch as lgb
    ap = argparse.ArgumentParser()
    ap.add_argument("--growth", choices=sorted(chip_smoke.GROWTH_PARAMS),
                    default="exact")
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--threads", type=int, default=1,
                    help="CPU threads (1 keeps each sum's order fixed)")
    ap.add_argument("--data", choices=("categorical", "dense"),
                    default="categorical")
    ap.add_argument("--sampled", choices=sorted(chip_smoke.SAMPLED_COMPARE))
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    params = dict(chip_smoke.PARAMS, **chip_smoke.GROWTH_PARAMS[args.growth],
                  **chip_smoke.SAMPLED_COMPARE.get(args.sampled, {}))
    if args.data == "dense":
        x, y = chip_smoke.bench_data(args.rows)
        ds = lgb.Dataset(x, label=y, params=params, device="cpu")
    else:
        x, y = chip_smoke.categorical_data(args.rows)
        ds = lgb.Dataset(x, label=y, params=params, device="cpu",
                         categorical_feature=chip_smoke.CATEGORICAL_FEATURES)
    ds.construct()
    forests = {}
    for label in ("float32", "float64"):
        bst = lgb.Booster(params=params, train_set=ds, device="cpu")
        # the plain histograms' accumulation (GrowParams.plain_f64_sums)
        bst._impl.grow_params = bst._impl.grow_params._replace(
            plain_f64_sums=label == "float64")
        for _ in range(args.iters):
            bst.update()
        forests[label] = bst
    a, b = forests["float32"].models, forests["float64"].models
    out = {"growth": args.growth, "rows": args.rows, "data": args.data,
           "sampled": args.sampled, "trees": []}
    for i, (ta, tb) in enumerate(zip(a, b)):
        nn = min(ta.num_leaves_actual, tb.num_leaves_actual) - 1
        parted = np.flatnonzero(
            (ta.split_feature[:nn] != tb.split_feature[:nn])
            | (ta.threshold_bin[:nn] != tb.threshold_bin[:nn])
            | (ta.cat_bitset_bin[:nn] != tb.cat_bitset_bin[:nn]).any(axis=1))
        ga, gb = float(ta.split_gain[:nn].sum()), float(
            tb.split_gain[:nn].sum())
        first = int(parted[0]) if len(parted) else nn
        rel = (np.abs(ta.split_gain[:nn] - tb.split_gain[:nn])
               / np.maximum(np.abs(tb.split_gain[:nn]), 1e-30))
        count = [collections.Counter(zip(t.split_feature[:nn].tolist(),
                                         np.round(t.threshold[:nn], 9)))
                 for t in (ta, tb)]
        row = {"tree": i, "first_parting_node":
               first if first < nn else None,
               "positional": int((ta.split_feature[:nn]
                                  != tb.split_feature[:nn]).sum()),
               "substituted": sum(((count[0] - count[1])
                                   + (count[1] - count[0])).values()),
               "parting_tie": chip_smoke.parting_tie(ta, tb, nn),
               "shared_gain_rel_max": float(rel[:first].max(initial=0.0)),
               "parting_gain_rel": (float(rel[first]) if first < nn
                                    else None),
               "gain_sum": [ga, gb], "gain_rel": abs(ga - gb) / abs(gb)}
        out["trees"].append(row)
        print("tree %d: parts at node %s (%s); the nodes before it split "
              "alike with gains up to %.3g apart, the parting node's %s "
              "apart; %d positional mismatches, %d substituted splits; gain "
              "sums %.4f and %.4f, %.3g apart"
              % (i, row["first_parting_node"], row["parting_tie"],
                 row["shared_gain_rel_max"], row["parting_gain_rel"],
                 row["positional"], row["substituted"], ga, gb,
                 row["gain_rel"]))
    out["auc"] = {k: chip_smoke.auc(f.predict(x, raw_score=True), y)
                  for k, f in forests.items()}
    print("train AUC, float32 sums %.6f, float64 sums %.6f"
          % (out["auc"]["float32"], out["auc"]["float64"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
