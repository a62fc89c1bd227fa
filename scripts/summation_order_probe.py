"""How much two summation orders of the same histograms move the port's
trees.

Trains the port on chip_smoke.py's categorical workload
(``chip_smoke.categorical_data``, its id columns passed as
``categorical_feature``), or with ``--data dense`` on bench.py's (with
``--data bundled`` on ``chip_smoke.bundled_data``), twice
under one growth mode, on the CPU with the plain histogram versions: once
as they are (float32 sums), once with every histogram accumulated in
float64 and rounded to float32. Nothing else differs. ``--sampled
bagged|GOSS`` adds the options of phase 5's sampled rows
(``chip_smoke.SAMPLED_COMPARE``); ``--constraint monotone`` adds
``chip_smoke.MONOTONE_CONSTRAINTS`` and ``--constraint forced_cegb``
chip_smoke's forced splits (written to a temporary directory) and
CEGB_PARAMS, the options of phase 5's constraint rows
(``chip_smoke.constraint_compare_runs``). ``--plant-fault N`` plants a
fault in the float32 run: its histograms drop every N-th row of the rows
they sum (zero gradient, hessian and count), to show what phase 5's rule
makes of a kernel that sums wrong. ``--seed`` draws other data,
``--f32-sums blocked`` sums the float32 run in cell runs as phase 5's f32
plain path does. Prints, per tree, every substituted split (tree, node,
wave, leaf, rows, feature, bin, gain: ``chip_smoke.substituted_splits``),
the first node
where the two trees part by position, how far apart the gains of the
splits before it (relative to their own and to the root's) and of that
node are, where they part at a tie matched
by rows (``chip_smoke.parting_tie`` under the row's limits, none without
them: node, kind, the gains' difference relative to the split's and to
the root's, and that of the splits before it), the tie rule's counts
(positional mismatches, substituted splits), the trees' gain sums and
their relative difference, the float64 tree's null splits (gain within
``chip_smoke.CLAMP_PARTING.root_rel`` of the root's: their count, the
largest and the smallest gain above them, relative to the root's), then
both forests' train AUC and whether phase 5's tie rule
(``chip_smoke.trees_match`` under ``chip_smoke.tie_limits``) holds.

    python scripts/summation_order_probe.py [--growth MODE] [--rows N] \
        [--iters K] [--threads T] [--data categorical|dense|bundled] \
        [--sampled bagged|GOSS] [--constraint monotone|forced_cegb] \
        [--plant-fault N] [--seed S] [--f32-sums running|blocked]

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
import tempfile


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.core import histogram
    ap = argparse.ArgumentParser()
    ap.add_argument("--growth", choices=sorted(chip_smoke.GROWTH_PARAMS),
                    default="exact")
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--threads", type=int, default=1,
                    help="CPU threads (1 keeps each sum's order fixed)")
    ap.add_argument("--data", choices=("categorical", "dense", "bundled"),
                    default="categorical")
    ap.add_argument("--sampled", choices=sorted(chip_smoke.SAMPLED_COMPARE))
    ap.add_argument("--constraint", choices=("monotone", "forced_cegb"))
    ap.add_argument("--plant-fault", type=int, default=0, metavar="N",
                    help="the float32 run's histograms drop every N-th row")
    ap.add_argument("--seed", type=int, default=0,
                    help="the data's seed (chip_smoke.py's is 0)")
    ap.add_argument("--f32-sums", choices=("running", "blocked"),
                    default="running",
                    help="how the float32 run's histograms add a cell's "
                         "rows (core/histogram.py PLAIN_SUMS)")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    params = dict(chip_smoke.PARAMS, **chip_smoke.GROWTH_PARAMS[args.growth],
                  **chip_smoke.SAMPLED_COMPARE.get(args.sampled, {}))
    tmp = tempfile.TemporaryDirectory()
    if args.constraint == "monotone":
        params["monotone_constraints"] = chip_smoke.MONOTONE_CONSTRAINTS
    elif args.constraint == "forced_cegb":
        for kind in ("forced", "cegb"):
            params.update(chip_smoke.constraint_params(kind, tmp.name))
    if args.data in ("dense", "bundled"):
        x, y = (chip_smoke.bench_data if args.data == "dense"
                else chip_smoke.bundled_data)(args.rows, seed=args.seed)
        ds = lgb.Dataset(x, label=y, params=params, device="cpu")
    else:
        x, y = chip_smoke.categorical_data(args.rows, seed=args.seed)
        ds = lgb.Dataset(x, label=y, params=params, device="cpu",
                         categorical_feature=chip_smoke.CATEGORICAL_FEATURES)
    ds.construct()
    forests = {}
    sums = histogram._sums
    if args.plant_fault:
        def dropping_sums(vals, mode):
            if mode != "f64":
                vals = vals.clone()
                vals[::args.plant_fault] = 0
            return sums(vals, mode)
        histogram._sums = dropping_sums
    for label in ("float32", "float64"):
        bst = lgb.Booster(params=params, train_set=ds, device="cpu")
        # the plain histograms' accumulation (GrowParams.plain_sums)
        bst._impl.grow_params = bst._impl.grow_params._replace(
            plain_sums="f64" if label == "float64" else args.f32_sums)
        for _ in range(args.iters):
            bst.update()
        forests[label] = bst
        histogram._sums = sums
    a, b = forests["float32"].models, forests["float64"].models
    rows = torch.as_tensor(x, dtype=torch.float64)
    limits = chip_smoke.tie_limits(params, args.data == "categorical")
    out = {"growth": args.growth, "rows": args.rows, "data": args.data,
           "seed": args.seed, "f32_sums": args.f32_sums,
           "sampled": args.sampled, "constraint": args.constraint,
           "trees": []}
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
               "parting_tie": chip_smoke.parting_tie(
                   ta, tb, rows, limits[0] or chip_smoke.PartingLimits()),
               "shared_gain_rel_max": float(rel[:first].max(initial=0.0)),
               "shared_root_rel_max": float(
                   np.abs(ta.split_gain[:first] - tb.split_gain[:first])
                   .max(initial=0.0) / abs(tb.split_gain[0])),
               "parting_gain_rel": (float(rel[first]) if first < nn
                                    else None),
               "gain_sum": [ga, gb], "gain_rel": abs(ga - gb) / abs(gb),
               "sizes": [int(ta.num_leaves_actual - 1),
                         int(tb.num_leaves_actual - 1)]}
        # null splits (chip_smoke.CLAMP_PARTING): gains to the root's
        rel_root = np.sort(tb.split_gain[:nn] / tb.split_gain[0])
        null = rel_root <= chip_smoke.CLAMP_PARTING.root_rel
        row["null_splits"] = [int(null.sum()), float(rel_root[null].max(
            initial=0.0)), float(rel_root[~null].min(initial=np.inf))]
        row["substituted_splits"] = chip_smoke.substituted_splits(ta, tb,
                                                                  rows)
        for sub in row["substituted_splits"]:
            print("  substituted split of the %(tree)s tree: node %(node)d, "
                  "wave %(wave)d, leaf %(leaf)d, %(rows)d rows, feature "
                  "%(feature)d, bin %(bin)d, gain %(gain).6g" % sub)
        out["trees"].append(row)
        print("tree %d: parts by position at node %s, at a tie matched by "
              "rows %s; the nodes before it split alike with gains up to "
              "%.3g apart (%.3g of the root's), the parting node's %s "
              "apart; %d positional mismatches, %d substituted splits; gain "
              "sums %.4f and %.4f, %.3g apart; %d and %d splits; the "
              "float64 tree's null splits %d, up to %.2g of the root's "
              "gain, the next %.2g"
              % (i, row["first_parting_node"], row["parting_tie"],
                 row["shared_gain_rel_max"], row["shared_root_rel_max"],
                 row["parting_gain_rel"],
                 row["positional"], row["substituted"], ga, gb,
                 row["gain_rel"], *row["sizes"], *row["null_splits"]))
    out["auc"] = {k: chip_smoke.auc(f.predict(x, raw_score=True), y)
                  for k, f in forests.items()}
    print("train AUC, float32 sums %.6f, float64 sums %.6f"
          % (out["auc"]["float32"], out["auc"]["float64"]))
    # phase 5's verdict on the two forests, under this row's tie limits
    try:
        chip_smoke.trees_match(a, b, [], *limits, rows)
        out["tie_rule"] = "holds"
    except AssertionError as err:
        out["tie_rule"] = "fails: %s" % err
    print("phase 5's tie rule (limits %s): %s" % (limits, out["tie_rule"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
