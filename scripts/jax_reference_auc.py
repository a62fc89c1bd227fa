"""The JAX package's metrics on chip_smoke.py's main-path workloads.

chip_smoke.py holds the PyTorch port's train metrics against constants
taken from the JAX package (the port may not import JAX). This script is
how those constants are taken: chip_smoke.py's data (bench.py's
1,000,000 x 28, numpy seed 0) and parameters (num_leaves=255, max_bin=255)
under one growth mode (chip_smoke.GROWTH_PARAMS: ``tree_growth`` exact,
frontier, batched with ``tree_batch_splits=16``, or batched_part, the same
with ``tpu_batched_part=true``), 5 iterations.

- ``--objective binary`` (the default): bench.py's 0/1 labels; prints the
  AUC of the predicted probabilities on the training rows, with
  chip_smoke's AUC function. ``--data bundled`` takes chip_smoke's
  bundled workload instead (``chip_smoke.bundled_data``: 1,000,000 x 284,
  HIGGS's b-tags plus one-hot blocks, which default binning stores as EFB
  bundles and packed pairs), the data of its paths 4i-4l; ``--data
  categorical`` takes its categorical workload
  (``chip_smoke.categorical_data``: 1,000,000 x 32, four integer id
  columns passed as ``categorical_feature``), the data of its paths
  4m-4p.
- ``--fobj logistic``: bench.py's 0/1 labels trained through a custom
  objective that returns the logistic gradients ``(p - y, p (1 - p))``
  in numpy, ``metric=auc``, the call of chip_smoke's path 4q; prints the
  AUC of the raw scores on the training rows.
- ``--objective`` one of the regression family (regression, huber,
  quantile, regression_l1, ...): bench.py's target before its threshold
  (``chip_smoke.regression_data``); prints the objective's own train
  metric. With ``--valid`` it also trains with chip_smoke's validation
  set (250,000 rows drawn the same way from seed 1, early stopping after
  5 rounds) and prints the valid metric after each iteration.
- ``--objective multiclass|multiclassova``: chip_smoke's multiclass
  workload (``chip_smoke.multiclass_data``: 500,000 x 28, the regression
  target cut at its quantiles into ``--num-class`` classes, 5 by default),
  the data of its paths 4r-4u; prints the train ``multi_logloss`` and
  ``multi_error``, and with ``--valid`` the valid ``multi_logloss`` after
  each iteration (125,000 rows from seed 1, early stopping after 5 rounds).
- ``--data ranking``: chip_smoke's ranking workload
  (``chip_smoke.ranking_data``: 500,000 x 28 in consecutive queries of
  50-150 docs, relevance 0-4), the data of its paths 4v-4y, trained with
  ``--objective lambdarank`` (the default there) and chip_smoke's
  RANKING_PARAMS (metrics ``ndcg,map,topavg,topavgdiff`` at
  ``eval_at=1,3,5``); prints every train ranking metric, and with
  ``--valid`` the valid ``ndcg@5`` after each iteration (125,000 rows
  from seed 1 with their own groups, early stopping after 5 rounds).
  ``--objective xentropy|xentlambda`` there trains on ``rel / 4``.
- ``--objective xentropy|xentlambda`` on the dense data:
  ``chip_smoke.xentropy_data`` (bench.py's features, labels
  ``sigmoid(t)`` of the regression target; xentlambda with the weights
  uniform in [0.5, 1.5] of path 4za), the data of paths 4z and 4za;
  prints every metric of chip_smoke's XENTROPY_PATHS for the objective.
- Row sampling (#7), the settings of chip_smoke's paths 4zb-4zg
  (``chip_smoke.SAMPLING_PATHS``): ``--boosting gbdt|goss|dart|rf``,
  ``--bagging-fraction``, ``--bagging-freq``, ``--feature-fraction``,
  ``--top-rate``, ``--other-rate``, ``--learning-rate``, ``--drop-rate``,
  ``--skip-drop`` and ``--rounds`` (the iterations) set the parameters of
  those names over any of the workloads above. The run goes through
  ``lgb.train`` with a valid set where ``--valid`` asks for one and without
  one otherwise, as the path does: the valid set decides whether the JAX
  package fuses the loop into blocks, and with it the bagging and GOSS key
  stream. On the binary workload ``--valid`` keeps 250,000 rows from seed
  1 with ``metric=auc`` and prints the valid AUC after each iteration;
  gbdt and goss there stop early after 5 rounds (path 4zb), DART and RF
  keep every iteration. A DART run prints each iteration's drop set.
- ``--hist-impl scatter|matmul`` sets the JAX package's
  ``tpu_hist_impl``. ``auto`` (the default) is ``scatter`` on the CPU: one
  XLA scatter-add, a single running f32 sum per histogram cell, which
  drifts by 1e-2 relative on a cell of 1,000,000 rows. ``matmul`` sums in
  16,384-row chunks, as the port's kernels sum in blocks, and is about
  twice as slow.

    JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py \
        [--growth exact|frontier|batched|batched_part] \
        [--objective OBJECTIVE] [--num-class K] [--valid] \
        [--data dense|bundled|categorical|ranking] [--fobj logistic] \
        [--hist-impl auto|scatter|matmul] [--rows N] [--iters K] \
        [--boosting gbdt|goss|dart|rf] [--bagging-fraction F] \
        [--bagging-freq K] [--feature-fraction F] [--top-rate F] \
        [--other-rate F] [--learning-rate F] [--drop-rate F] \
        [--skip-drop F] [--rounds K]

It runs on the CPU backend and prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int,
                    help="rows (1,000,000; multiclass 500,000)")
    ap.add_argument("--iters", "--rounds", type=int, default=5)
    ap.add_argument("--growth", choices=sorted(chip_smoke.GROWTH_PARAMS),
                    default="exact")
    ap.add_argument("--objective", default="binary")
    ap.add_argument("--valid", action="store_true")
    ap.add_argument("--data", choices=("dense", "bundled", "categorical",
                                       "ranking"), default="dense")
    ap.add_argument("--fobj", choices=("logistic",))
    ap.add_argument("--num-class", type=int,
                    default=chip_smoke.NUM_CLASS)
    ap.add_argument("--hist-impl", choices=("auto", "scatter", "matmul"),
                    default="auto")
    ap.add_argument("--boosting", choices=("gbdt", "goss", "dart", "rf"),
                    default="gbdt")
    sampling = ("bagging_fraction", "bagging_freq", "feature_fraction",
                "top_rate", "other_rate", "learning_rate", "drop_rate",
                "skip_drop")
    for name in sampling:
        ap.add_argument("--" + name.replace("_", "-"),
                        type=int if name == "bagging_freq" else float)
    args = ap.parse_args()
    multiclass = args.objective in ("multiclass", "multiclassova")
    if args.data == "ranking" and args.objective == "binary":
        args.objective = "lambdarank"
    if args.rows is None:
        args.rows = (chip_smoke.MULTICLASS_ROWS if multiclass
                     else chip_smoke.RANKING_ROWS if args.data == "ranking"
                     else chip_smoke.MAIN_ROWS)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import lightgbm_tpu as lgb

    params = dict(chip_smoke.PARAMS, objective=args.objective,
                  tpu_hist_impl=args.hist_impl,
                  **chip_smoke.GROWTH_PARAMS[args.growth])
    params["boosting"] = args.boosting
    params.update({name: getattr(args, name) for name in sampling
                   if getattr(args, name) is not None})
    out = {"growth": args.growth, "objective": args.objective,
           "data": args.data, "rows": args.rows, "iters": args.iters,
           "hist_impl": args.hist_impl,
           "sampling": {k: params[k] for k in ("boosting",) + sampling
                        if k in params}}
    drops = []
    if args.boosting == "dart":
        from lightgbm_tpu.boosting.dart import DART
        dropping = DART._dropping_trees

        def recorded(self):
            drops.append(dropping(self))
            return drops[-1]
        DART._dropping_trees = recorded
    t0 = time.time()
    if args.fobj:
        if args.data != "dense" or args.objective != "binary":
            ap.error("--fobj takes bench.py's binary labels")
        x, y = chip_smoke.bench_data(args.rows)
        params.update(chip_smoke.FOBJ_PARAMS)
        bst = lgb.train(params, lgb.Dataset(x, label=y),
                        num_boost_round=args.iters,
                        fobj=chip_smoke.logistic_fobj)
        out.update(fobj=args.fobj, auc=chip_smoke.auc(
            np.asarray(bst.predict(x), np.float64), y))
    elif args.data == "ranking":
        x, rel, sizes = chip_smoke.ranking_data(args.rows)
        params.update(chip_smoke.RANKING_PARAMS, objective=args.objective)
        scale = 1.0 if args.objective == "lambdarank" else 0.25
        train = lgb.Dataset(x, label=rel * scale, group=sizes)
        kwargs = {}
        if args.valid:
            xv, relv, sizes_v = chip_smoke.ranking_data(
                chip_smoke.RANKING_VALID_ROWS, seed=1)
            kwargs = {"valid_sets": [train.create_valid(
                xv, label=relv * scale, group=sizes_v)],
                "early_stopping_rounds": chip_smoke.EARLY_STOPPING_ROUNDS,
                "evals_result": {}, "verbose_eval": False}
        bst = lgb.train(params, train, num_boost_round=args.iters, **kwargs)
        out.update(queries=len(sizes),
                   train={name: value
                          for _, name, value, _ in bst.eval_train()})
        if args.valid:
            out["valid"] = kwargs["evals_result"]["valid_0"]["ndcg@5"]
            out["best_iteration"] = bst.best_iteration
    elif args.objective in ("xentropy", "xentlambda"):
        if args.data != "dense":
            ap.error("--data %s takes the binary objective" % args.data)
        x, y, w = chip_smoke.xentropy_data(args.rows)
        (_, extra, weighted), = [
            v for v in chip_smoke.XENTROPY_PATHS.values()
            if v[1]["objective"] == args.objective]
        params.update(extra)
        bst = lgb.train(params, lgb.Dataset(x, label=y,
                                            weight=w if weighted else None),
                        num_boost_round=args.iters)
        out.update(weighted=weighted,
                   train={name: value
                          for _, name, value, _ in bst.eval_train()})
    elif args.objective == "binary":
        data = {"dense": chip_smoke.bench_data,
                "bundled": chip_smoke.bundled_data,
                "categorical": chip_smoke.categorical_data}[args.data]
        x, y = data(args.rows)
        cat = (chip_smoke.CATEGORICAL_FEATURES
               if args.data == "categorical" else "auto")
        train = lgb.Dataset(x, label=y, categorical_feature=cat)
        kwargs = {}
        if args.valid:
            if args.data != "dense":
                ap.error("--valid on the binary objective takes --data "
                         "dense")
            xv, yv = chip_smoke.bench_data(chip_smoke.VALID_ROWS, seed=1)
            params["metric"] = "auc"
            kwargs = {"valid_sets": [train.create_valid(xv, label=yv)],
                      "evals_result": {}, "verbose_eval": False}
            if args.boosting in ("gbdt", "goss"):
                kwargs["early_stopping_rounds"] = \
                    chip_smoke.EARLY_STOPPING_ROUNDS
        bst = lgb.train(params, train, num_boost_round=args.iters, **kwargs)
        out["auc"] = chip_smoke.auc(np.asarray(bst.predict(x), np.float64), y)
        if args.valid:
            out["valid"] = kwargs["evals_result"]["valid_0"]["auc"]
            out["best_iteration"] = bst.best_iteration
        if args.data == "categorical":
            out["splits_on"] = chip_smoke.categorical_splits(
                bst._impl.models)
        if args.data == "bundled":
            out["splits_on"] = chip_smoke.splits_on_layout(
                bst._impl.models, bst._impl.train_data)
    elif multiclass:
        if args.data != "dense":
            ap.error("--data %s takes the binary objective" % args.data)
        params.update(chip_smoke.objective_params(args.objective),
                      num_class=args.num_class)
        x, y = chip_smoke.multiclass_data(args.rows,
                                          num_class=args.num_class)
        train = lgb.Dataset(x, label=y)
        kwargs = {}
        if args.valid:
            xv, yv = chip_smoke.multiclass_data(
                chip_smoke.MULTICLASS_VALID_ROWS, seed=1,
                num_class=args.num_class)
            kwargs = {"valid_sets": [train.create_valid(xv, label=yv)],
                      "early_stopping_rounds":
                          chip_smoke.EARLY_STOPPING_ROUNDS,
                      "evals_result": {}, "verbose_eval": False}
        bst = lgb.train(params, train, num_boost_round=args.iters, **kwargs)
        out.update(num_class=args.num_class,
                   train={name: value
                          for _, name, value, _ in bst.eval_train()})
        if args.valid:
            out["valid"] = kwargs["evals_result"]["valid_0"]["multi_logloss"]
            out["best_iteration"] = bst.best_iteration
    else:
        if args.data != "dense":
            ap.error("--data %s takes the binary objective" % args.data)
        x, y = chip_smoke.regression_data(args.rows)
        train = lgb.Dataset(x, label=y)
        kwargs = {}
        if args.valid:
            xv, yv = chip_smoke.regression_data(chip_smoke.VALID_ROWS,
                                                seed=1)
            kwargs = {"valid_sets": [train.create_valid(xv, label=yv)],
                      "early_stopping_rounds":
                          chip_smoke.EARLY_STOPPING_ROUNDS,
                      "evals_result": {}, "verbose_eval": False}
        bst = lgb.train(params, train, num_boost_round=args.iters, **kwargs)
        (_, name, value, _), = bst.eval_train()
        out["metric"] = name
        out["train"] = value
        if args.valid:
            out["valid"] = kwargs["evals_result"]["valid_0"][name]
            out["best_iteration"] = bst.best_iteration
    if args.boosting == "dart":
        out["drops"] = drops
    out.update(backend=jax.default_backend(), seconds=time.time() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
