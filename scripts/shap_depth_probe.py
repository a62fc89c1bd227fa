"""How far TreeSHAP's two orders of summation part, against path depth.

Trains the port on the CPU for chip_smoke.NUM_ITERS rounds with
chip_smoke.PARAMS in exact growth, on ``--rows`` rows of chip_smoke.py's
sparse data (``sparse_data``, path 4zq's CSR) or of bench.py's dense data
(``bench_data``, path 4a's). It then computes ``pred_contrib`` of the first
``--contrib-rows`` rows by both of the port's functions
(``core/shap.py``: ``contrib_tensor``, the vectorized version, and
``predict_contrib_plain``, the recursion), and prints, per tree, the
longest root-to-leaf path and the longest merged path (distinct features:
TreeSHAP's unique depth), and for the rows: the largest |contribution|,
the largest distance of a row's contributions' sum from its raw score, and
the largest distance of the two functions, as a share of the row's sum of
|contrib| (chip_smoke.py's CONTRIB_PLAIN_REL measure). With ``--jax``, the
JAX package's ``predict_contrib`` on the port's model text is held to the
port's recursion too.

The recursion's ``_unwound_path_sum`` undoes ``_extend`` by a
back-substitution that multiplies a rounding error by about
``zero_fraction * (d - i) / (i + 1)`` a step, so on a path of d distinct
features the error can grow like a binomial coefficient of d. Deep,
chain-like trees (sparse data, a weak label, many leaves) show it.

    JAX_PLATFORMS=cpu python scripts/shap_depth_probe.py [--data sparse]
        [--rows 5000] [--contrib-rows 50] [--jax]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import lightgbm_tpu_torch as lgb  # noqa: E402
from lightgbm_tpu_torch.core import shap  # noqa: E402


def longest_path(ht) -> int:
    """The most splits on a root-to-leaf path of ``ht``."""
    depth, best, stack = {0: 0}, 0, [0]
    while stack:
        node = stack.pop()
        for child in (int(ht.left_child[node]), int(ht.right_child[node])):
            if child >= 0:
                depth[child] = depth[node] + 1
                stack.append(child)
            else:
                best = max(best, depth[node] + 1)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", choices=("sparse", "dense"), default="sparse")
    ap.add_argument("--rows", type=int, default=5000)
    ap.add_argument("--contrib-rows", type=int, default=50)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    if args.data == "sparse":
        x, y = chip_smoke.sparse_data(args.rows)
    else:
        x, y = chip_smoke.bench_data(args.rows)
    params = dict(chip_smoke.PARAMS, **chip_smoke.GROWTH_PARAMS["exact"])
    ds = lgb.Dataset(x, label=y, params=params, device="cpu").construct()
    bst = lgb.Booster(params=params, train_set=ds, device="cpu")
    for _ in range(chip_smoke.NUM_ITERS):
        bst.update()
    impl = bst._impl
    head = x[:args.contrib_rows]
    head = head.toarray() if hasattr(head, "toarray") else np.asarray(head)
    raw = bst.predict(head, raw_score=True)
    ours = shap.contrib_tensor(impl, torch.as_tensor(
        head, dtype=torch.float64)).numpy().reshape(len(head), -1)
    plain = shap.predict_contrib_plain(impl, head).reshape(len(head), -1)
    absum = np.abs(plain).sum(axis=1)
    out = {
        "data": args.data, "rows": args.rows, "contrib_rows": len(head),
        "trees": [{"leaves": int(t.num_leaves_actual),
                   "longest_path": longest_path(t),
                   "longest_merged_path": shap.tree_paths(
                       t, torch.device("cpu")).max_depth}
                  for t in impl.models],
        "max_abs_contrib": float(np.abs(plain).max()),
        "max_sum_minus_raw": float(np.abs(plain.sum(axis=1) - raw).max()),
        "vectorized_vs_recursion_rel": float(
            (np.abs(ours - plain).max(axis=1) / absum).max()),
    }
    if args.jax:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import lightgbm_tpu
        ref = lightgbm_tpu.Booster(model_str=bst.model_to_string())
        theirs = np.asarray(ref.predict(head, pred_contrib=True)).reshape(
            len(head), -1)
        out["jax_vs_recursion_rel"] = float(
            (np.abs(theirs - plain).max(axis=1) / absum).max())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
