"""Train AUC of the JAX package on chip_smoke.py's main-path workload.

chip_smoke.py holds the PyTorch port's AUC on this workload against a
constant taken from the JAX package (the port may not import JAX). This
script is how those constants are taken: chip_smoke.py's data (bench.py's
1,000,000 x 28, numpy seed 0) and parameters (binary, num_leaves=255,
max_bin=255) under one growth mode (chip_smoke.GROWTH_PARAMS: ``tree_growth`` exact,
frontier, batched with ``tree_batch_splits=16``, or batched_part, the
same with ``tpu_batched_part=true``), 5
iterations, then the AUC of the predicted probabilities on the training
rows, with the same AUC function.

    JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py \
        [--growth exact|frontier|batched|batched_part] [--rows N] \
        [--iters K]

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
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--growth", choices=sorted(chip_smoke.GROWTH_PARAMS),
                    default="exact")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import lightgbm_tpu as lgb

    x, y = chip_smoke.bench_data(args.rows)
    params = dict(chip_smoke.PARAMS, **chip_smoke.GROWTH_PARAMS[args.growth])
    t0 = time.time()
    bst = lgb.train(params, lgb.Dataset(x, label=y),
                    num_boost_round=args.iters)
    p = bst.predict(x)
    print(json.dumps({"growth": args.growth, "rows": args.rows,
                      "iters": args.iters,
                      "auc": chip_smoke.auc(np.asarray(p, np.float64), y),
                      "backend": jax.default_backend(),
                      "seconds": time.time() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
