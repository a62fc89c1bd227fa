"""Where the JAX package's trees first part from the port's, and whether
they part at a gain tie.

Trains one of chip_smoke.py's row-sampling paths (``--path``, a label of
chip_smoke.SAMPLING_PATHS) for ``--rounds`` iterations (the path's by
default) in both packages on the CPU, each through its fused loop (no
valid set): the JAX package with chunked histogram sums
(``tpu_hist_impl=matmul``, as chip_smoke's constants are taken) and the
port on its plain path with float64 histogram sums (as chip_smoke's plain
runs train). Both draw the same bagging masks. It finds the first tree and
the first node in it at which the two forests differ (in split order), and
for each package's split there sums the gradients and hessians of its two
children in float64 over that iteration's in-bag rows (the port's
gradients at the port's scores before that tree, which up to float32
rounding are the JAX package's, since the earlier trees are the same) and
prints the split's exact gain, ``GL^2/HL + GR^2/HR - (GL+GR)^2/(HL+HR)``
(no L1/L2, as the paths train), beside its float32 gain and the root's.

The forests part at a gain tie (``gain_tie``) where the JAX package's split
has an exact gain of zero (a tie with not splitting: two children with
the same G/H, taken on float32 rounding of a gain of zero), or where the
two splits' exact gains lie within TIE_REL of each other, closer than the
float32 sums of a leaf's many rows place a gain (a gain is the small
difference of large terms). There the two forests part without either
being wrong, and chip_smoke.py holds the path's runs to the JAX constants
as it holds a parted run (``RANK_PARTED_REL_TOL``).

    JAX_PLATFORMS=cpu python scripts/gain_tie_probe.py --path 4zg \\
        [--rows N] [--rounds R]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# two splits whose exact gains are this close (relative) tie: the float32
# gains of a 500,000-row ranking path's leaves sit up to 2.6e-4 from their
# exact values
TIE_REL = 1e-3


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=sorted(chip_smoke.SAMPLING_PATHS),
                    default="4zg")
    ap.add_argument("--rows", type=int)
    ap.add_argument("--rounds", type=int)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    import lightgbm_tpu as jlgb
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.core import tree as tree_mod

    growth, extra, data, rounds, _ = chip_smoke.SAMPLING_PATHS[args.path]
    rounds = args.rounds or rounds
    group = None
    if data == "ranking":
        x, y, group = chip_smoke.ranking_data(
            args.rows or chip_smoke.RANKING_ROWS)
    else:
        x, y = chip_smoke.bench_data(args.rows or chip_smoke.MAIN_ROWS)
    params = dict(chip_smoke.PARAMS, **extra,
                  **chip_smoke.GROWTH_PARAMS[growth])
    t0 = time.time()
    jb = jlgb.train(dict(params, tpu_hist_impl="matmul"),
                    jlgb.Dataset(x, label=y, group=group), rounds)
    tb = tlgb.Booster(params=dict(params, tpu_hist_impl="plain"),
                      train_set=tlgb.Dataset(x, label=y, group=group,
                                             device="cpu"), device="cpu")
    impl = tb._impl
    impl.grow_params = impl.grow_params._replace(plain_f64_sums=True)
    # the mask each iteration grows on
    masks = []
    cls = type(impl)
    train_iteration = cls._train_iteration

    def recorded(self, grad, hess, sample_mask, goss_key):
        masks.append(sample_mask.numpy().copy())
        return train_iteration(self, grad, hess, sample_mask, goss_key)
    cls._train_iteration = recorded
    try:
        impl.train_many(rounds)
    finally:
        cls._train_iteration = train_iteration
    out = {"path": args.path, "rows": len(y), "rounds": rounds,
           "final_masks_equal": bool(np.array_equal(
               np.asarray(jb._impl._bag_mask), impl._bag_mask.numpy())),
           "parted_at_tree": None, "parted_at_node": None}
    differ = []
    for t, (jt, tt) in enumerate(zip(jb._impl.models, tb.models)):
        nn = min(jt.num_leaves_actual, tt.num_leaves_actual) - 1
        differ = np.flatnonzero(
            (jt.split_feature[:nn] != tt.split_feature[:nn])
            | (jt.threshold_bin[:nn] != tt.threshold_bin[:nn])
            | (jt.split_leaf[:nn] != tt.split_leaf[:nn]))
        if len(differ):
            break
    if len(differ):
        i = int(differ[0])
        # the gradients tree t was grown on: the objective's at the scores
        # before it (the init score before tree 0), over its in-bag rows
        before = (np.full(len(y), float(impl.init_score_offsets[0]))
                  if t == 0 else tb.predict(x, raw_score=True,
                                            num_iteration=t))
        g, h = (a.numpy().astype(np.float64)
                for a in impl.objective.get_gradients(
                    torch.as_tensor(before, dtype=torch.float32)))
        inbag = masks[t] > 0

        def split_at(tree):
            """Node i of ``tree`` with its children's float64 sums and its
            exact gain."""
            leaf = tree_mod.replay_leaves_binned(impl._binned_tree(tree),
                                                 impl.xb).numpy()
            sums = []
            for child in (tree.left_child[i], tree.right_child[i]):
                stack, found = [child], []
                while stack:
                    c = stack.pop()
                    if c < 0:
                        found.append(~c)
                    else:
                        stack += [tree.left_child[c], tree.right_child[c]]
                rows = np.isin(leaf, found) & inbag
                sums.append({"G": float(g[rows].sum()),
                             "H": float(h[rows].sum()),
                             "rows": int(rows.sum())})
            gl, hl = sums[0]["G"], sums[0]["H"]
            gr, hr = sums[1]["G"], sums[1]["H"]
            return {"leaf": int(tree.split_leaf[i]),
                    "feature": int(tree.split_feature[i]),
                    "threshold_bin": int(tree.threshold_bin[i]),
                    "gain_f32": float(tree.split_gain[i]),
                    "children": sums,
                    "exact_gain": (gl * gl / hl + gr * gr / hr
                                   - (gl + gr) ** 2 / (hl + hr))}

        js, ts = split_at(jt), split_at(tt)
        ej, ep = js["exact_gain"], ts["exact_gain"]
        out.update(parted_at_tree=t, parted_at_node=i, jax_split=js,
                   port_split=ts, root_gain=float(jt.split_gain[0]),
                   gain_tie=bool(abs(ej) <= 1e-6 * abs(jt.split_gain[0])
                                 or abs(ej - ep) <= TIE_REL * max(abs(ej),
                                                                  abs(ep))))
    out["seconds"] = time.time() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
