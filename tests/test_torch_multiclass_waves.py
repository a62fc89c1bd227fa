"""Multiclass under frontier, batched and batched_part growth, in the port
and in the JAX package.

tests/test_torch_multiclass.py's size and contract (3 classes, 2,000 rows,
num_leaves=15, max_bin=63, ``min_data_in_leaf=40``, 3 rounds): every class
tree under the f32 tie rule, raw [N, 3] predictions within 1e-5, the train
``multi_logloss`` within 1e-6 relative. Frontier runs one-vs-all, batched
(``tree_batch_splits=4``) softmax.

The port grows the classes in turn, so ``tpu_batched_part=true`` keeps
partitioned growth on. The JAX package vmaps the classes on the CPU and
there falls back to its unpartitioned batched step
(gbdt.py:587-605 there), so the port's batched_part multiclass is held to
the JAX package's batched trees: batched_part grows the same trees as
batched, as chip_smoke.py's dense, bundled and categorical constants of
the two show.
"""
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_multiclass import (PARAMS, ROUNDS, assert_multiclass_parity,
                                   multiclass_data)

BATCHED = {"tree_growth": "batched", "tree_batch_splits": 4}
CASES = {
    # case: (objective, the port's growth, the JAX package's growth)
    "frontier": ("multiclassova", {"tree_growth": "frontier"},
                 {"tree_growth": "frontier"}),
    "batched": ("multiclass", BATCHED, BATCHED),
    "batched_part": ("multiclass", dict(BATCHED, tpu_batched_part="true"),
                     BATCHED),
}
_JAX = {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wave_growth_matches_jax(case):
    objective, port_growth, jax_growth = CASES[case]
    x, y = multiclass_data()
    key = (objective, tuple(sorted(jax_growth.items())))
    if key not in _JAX:
        _JAX[key] = jlgb.train(dict(PARAMS, objective=objective,
                                    **jax_growth),
                               jlgb.Dataset(x, label=y),
                               num_boost_round=ROUNDS)
    tb = tlgb.train(dict(PARAMS, objective=objective, **port_growth),
                    tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    assert tb._impl.grow_params.batched_part == (case == "batched_part")
    assert_multiclass_parity(x, _JAX[key], tb)
