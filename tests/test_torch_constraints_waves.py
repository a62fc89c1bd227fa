"""Monotone constraints under frontier, batched and batched_part growth, in
the port and in the JAX package, on the CPU.

4 rounds at 3,000 rows with tests/test_torch_constraints.py's parameters
(num_leaves=15, max_bin=63): regression with +1 on feature 0 and -1 on
feature 1 through each wave grower (batched and batched_part at
``tree_batch_splits=4``), and binary with a categorical feature under
frontier growth. Every tree under tests/test_torch_slice.py's tie rule,
raw predictions within 1e-5 of the JAX model's training scores, and the
model monotone on a grid. Each wave's children search within their bounds
through the shared ``search_children``; the bounds are set by
``apply_split_wave``, as the JAX package's wave growers set them.
"""
import numpy as np
import pytest

from chip_smoke import monotone_violation
from test_torch_constraints import (MONO, _binary_categorical, _regression,
                                    assert_parity, train_both)

GROWTH = {
    "frontier": {"tree_growth": "frontier"},
    "batched": {"tree_growth": "batched", "tree_batch_splits": 4},
    "batched_part": {"tree_growth": "batched", "tree_batch_splits": 4,
                     "tpu_batched_part": "true"},
}


@pytest.mark.parametrize("growth", sorted(GROWTH))
def test_monotone_wave_growth_matches_jax(growth):
    params = dict(GROWTH[growth], objective="regression",
                  monotone_constraints=MONO)
    x, jb, tb = train_both("mono_" + growth, params, _regression)
    assert_parity(x, jb, tb)
    assert monotone_violation(lambda p: tb.predict(p, raw_score=True), x,
                              MONO, 32, 50) <= 1e-6
    # the constraints reject candidates: some tree stops short of the cap
    # or splits feature 1 less often than unconstrained growth would
    splits = sum(int((t.split_feature[:t.num_leaves_actual - 1] == 1).sum())
                 for t in tb.models)
    assert splits < sum(t.num_leaves_actual - 1 for t in tb.models)


def test_monotone_frontier_with_a_categorical_feature_matches_jax():
    params = dict(GROWTH["frontier"], objective="binary",
                  monotone_constraints=MONO)
    x, jb, tb = train_both("mono_frontier_categorical", params,
                           _binary_categorical)
    # tree 2 splits a leaf on the categorical feature by a subset and its
    # mirror (the two packages' f32 sums choose differently), which swaps
    # the children's leaf indices: the tie rule holds, not node for node
    assert_parity(x, jb, tb, identical=False)
    assert any(t.is_categorical[:t.num_leaves_actual - 1].any()
               for t in tb.models)
    assert monotone_violation(lambda p: tb.predict(p, raw_score=True), x,
                              MONO, 32, 50) <= 1e-6
