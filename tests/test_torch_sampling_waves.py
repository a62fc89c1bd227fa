"""Row sampling under frontier, batched and batched_part growth, in the
port and in the JAX package.

tests/test_torch_sampling.py's size and contract (binary on bench.py's
data cut to 3,000 x 10, num_leaves=15, max_bin=63, min_data_in_leaf=40, 4
rounds): bagging (``bagging_fraction=0.7``, ``bagging_freq=2``, the fused
key stream), GOSS (``learning_rate=0.5``, so iterations 2-3 sample), DART
(``drop_rate=0.5``, ``skip_drop=0``) and RF (``bagging_fraction=0.632``,
``feature_fraction=0.8``) under each wave grower (``tree_batch_splits=4``):
every tree splits and keeps tests/test_torch_slice.py's f32 tie rule, and
raw predictions are within 1e-5 of the port's training scores and of the
JAX model's.
"""
import pytest

from test_torch_sampling import MODES, assert_mode_parity, train_both

BATCHED = (("tree_growth", "batched"), ("tree_batch_splits", 4))
GROWTHS = {"frontier": (("tree_growth", "frontier"),),
           "batched": BATCHED,
           "batched_part": BATCHED + (("tpu_batched_part", "true"),)}
CASES = [(mode, growth) for growth in GROWTHS for mode in sorted(MODES)]


@pytest.mark.parametrize("mode,growth", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_wave_growth_matches_jax(mode, growth):
    x, jb, tb = train_both(mode, GROWTHS[growth])
    assert tb._impl.grow_params.batched_part == (growth == "batched_part")
    assert tb._impl.config.tree_growth == dict(GROWTHS[growth])[
        "tree_growth"]
    assert_mode_parity(x, jb, tb)
