"""Ranking and the cross-entropy objectives under frontier, batched and
batched_part growth, in the port and in the JAX package.

tests/test_torch_ranking.py's size and contract (lambdarank on 3,000 rows
in ~60 queries, num_leaves=15, max_bin=63, 3 rounds): every tree under
the f32 tie rule, raw predictions within 1e-5 of the JAX model's training
scores, every train metric (ndcg, map, topavg, topavgdiff at 1, 3 and 5)
within 1e-6 relative. Lambdarank runs under each wave grower
(``tree_batch_splits=4``); xentropy under frontier and weighted xentlambda
under batched, as chip_smoke.py's paths 4z and 4za run them.
"""
import pytest

from test_torch_ranking import assert_ranking_parity, train_both

BATCHED = (("tree_growth", "batched"), ("tree_batch_splits", 4))
GROWTHS = {"frontier": (("tree_growth", "frontier"),),
           "batched": BATCHED,
           "batched_part": BATCHED + (("tpu_batched_part", "true"),)}
CASES = [("lambdarank", g) for g in sorted(GROWTHS)] + [
    ("xentropy", "frontier"), ("xentlambda", "batched")]


@pytest.mark.parametrize("objective,growth", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_wave_growth_matches_jax(objective, growth):
    x, _, _, jb, tb = train_both(objective, GROWTHS[growth])
    assert tb._impl.grow_params.batched_part == (growth == "batched_part")
    assert_ranking_parity(x, jb, tb)
