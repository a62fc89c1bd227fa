"""tests/test_torch_efb.py's grower cases under partitioned batched
growth (``tpu_batched_part=true``): trees against the JAX package, the
layout against none in the port, and the valid set's replay (the
test_torch_efb.py module docstring)."""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest

import test_torch_efb as efb


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("growth", ["batched_part"])
def test_trees_match_jax(growth, objective):
    efb.test_trees_match_jax(growth, objective)


@pytest.mark.parametrize("growth", ["batched_part"])
def test_layout_changes_nothing_in_the_port(growth):
    efb.test_layout_changes_nothing_in_the_port(growth)


@pytest.mark.parametrize("growth", ["batched_part"])
def test_valid_scores_replay_the_stored_layout(growth):
    efb.test_valid_scores_replay_the_stored_layout(growth)
