"""tests/test_torch_categorical.py's grower cases under batched growth
with packed steps and with partitioned rows: trees against the JAX
package, and the partitioned grower's valid set against ``predict`` (the
test_torch_categorical.py module docstring)."""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest

import test_torch_categorical as cat


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("growth", ["batched_pack", "batched_part"])
def test_trees_match_jax(growth, objective):
    cat.test_trees_match_jax(growth, objective)


@pytest.mark.parametrize("growth", ["batched_part"])
def test_valid_scores_are_predict(growth):
    cat.test_valid_scores_are_predict(growth)
