"""tests/test_torch_categorical.py's grower cases under frontier and
batched growth: trees against the JAX package on the categorical workload
(the test_torch_categorical.py module docstring)."""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest

import test_torch_categorical as cat


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("growth", ["batched", "frontier"])
def test_trees_match_jax(growth, objective):
    cat.test_trees_match_jax(growth, objective)
