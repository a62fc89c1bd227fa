"""The regression family under frontier growth, in the port and in the JAX
package: tests/test_torch_regression_waves.py's check under
``tree_growth=frontier`` (one wave splits every positive-gain leaf of a
depth level) for L2, L1, quantile (alpha=0.75) and MAPE.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest

from test_torch_regression_waves import OBJECTIVES, check_wave_growth


@pytest.mark.parametrize("objective,extra", OBJECTIVES,
                         ids=[o for o, _ in OBJECTIVES])
def test_frontier_growth_matches_jax(objective, extra):
    check_wave_growth("frontier", objective, extra)
