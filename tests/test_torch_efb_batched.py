"""tests/test_torch_efb.py's grower cases under frontier, batched and
batched growth with packed steps (``tpu_batched_pack``): trees against the
JAX package, the layout against none in the port, and the packed b-tag
features split on (the test_torch_efb.py module docstring)."""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest

import test_torch_efb as efb

WAVES = ["batched", "batched_pack", "frontier"]


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("growth", WAVES)
def test_trees_match_jax(growth, objective):
    efb.test_trees_match_jax(growth, objective)


def test_trees_split_on_packed_features():
    efb.trees_split_on_packed_features()


@pytest.mark.parametrize("growth", WAVES)
def test_layout_changes_nothing_in_the_port(growth):
    efb.test_layout_changes_nothing_in_the_port(growth)
