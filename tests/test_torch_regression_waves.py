"""The regression family under batched growth, in the port and in the JAX
package.

L2, L1, quantile and MAPE (the three objectives that renew their leaves
after growth, and the default one) train in both packages under
``tree_growth=batched`` (``tree_batch_splits=16``) and the same with
``tpu_batched_part=true``, at tests/test_torch_regression.py's size and
with its contract: tree 0 structurally identical, node numbering included,
leaf values within 1e-5 relative, later trees under the tie rule, raw
predictions within 1e-4. Quantile runs at alpha=0.75 (see that file's
docstring); renewal runs after every grower, on leaf ids in the original
row order. Frontier growth is in tests/test_torch_regression_frontier.py
(the JAX package's frontier program takes ~11 s to compile on the CPU, so
the two files share the time).
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest

from test_torch_regression import assert_parity, train_both

GROWTHS = {"frontier": (("tree_growth", "frontier"),),
           "batched": (("tree_growth", "batched"), ("tree_batch_splits", 16)),
           "batched_part": (("tree_growth", "batched"),
                            ("tree_batch_splits", 16),
                            ("tpu_batched_part", "true"))}
OBJECTIVES = (("regression", {}), ("regression_l1", {}),
              ("quantile", {"alpha": 0.75}), ("mape", {}))


def check_wave_growth(growth, objective, extra):
    x, y, jb, tb = train_both(objective, GROWTHS[growth], **extra)
    assert_parity(x, jb, tb)
    (_, jname, jval, _), = jb.eval_train()
    (_, tname, tval, _), = tb.eval_train()
    assert tname == jname
    np.testing.assert_allclose(tval, jval, rtol=1e-4)


CASES = [(g, o, e) for g in ("batched", "batched_part") for o, e in OBJECTIVES]


@pytest.mark.parametrize("growth,objective,extra", CASES,
                         ids=["%s-%s" % (g, o) for g, o, _ in CASES])
def test_batched_growth_matches_jax(growth, objective, extra):
    check_wave_growth(growth, objective, extra)
