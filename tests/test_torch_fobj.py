"""Custom objectives (``fobj``) and ``objective="none"`` in the port and in
the JAX package.

``train(fobj=...)`` sets ``objective="none"``; each round hands ``fobj``
the raw training scores and the training Dataset and trains on the
gradients and hessians it returns, with no boost-from-average and no leaf
renewal. Every case holds the port against the JAX package (JAX on the
CPU) on the same numpy data: trees under the f32 tie rule and leaf
values and predictions within 1e-5, through every grower, with ``feval``
and a validation set (tests/test_api.py:83's call), through
``Booster.update(fobj=...)``, and through the model text.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import bench_data, logistic_fobj

from test_torch_regression import assert_tie_rule

PARAMS = {"num_leaves": 15, "min_data_in_leaf": 40, "verbosity": -1}
ROUNDS = 3
GROWTHS = {
    "exact": {},
    "frontier": {"tree_growth": "frontier"},
    "batched": {"tree_growth": "batched", "tree_batch_splits": 4},
    "batched_pack": {"tree_growth": "batched", "tree_batch_splits": 4,
                     "tpu_batched_pack": True},
    "batched_part": {"tree_growth": "batched", "tree_batch_splits": 4,
                     "tpu_batched_part": "true"},
}


def l2_obj(preds, dataset):
    grad = preds - dataset.get_label()
    return grad, np.ones_like(grad)


def l1_eval(preds, dataset):
    return "mae", float(np.mean(np.abs(preds - dataset.get_label()))), False


def regression(n=3000, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    return x, x[:, 0] + x[:, 1] * x[:, 2] + 0.3 * r.randn(n)


def assert_same_forest(jb, tb, x):
    assert len(tb.models) == len(jb._impl.models)
    for jt, tt in zip(jb._impl.models, tb.models):
        assert_tie_rule(jt, tt)
    jt, tt = jb._impl.models[0], tb.models[0]
    nl = jt.num_leaves_actual
    np.testing.assert_allclose(tt.leaf_value[:nl], jt.leaf_value[:nl],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("growth", sorted(GROWTHS))
def test_train_fobj_matches_jax(growth):
    """The logistic loss as a custom objective on bench.py's data (the
    call of chip_smoke.py's path 4q), with the AUC metric."""
    x, y = bench_data(3000)
    params = dict(PARAMS, metric="auc", **GROWTHS[growth])
    jev, tev = {}, {}
    jtr = jlgb.Dataset(x, label=y)
    jb = jlgb.train(params, jtr, num_boost_round=ROUNDS, fobj=logistic_fobj,
                    valid_sets=[jtr], valid_names=["training"],
                    evals_result=jev, verbose_eval=False)
    ttr = tlgb.Dataset(x, label=y, device="cpu")
    tb = tlgb.train(params, ttr, num_boost_round=ROUNDS, fobj=logistic_fobj,
                    valid_sets=[ttr], valid_names=["training"],
                    evals_result=tev, verbose_eval=False, device="cpu")
    assert tb._impl.objective is None and tb.params["objective"] == "none"
    assert_same_forest(jb, tb, x)
    np.testing.assert_allclose(tev["training"]["auc"],
                               jev["training"]["auc"], rtol=0, atol=1e-6)
    # no objective: predict gives the raw scores
    np.testing.assert_array_equal(tb.predict(x), tb.predict(x,
                                                            raw_score=True))


def test_fobj_with_feval_and_a_valid_set_matches_jax():
    """tests/test_api.py:83's call (an L2 fobj, an L1 feval, the training
    set as its own valid set), plus a held-out valid set."""
    x, y = regression()
    xv, yv = regression(800, seed=1)
    params = {"verbosity": -1, "learning_rate": 0.2, "num_leaves": 15,
              "min_data_in_leaf": 40}
    evals = {}
    for pkg, extra in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        tr = pkg.Dataset(x, label=y, free_raw_data=False, **extra)
        ev = {}
        bst = pkg.train(params, tr, num_boost_round=10, fobj=l2_obj,
                        feval=l1_eval,
                        valid_sets=[tr, tr.create_valid(xv, label=yv)],
                        valid_names=["training", "valid"], evals_result=ev,
                        verbose_eval=False, **extra)
        evals[pkg.__name__] = (bst, ev)
    (jb, jev), (tb, tev) = evals["lightgbm_tpu"], evals["lightgbm_tpu_torch"]
    assert tev["training"]["mae"][-1] < tev["training"]["mae"][0]
    for name in ("training", "valid"):
        assert list(tev[name]) == list(jev[name]) == ["mae"]
        np.testing.assert_allclose(tev[name]["mae"], jev[name]["mae"],
                                   rtol=0, atol=1e-5)
    assert_same_forest(jb, tb, x)
    np.testing.assert_allclose(tb._impl.scores_of(1),
                               tb.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("objective", ["none", "regression_l1"])
def test_booster_update_fobj_matches_jax(objective):
    """``Booster.update(fobj=...)`` round by round. Under ``none`` both
    packages train on fobj's gradients. Under ``regression_l1`` the port
    takes fobj's gradients too, with no boost from average and no leaf
    renewal (as the reference's TrainOneIter does with given gradients);
    the JAX package would ignore them on its objective's path, so the
    port is held to its ``none`` run."""
    x, y = regression()
    params = dict(PARAMS, objective=objective)
    jb = jlgb.Booster(dict(PARAMS, objective="none"), jlgb.Dataset(x, label=y))
    tb = tlgb.Booster(params, tlgb.Dataset(x, label=y, device="cpu"),
                      device="cpu")
    seen = []

    def fobj(preds, dataset):
        seen.append(preds.copy())
        return l2_obj(preds, dataset)
    for _ in range(ROUNDS):
        jb.update(fobj=l2_obj)
        tb.update(fobj=fobj)
    # the first round sees scores of 0: no boost from average
    assert not seen[0].any() and seen[0].shape == (len(x),)
    # later rounds see the scores of the trees so far
    np.testing.assert_allclose(seen[-1], tb.predict(
        x, raw_score=True, num_iteration=ROUNDS - 1), rtol=0, atol=1e-5)
    assert_same_forest(jb, tb, x)


def test_objective_none_without_fobj_stops_like_jax():
    """With no objective and no fobj the gradients are 0: no split has a
    gain, and both packages stop with one constant tree."""
    x, y = regression(600)
    params = dict(PARAMS, objective="none")
    jb = jlgb.train(params, jlgb.Dataset(x, label=y), num_boost_round=2)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=2, device="cpu")
    assert tb.num_trees() == jb.num_trees() == 1
    np.testing.assert_allclose(tb.predict(x[:10]), jb.predict(x[:10]),
                               atol=1e-7)


def test_fobj_model_text_round_trips():
    """The model text says ``objective=custom`` as the JAX package's does;
    it loads in both packages and predicts the raw scores within 1e-6."""
    x, y = bench_data(2000)
    tb = tlgb.train(PARAMS, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=ROUNDS, fobj=logistic_fobj, device="cpu")
    text = tb.model_to_string()
    assert "\nobjective=custom\n" in text
    want = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(
        tlgb.Booster(model_str=text, device="cpu").predict(x), want, rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(jlgb.Booster(model_str=text).predict(x),
                               want, rtol=0, atol=1e-6)


def test_fobj_gradients_must_cover_every_row():
    x, y = regression(600)
    bst = tlgb.Booster(dict(PARAMS, objective="none"),
                       tlgb.Dataset(x, label=y, device="cpu"), device="cpu")
    with pytest.raises(Exception, match="has 300 values"):
        bst.update(fobj=lambda p, d: (p[:300], np.ones(300)))
