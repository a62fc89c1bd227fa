"""Validation sets, early stopping, callbacks and continued training, in the
port and in the JAX package.

Both packages train on tests/test_torch_regression.py's data (n=2000,
f=10, num_leaves=15, max_bin=63) with a validation set of 600 rows drawn
the same way from another seed, binned with the training set's mappers.
The contract:

- ``evals_result`` per iteration within rtol 1e-5, for the training set
  (passed among ``valid_sets``) and the validation set, under a renewing
  objective and a weighted one;
- the valid scores held on the device equal ``predict(raw_score=True)`` on
  the validation rows within 1e-5;
- early stopping on a small noisy set at a high learning rate gives the
  same ``best_iteration`` and tree count, and ``predict`` stops there;
- ``rollback_one_iter`` takes the last tree out of the training and valid
  scores, back to the JAX package's after its own rollback;
- ``learning_rates`` (a list and a callable) and ``reset_parameter`` give
  the JAX package's trees;
- the default call ``train({}, Dataset(X, y))`` is L2 regression with the
  l2 metric for 100 rounds, the JAX package's model within 1e-4;
- ``init_model`` (a JAX-written model text, or a port Booster) continues
  as the JAX package does: the same trees after the init model's, and the
  same predictions. The JAX package itself cannot continue from a model
  text with a validation set (its binned replay reads bin attributes that
  a loaded tree lacks; ROADMAP Queue 3), so the port's valid scores there
  are held against its own raw-value predictions.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import re

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_regression import assert_tie_rule, regression_data

PARAMS = {"num_leaves": 15, "max_bin": 63, "verbosity": -1}


def valid_data(objective="regression", n=600):
    return regression_data(objective, n=n, seed=8)


def datasets(objective="regression", weighted=False):
    """(x, y, xv, yv, w, JAX train/valid Datasets, port train/valid
    Datasets)."""
    x, y = regression_data(objective)
    xv, yv = valid_data(objective)
    w = np.random.RandomState(9).rand(len(y)) + 0.5 if weighted else None
    jtr = jlgb.Dataset(x, y, weight=w, free_raw_data=False)
    jva = jtr.create_valid(xv, yv)
    ttr = tlgb.Dataset(x, y, weight=w, device="cpu")
    tva = ttr.create_valid(xv, yv)
    return x, y, xv, yv, jtr, jva, ttr, tva


def train_both(params, rounds, objective="regression", weighted=False,
               **kwargs):
    """Train both packages with the training set and a validation set
    among ``valid_sets``; returns (JAX booster, port booster, JAX
    evals_result, port evals_result, xv)."""
    x, y, xv, yv, jtr, jva, ttr, tva = datasets(objective, weighted)
    params = dict(PARAMS, objective=objective, **params)
    jev, tev = {}, {}
    jb = jlgb.train(params, jtr, num_boost_round=rounds,
                    valid_sets=[jtr, jva], valid_names=["train", "valid"],
                    evals_result=jev, verbose_eval=False, **kwargs)
    tb = tlgb.train(params, ttr, num_boost_round=rounds,
                    valid_sets=[ttr, tva], valid_names=["train", "valid"],
                    evals_result=tev, verbose_eval=False, device="cpu",
                    **kwargs)
    return jb, tb, jev, tev, xv


# l2 (the default) is held in test_early_stopping_matches_jax's history
EVAL_CASES = [("regression_l1", False, {}),
              ("huber", True, {"metric": "l2,l1,huber"}),
              ("mape", True, {})]


@pytest.mark.parametrize("objective,weighted,params", EVAL_CASES,
                         ids=["%s%s" % (o, "-w" if w else "")
                              for o, w, _ in EVAL_CASES])
def test_evals_result_matches_jax(objective, weighted, params):
    jb, tb, jev, tev, xv = train_both(params, 4, objective, weighted)
    assert list(tev) == list(jev) == ["train", "valid"]
    for name in jev:
        assert list(tev[name]) == list(jev[name])
        for metric in jev[name]:
            assert len(tev[name][metric]) == 4
            np.testing.assert_allclose(tev[name][metric], jev[name][metric],
                                       rtol=1e-5)
    # the device-side valid scores are the model's raw predictions
    np.testing.assert_allclose(tb._impl.scores_of(1),
                               tb.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        tb._impl.scores_of(1),
        np.asarray(jb._impl._valid_pred_cache[0]["scores"])[:, 0], rtol=0,
        atol=1e-4)
    assert tb.best_iteration == jb.best_iteration == 4
    assert tb.best_score["valid"] == pytest.approx(jb.best_score["valid"],
                                                   rel=1e-5)


def test_early_stopping_matches_jax():
    """A noisy target and a high learning rate: the validation l2 turns
    up after a few rounds."""
    r = np.random.RandomState(21)
    x, xv = r.randn(400, 6), r.randn(300, 6)
    y = x[:, 0] + x[:, 1] * x[:, 2] + r.randn(400)
    yv = xv[:, 0] + xv[:, 1] * xv[:, 2] + r.randn(300)
    params = dict(PARAMS, learning_rate=0.5, num_leaves=31)
    out = {}
    for name, lgb, kw in (("jax", jlgb, {}), ("port", tlgb,
                                              {"device": "cpu"})):
        ds = lgb.Dataset(x, y, **kw)
        ev = {}
        bst = lgb.train(params, ds, num_boost_round=40,
                        valid_sets=[ds.create_valid(xv, yv)],
                        early_stopping_rounds=3, evals_result=ev,
                        verbose_eval=False, **kw)
        out[name] = (bst, ev)
    (jb, jev), (tb, tev) = out["jax"], out["port"]
    assert 1 < tb.best_iteration == jb.best_iteration < 20
    assert tb.num_trees() == jb.num_trees() == tb.best_iteration + 3
    np.testing.assert_allclose(tev["valid_0"]["l2"], jev["valid_0"]["l2"],
                               rtol=1e-5)
    # predict stops at the best iteration unless asked otherwise
    best = tb.best_iteration
    np.testing.assert_allclose(tb.predict(xv),
                               tb.predict(xv, num_iteration=best))
    assert not np.allclose(tb.predict(xv),
                           tb.predict(xv, num_iteration=tb.num_trees()))
    np.testing.assert_allclose(tb.predict(xv), jb.predict(xv), atol=1e-4)
    assert "Tree=%d" % best not in tb.model_to_string()


def test_rollback_restores_train_and_valid_scores():
    x, y, xv, yv, jtr, jva, ttr, tva = datasets()
    params = dict(PARAMS, objective="regression_l1")
    jb = jlgb.Booster(params, jtr)
    jb.add_valid(jva, "valid")
    tb = tlgb.Booster(params, ttr, device="cpu")
    tb.add_valid(tva, "valid")
    for _ in range(2):
        jb.update()
        tb.update()
    train_2, valid_2 = tb._impl.scores_of(0), tb._impl.scores_of(1)
    jb.update()
    tb.update()
    jb.rollback_one_iter()
    tb.rollback_one_iter()
    assert tb.num_trees() == jb.num_trees() == 2
    np.testing.assert_allclose(tb._impl.scores_of(0), train_2, atol=1e-6)
    np.testing.assert_allclose(tb._impl.scores_of(1), valid_2, atol=1e-6)
    np.testing.assert_allclose(tb._impl.scores_of(0),
                               np.asarray(jb._impl.scores)[:, 0], atol=1e-4)
    np.testing.assert_allclose(
        tb._impl.scores_of(1),
        np.asarray(jb._impl._valid_pred_cache[0]["scores"])[:, 0], atol=1e-4)
    (_, _, tval, _), = tb.eval_valid()
    (_, _, jval, _), = jb.eval_valid()
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    # training goes on from the rolled-back state as the JAX package's does
    jb.update()
    tb.update()
    np.testing.assert_allclose(tb.predict(xv, raw_score=True),
                               jb.predict(xv, raw_score=True), atol=1e-4)


SCHEDULES = {
    "list": {"learning_rates": [0.3, 0.2, 0.1]},
    "callable": {"learning_rates": lambda i: 0.3 * 0.5 ** i},
    "reset_parameter": {"callbacks": "reset_parameter"},
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_learning_rate_schedules_match_jax(kind):
    kwargs = dict(SCHEDULES[kind])
    x, y = regression_data()
    boosters = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        if kwargs.get("callbacks") == "reset_parameter":
            kw["callbacks"] = [lgb.reset_parameter(
                learning_rate=[0.05, 0.4, 0.2],
                min_data_in_leaf=[20, 20, 20])]
        else:
            kw.update(kwargs)
        boosters.append(lgb.train(dict(PARAMS, objective="regression"),
                                  lgb.Dataset(x, y, **({"device": "cpu"}
                                                       if lgb is tlgb
                                                       else {})),
                                  num_boost_round=3, **kw))
    jb, tb = boosters
    for jt, tt in zip(jb._impl.models, tb.models):
        np.testing.assert_array_equal(tt.split_feature, jt.split_feature)
        np.testing.assert_allclose(tt.shrinkage, jt.shrinkage, rtol=1e-12)
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), atol=1e-4)


def test_init_model_continues_a_jax_model_text(tmp_path):
    x, y, xv, yv, jtr, _, ttr, tva = datasets("regression_l1")
    params = dict(PARAMS, objective="regression_l1")
    text = jlgb.train(params, jlgb.Dataset(x, y),
                      num_boost_round=2).model_to_string()
    jb = jlgb.train(params, jtr, num_boost_round=2,
                    init_model=jlgb.Booster(model_str=text))
    ev = {}
    tb = tlgb.train(params, ttr, num_boost_round=2,
                    init_model=tlgb.Booster(model_str=text, device="cpu"),
                    valid_sets=[tva], evals_result=ev, verbose_eval=False,
                    device="cpu")
    assert tb.num_trees() == jb.num_trees() == 4
    assert tb.current_iteration() == 4
    for jt, tt in zip(jb._impl.models, tb.models):
        np.testing.assert_array_equal(tt.split_feature[:jt.num_leaves - 1],
                                      jt.split_feature[:jt.num_leaves - 1])
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), atol=1e-4)
    # the valid scores replay all four trees, the merged ones included
    raw = tb.predict(xv, raw_score=True)
    np.testing.assert_allclose(tb._impl.scores_of(1), raw, atol=1e-5)
    np.testing.assert_allclose(ev["valid_0"]["l1"][-1],
                               np.mean(np.abs(raw - yv)), rtol=1e-6)
    # a model file path continues the same way
    path = tmp_path / "init.txt"
    path.write_text(text)
    again = tlgb.train(params, tlgb.Dataset(x, y, device="cpu"),
                       num_boost_round=2, init_model=str(path), device="cpu")
    np.testing.assert_allclose(again.predict(x), tb.predict(x), atol=1e-6)


def test_init_model_from_a_port_booster():
    x, y = regression_data()
    params = dict(PARAMS, objective="regression")
    first = tlgb.train(params, tlgb.Dataset(x, y, device="cpu"),
                       num_boost_round=2, device="cpu")
    more = tlgb.train(params, tlgb.Dataset(x, y, device="cpu"),
                      num_boost_round=2, init_model=first, device="cpu")
    whole = tlgb.train(params, tlgb.Dataset(x, y, device="cpu"),
                       num_boost_round=4, device="cpu")
    # the merged trees are copies with the same bins
    for a, b in zip(more.models[:2], first.models):
        assert a is not b
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    # continuing from the same data's scores builds the same forest as an
    # uninterrupted run, up to float32 rounding of the carried scores
    np.testing.assert_allclose(more.predict(x), whole.predict(x), atol=1e-4)


def test_feval_and_record_evaluation():
    def mean_residual(preds, data):
        return "mean_residual", float(np.mean(data.get_label() - preds)), \
            False

    def two(preds, data):
        return [("p_max", float(np.max(preds)), True),
                ("p_min", float(np.min(preds)), False)]

    x, y, xv, yv, jtr, jva, ttr, tva = datasets()
    out = {}
    for name, lgb, tr, va, kw in (("jax", jlgb, jtr, jva, {}),
                                  ("port", tlgb, ttr, tva,
                                   {"device": "cpu"})):
        ev = {}
        lgb.train(dict(PARAMS, objective="regression"), tr,
                  num_boost_round=3, valid_sets=[va], feval=two,
                  callbacks=[lgb.record_evaluation(ev)], verbose_eval=False,
                  **kw)
        out[name] = ev
    assert list(out["port"]["valid_0"]) == ["l2", "p_max", "p_min"]
    for metric in ("l2", "p_max", "p_min"):
        np.testing.assert_allclose(out["port"]["valid_0"][metric],
                                   out["jax"]["valid_0"][metric], rtol=1e-5)
    tb = tlgb.Booster(dict(PARAMS, objective="regression"), ttr,
                      device="cpu")
    tb.add_valid(tva, "v")
    tb.update()
    (name, metric, value, bigger), = tb.eval(tva, "v",
                                             mean_residual)[1:]
    assert (name, metric, bigger) == ("v", "mean_residual", False)
    np.testing.assert_allclose(
        value, np.mean(yv - tb.predict(xv, raw_score=True)), rtol=1e-5)
    assert tb.eval_train()[0][:2] == ("training", "l2")


def test_print_evaluation_logs_each_period():
    x, y, xv, yv, _, _, ttr, tva = datasets()
    from lightgbm_tpu_torch.log import Log
    lines = []
    Log.reset_callback(lines.append)
    try:
        tlgb.train(dict(PARAMS, objective="regression", verbosity=1), ttr,
                   num_boost_round=4, valid_sets=[tva], verbose_eval=2,
                   device="cpu")
    finally:
        Log.reset_callback(None)
    shown = [re.search(r"\[(\d+)\]\t", s).group(1) for s in lines
             if "valid_0's l2" in s]
    assert shown == ["2", "4"]


def test_default_call_is_l2_regression_like_jax():
    """lgb.train({}, Dataset(X, y)): regression with the l2 metric, 100
    rounds of 31 leaves, as in the JAX package."""
    r = np.random.RandomState(3)
    x = r.randn(500, 5)
    y = x[:, 0] + x[:, 1] * x[:, 2] + 0.3 * r.randn(500)
    jb = jlgb.train({}, jlgb.Dataset(x, y))
    tb = tlgb.train({}, tlgb.Dataset(x, y, device="cpu"), device="cpu")
    (_, name, value, bigger), = tb.eval_train()
    assert (name, bigger) == ("l2", False)
    assert tb.num_trees() == jb.num_trees() == 100
    for jt, tt in zip(jb._impl.models, tb.models):
        assert_tie_rule(jt, tt)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), atol=1e-4)
    np.testing.assert_allclose(value, jb.eval_train()[0][2], rtol=1e-4)
