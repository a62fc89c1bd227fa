"""Multiclass (softmax and one-vs-all) in the port and in the JAX package.

- Gradients and hessians of ``multiclass`` and ``multiclassova``, with and
  without weights, against the JAX objectives on the same [N, K] scores:
  rtol 1e-6, atol 1e-7 (float32 elementwise; ``exp`` may differ in the
  last bit). ``boost_from_score`` per class within rtol 1e-7 (the same
  numpy on the same float32 host copies), ``convert_output`` within 1e-6.
- ``multi_logloss`` and ``multi_error`` (and their aliases) against the
  JAX metrics on the same scores and the same conversion: rtol 1e-12.
- End to end under ``exact`` at 3 classes, 2,000 rows, 10 features,
  num_leaves=15, max_bin=63, 3 rounds: every class tree under
  tests/test_torch_slice.py's tie rule, raw [N, 3] predictions within
  1e-5 of the port's training scores and of the JAX model's, train
  ``multi_logloss`` within 1e-6 relative. The JAX model's scores are
  its training scores, which come through its bins: its ``predict``
  compares raw values in float32 and sends a row within a float32
  rounding of a threshold the other way (row 945 of this data), where
  the port's compares in float64, as the binning of training did.
  Softmax's tree 0 sees one hessian (4/9) on every row and two
  gradients, so two candidates of a small leaf can tie exactly in f32;
  leaves keep 40 rows or more (``min_data_in_leaf=40``), as
  tests/test_torch_efb.py does for binary tree 0. The JAX package vmaps the classes on the CPU, the port
  grows them in turn: each class's tree is the same.
- One exact case on ``chip_smoke.categorical_data``-shaped data (its four
  id columns categorical, three classes), the model text in both
  directions with equal predictions, ``init_model``, ``num_iteration``,
  ``feature_importance``, ``booster_from_numpy(num_class=)``, a custom
  objective (``fobj``) with class-major K * N gradients under
  ``objective="none"``, ``rollback_one_iter`` and early stopping on
  ``multi_logloss``.

Frontier, batched and batched_part growth are in
tests/test_torch_multiclass_waves.py.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import CATEGORICAL_FEATURES, categorical_data
from lightgbm_tpu import metrics as jmetrics
from lightgbm_tpu import objectives as jobjectives
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu_torch import metrics as tmetrics
from lightgbm_tpu_torch import objectives as tobjectives
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import booster_from_numpy
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata

from conftest import make_multiclass
from test_torch_regression import assert_tie_rule

K = 3
ROUNDS = 3
PARAMS = {"num_class": K, "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 40, "verbosity": -1}
OBJECTIVES = ("multiclass", "multiclassova")
CPU = torch.device("cpu")


def multiclass_data(n=2000, seed=13):
    return make_multiclass(n=n, f=10, k=K, seed=seed)


def _objectives(name, label, weight):
    params = {"objective": name, "num_class": K}
    jo = jobjectives.create_objective(JConfig(params))
    to = tobjectives.create_objective(TConfig(params))
    jm, tm = JMetadata(), TMetadata()
    for m in (jm, tm):
        m.set_label(label)
        m.set_weight(weight)
    jo.init(jm, len(label))
    to.init(tm, CPU)
    return jo, to


@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "w"])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_gradients_match_jax(name, weighted):
    r = np.random.RandomState(4)
    label = r.randint(0, K, 500).astype(np.float64)
    label[:K] = np.arange(K)
    weight = r.rand(500) + 0.5 if weighted else None
    jo, to = _objectives(name, label, weight)
    assert to.num_model_per_iteration == jo.num_model_per_iteration == K
    score = (r.randn(500, K) * 0.7).astype(np.float32)
    jg, jh = jo.get_gradients(jnp.asarray(score))
    tg, th = to.get_gradients(torch.as_tensor(score))
    assert tg.shape == th.shape == (500, K)
    assert tg.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-7)
    for c in range(K):
        np.testing.assert_allclose(to.boost_from_score(c),
                                   jo.boost_from_score(c), rtol=1e-7)
    raw = r.randn(50, K)
    np.testing.assert_allclose(to.convert_output(raw),
                               np.asarray(jo.convert_output(raw)),
                               rtol=1e-6)


def test_softmax_refuses_labels_outside_the_classes():
    meta = TMetadata()
    meta.set_label(np.array([0.0, 1.0, 3.0]))
    obj = tobjectives.create_objective(TConfig({"objective": "multiclass",
                                                "num_class": K}))
    with pytest.raises(tlgb.LightGBMError, match=r"\[0, 3\)"):
        obj.init(meta, CPU)


METRICS = ["multi_logloss", "multi_error", "multiclass", "softmax",
           "multiclassova"]


@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "w"])
@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name, weighted):
    r = np.random.RandomState(6)
    n = 400
    label = r.randint(0, K, n).astype(np.float64)
    score = r.randn(n, K)
    weight = r.rand(n) + 0.5 if weighted else None
    params = {"num_class": K}
    jm = jmetrics.create_metric(name, JConfig(params))
    tm = tmetrics.create_metric(name, TConfig(params))
    meta_j, meta_t = JMetadata(), TMetadata()
    for m in (meta_j, meta_t):
        m.set_label(label)
        m.set_weight(weight)
    jm.init(meta_j, n)
    tm.init(meta_t, n)
    assert tm.names == jm.names
    assert tm.factor_to_bigger_better == jm.factor_to_bigger_better < 0
    conv = tobjectives.MulticlassSoftmax(TConfig(params)).convert_output
    for convert in (None, conv):
        np.testing.assert_allclose(tm.eval(score, convert),
                                   jm.eval(score, convert), rtol=1e-12)


_TRAINED = {}


def train_both(objective, data="dense", **extra):
    """(x, y, JAX booster, port booster) trained with the same parameters,
    once per module."""
    key = (objective, data, tuple(sorted(extra.items())))
    if key not in _TRAINED:
        if data == "categorical":
            # tests/test_torch_categorical.py's regression target, cut at
            # its terciles
            x, yb = categorical_data(3000)
            t = yb + 0.5 * x[:, 1] + 0.3 * (x[:, 29] % 3)
            y = np.searchsorted(np.quantile(t, [1 / 3, 2 / 3]), t)
            cat = CATEGORICAL_FEATURES
        else:
            (x, y), cat = multiclass_data(), "auto"
        params = dict(PARAMS, objective=objective, **extra)
        jb = jlgb.train(params, jlgb.Dataset(x, label=y,
                                             categorical_feature=cat),
                        num_boost_round=ROUNDS)
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu",
                                             categorical_feature=cat),
                        num_boost_round=ROUNDS, device="cpu")
        _TRAINED[key] = (x, y, jb, tb)
    return _TRAINED[key]


def jax_scores(jb):
    """The JAX model's raw [N, K] scores of its training rows (through its
    bins, as the model was trained)."""
    return np.asarray(jb._impl.scores, np.float64)


def assert_multiclass_parity(x, jb, tb):
    """K trees an iteration in class order, each under the tie rule; raw
    [N, K] predictions within 1e-5 of the port's training scores and of
    the JAX model's; the train metric within 1e-6."""
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration() == K
    assert len(tb.models) == len(jb._impl.models) == K * ROUNDS
    assert tb.current_iteration() == ROUNDS
    for jt, tt in zip(jb._impl.models, tb.models):
        assert_tie_rule(jt, tt)
    raw = tb.predict(x, raw_score=True)
    assert raw.shape == (len(x), K)
    np.testing.assert_allclose(raw, tb._impl.scores_of(0), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(raw, jax_scores(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tb.predict(x), tb._impl.objective.convert_output(jax_scores(jb)),
        rtol=0, atol=1e-5)
    (_, jname, jval, _), = jb.eval_train()
    (_, tname, tval, _), = tb.eval_train()
    assert tname == jname == "multi_logloss"
    np.testing.assert_allclose(tval, jval, rtol=1e-6)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_exact_matches_jax(objective):
    x, _, jb, tb = train_both(objective)
    assert_multiclass_parity(x, jb, tb)
    # the init scores fold into each class's first tree
    np.testing.assert_allclose(
        [t.leaf_value[0] for t in tb.models[:K]],
        [t.leaf_value[0] for t in jb._impl.models[:K]], rtol=0, atol=1e-5)


def test_exact_on_categorical_data_matches_jax():
    x, _, jb, tb = train_both("multiclass", "categorical")
    assert_multiclass_parity(x, jb, tb)
    assert any(t.is_categorical[:t.num_leaves_actual - 1].any()
               for t in tb.models)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_model_text_crosses_both_ways(objective):
    x, _, jb, tb = train_both(objective)
    text = tb.model_to_string()
    header = ("multiclass num_class:3" if objective == "multiclass"
              else "multiclassova num_class:3 sigmoid:1")
    assert "objective=%s\n" % header in text
    assert "num_class=3\nnum_tree_per_iteration=3\n" in text
    # each package predicts from the other's text what it predicts from
    # its own model (the JAX package in float32, the port in float64)
    loaded = tlgb.Booster(model_str=text, device="cpu")
    assert loaded.num_model_per_iteration() == K
    np.testing.assert_array_equal(loaded.predict(x, raw_score=True),
                                  tb.predict(x, raw_score=True))
    np.testing.assert_array_equal(loaded.predict(x), tb.predict(x))
    in_jax = jlgb.Booster(model_str=text)
    assert in_jax.num_model_per_iteration() == K
    np.testing.assert_allclose(in_jax.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(in_jax.predict(x), jb.predict(x), rtol=0,
                               atol=1e-5)
    back = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(back.predict(x, raw_score=True),
                               jax_scores(jb), rtol=0, atol=1e-6)
    assert "objective=%s\n" % header in back.model_to_string()


def test_num_iteration_and_importance_count_iterations():
    x, y, jb, tb = train_both("multiclass")
    two = tlgb.train(dict(PARAMS, objective="multiclass"),
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=2, device="cpu")
    np.testing.assert_allclose(tb.predict(x, num_iteration=2, raw_score=True),
                               two._impl.scores_of(0), rtol=0, atol=1e-6)
    for kind in ("split", "gain"):
        for it in (None, 1):
            np.testing.assert_allclose(
                tb.feature_importance(kind, iteration=it),
                jb.feature_importance(kind, iteration=it), rtol=1e-5)
    assert tb.feature_importance("split").sum() == sum(
        t.num_leaves_actual - 1 for t in tb.models)


def test_booster_from_numpy_takes_num_class():
    x, _, jb, _ = train_both("multiclass")
    fields = ("split_feature", "threshold", "threshold_bin", "default_left",
              "missing_type", "left_child", "right_child", "leaf_value",
              "internal_value", "split_gain", "leaf_count", "internal_count")
    trees = [{k: np.asarray(getattr(t, k)) for k in fields}
             | {"shrinkage": t.shrinkage} for t in jb._impl.models]
    mappers = [m.to_dict() for m in jb._train_set._binned.bin_mappers]
    booster = booster_from_numpy(trees, mappers, device="cpu", num_class=K)
    np.testing.assert_allclose(booster.predict(x, raw_score=True),
                               jax_scores(jb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        booster.predict(x),
        booster._impl.objective.convert_output(jax_scores(jb)), rtol=0,
        atol=1e-6)
    with pytest.raises(ValueError, match="whole iterations"):
        booster_from_numpy(trees[:-1], mappers, device="cpu", num_class=K)


def test_init_model_continues_with_k_trees_an_iteration():
    x, y, _, tb = train_both("multiclass")
    more = tlgb.train(dict(PARAMS, objective="multiclass"),
                      tlgb.Dataset(x, label=y, device="cpu",
                                   free_raw_data=False),
                      num_boost_round=1, init_model=tb, device="cpu")
    assert len(more.models) == K * (ROUNDS + 1)
    assert more.current_iteration() == ROUNDS + 1
    ref = tlgb.train(dict(PARAMS, objective="multiclass"),
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=ROUNDS + 1, device="cpu")
    np.testing.assert_allclose(more.predict(x, raw_score=True),
                               ref.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)
    with pytest.raises(tlgb.LightGBMError, match="trees per iteration"):
        tlgb.train({"objective": "regression", "verbosity": -1},
                   tlgb.Dataset(x, label=y, device="cpu",
                                free_raw_data=False),
                   num_boost_round=1, init_model=tb, device="cpu")


def softmax_fobj(preds, dataset):
    """Softmax's gradients in numpy on class-major K * N scores, returned
    class-major."""
    y = np.asarray(dataset.get_label(), np.int64)
    s = np.asarray(preds, np.float64).reshape(K, -1).T
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    grad = p - np.eye(K)[y]
    return grad.T.reshape(-1), (2.0 * p * (1.0 - p)).T.reshape(-1)


def test_fobj_takes_class_major_gradients():
    x, y = multiclass_data()
    params = dict(PARAMS, objective="none")
    jb = jlgb.train(params, jlgb.Dataset(x, label=y), num_boost_round=ROUNDS,
                    fobj=softmax_fobj)
    seen = []

    def fobj(preds, dataset):
        seen.append(np.shape(preds))
        return softmax_fobj(preds, dataset)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=ROUNDS, fobj=fobj, device="cpu")
    assert seen == [(K * len(y),)] * ROUNDS
    assert tb._impl.objective is None
    assert len(tb.models) == len(jb._impl.models) == K * ROUNDS
    for jt, tt in zip(jb._impl.models, tb.models):
        assert_tie_rule(jt, tt)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jax_scores(jb), rtol=0, atol=1e-5)
    with pytest.raises(tlgb.LightGBMError, match="3 classes"):
        tb.update(fobj=lambda p, d: (np.zeros(len(y)), np.ones(len(y))))


def test_rollback_drops_an_iteration_of_k_trees():
    x, y = multiclass_data()
    xv, yv = multiclass_data(n=500, seed=14)
    params = dict(PARAMS, objective="multiclass")
    ds = tlgb.Dataset(x, label=y, device="cpu")
    bst = tlgb.train(params, ds, num_boost_round=ROUNDS,
                     valid_sets=[ds.create_valid(xv, label=yv)],
                     verbose_eval=False, device="cpu")
    bst.rollback_one_iter()
    assert len(bst.models) == K * (ROUNDS - 1)
    ref = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=ROUNDS - 1, device="cpu")
    np.testing.assert_allclose(bst._impl.scores_of(0),
                               ref._impl.scores_of(0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bst._impl.scores_of(1),
                               ref.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)


def test_early_stopping_on_multi_logloss_matches_jax():
    """A valid set drawn away from the training rows, so that its
    multi_logloss turns up within a few rounds; the port stops where the
    JAX package stops, with the same history."""
    x, y = multiclass_data(n=600, seed=2)
    xv, yv = multiclass_data(n=400, seed=3)
    yv = (yv + (np.arange(len(yv)) % 2)) % K
    params = dict(PARAMS, objective="multiclass", learning_rate=0.5)
    out = {}
    for name, pkg, kw in (("jax", jlgb, {}), ("port", tlgb,
                                              {"device": "cpu"})):
        ds = pkg.Dataset(x, label=y, **kw)
        ev = {}
        bst = pkg.train(params, ds, num_boost_round=30,
                        valid_sets=[ds.create_valid(xv, label=yv)],
                        early_stopping_rounds=2, evals_result=ev,
                        verbose_eval=False, **kw)
        out[name] = (bst.best_iteration, ev["valid_0"]["multi_logloss"])
    assert out["port"][0] == out["jax"][0] < 28
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-5)


def test_predict_sends_a_threshold_rounding_where_training_did():
    """Two adjacent float32 values a < b: the bin boundary between them is
    their midpoint, whose nearest float32 is b. Rows at b lie above the
    threshold and trained on its right; prediction, which compares in
    float64, sends them right too (a float32 compare with the threshold's
    nearest float32 sends them left), so the training scores are the
    model's predictions."""
    a = np.nextafter(np.float32(1.0), np.float32(2.0))
    b = np.nextafter(a, np.float32(2.0))
    r = np.random.RandomState(0)
    x = np.column_stack([np.where(r.rand(2000) < 0.5, a, b),
                         r.randn(2000)]).astype(np.float32)
    y = (x[:, 0] == b).astype(np.float64)
    bst = tlgb.train({"objective": "binary", "num_leaves": 3,
                      "verbosity": -1},
                     tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=1, device="cpu")
    t = bst.models[0]
    assert t.split_feature[0] == 0
    assert a < t.threshold[0] < b == np.float32(t.threshold[0])
    np.testing.assert_array_equal(bst.predict(x, raw_score=True),
                                  bst._impl.scores_of(0))
