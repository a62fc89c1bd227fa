"""The scikit-learn estimators, the Booster's dump and inspection methods,
pickling, the Dataset's fields and subsets, and plotting (ROADMAP Queue 1
#17), in the port and in the JAX package.

- Estimators: ``LGBMClassifier`` (string labels with a validation set, AUC
  and early stopping; ``class_weight="balanced"``; three classes),
  ``LGBMRegressor`` with a callable objective and a callable metric, and
  ``LGBMRanker`` with ``eval_at``, fitted by both packages on the same
  numpy data (2,000-3,000 rows, 7-15 leaves): predictions within 1.2e-5
  (exact growth builds the JAX package's trees), ``classes_``,
  ``best_iteration_`` and ``feature_importances_`` equal, ``evals_result_``
  within 1e-6 relative (float32 metrics of scores that agree within
  1.2e-5: a unit in the last place). The classifier with scikit-learn hidden (the
  fallback classes, as on a machine without it) equals the run with it.
- ``dump_model``, ``get_split_value_histogram`` (by index and by name,
  both forms) and ``get_leaf_output``: both packages load the port's model
  text and must give equal results; so must ``plot_importance``'s bars and
  ``create_tree_digraph``'s DOT source.
- Pickling keeps the model text, the best iteration and score and the
  device type; a CUDA booster unpickled where CUDA is absent raises.
- ``Dataset``: the fields set before and after binning, ``get_field``,
  ``set_reference`` and ``subset``, against the JAX package's.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import importlib.util
import pickle
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import bench_data, ranking_data, regression_data
from lightgbm_tpu_torch import sklearn as tsklearn

PRED_TOL = 1.2e-5
EVAL_REL_TOL = 1e-6


def _binary(n=3000, seed=0):
    x, y = bench_data(n, f=8, seed=seed)
    return x.astype(np.float64), y.astype(np.float64)


def _labels(y):
    return np.where(y > 0, "pos", "neg")


def _l2_objective(y_true, y_pred):
    return y_pred - y_true, np.ones_like(y_true)


def _l2_metric(y_true, y_pred):
    return "l2_np", float(np.mean((y_pred - y_true) ** 2)), False


def _fit(pkg, case):
    """(estimator, test rows) of ``case``, fitted by ``pkg``."""
    kw = {"num_leaves": 7} if pkg is jlgb else {"num_leaves": 7,
                                                 "device": "cpu"}
    x, y = _binary()
    xv, yv = _binary(800, seed=1)
    if case == "binary_strings":
        est = pkg.LGBMClassifier(n_estimators=8, **kw)
        est.fit(x, _labels(y), eval_set=[(xv, _labels(yv))],
                eval_metric="auc", early_stopping_rounds=2, verbose=False)
    elif case == "balanced":
        # a quarter of the rows positive, through the noisy target
        y = (regression_data(len(x), f=8)[1] > 0.8).astype(np.int64)
        est = pkg.LGBMClassifier(n_estimators=5, class_weight="balanced",
                                 **kw)
        est.fit(x, y)
    elif case == "three_classes":
        y = np.digitize(x[:, 0] + x[:, 1] * x[:, 2], [-0.5, 0.5])
        yv = np.digitize(xv[:, 0] + xv[:, 1] * xv[:, 2], [-0.5, 0.5])
        est = pkg.LGBMClassifier(n_estimators=5, **kw)
        est.fit(x, y, eval_set=[(xv, yv)], verbose=False)
    elif case == "regressor_callables":
        t = x[:, 0] + x[:, 1] * x[:, 2]
        tv = xv[:, 0] + xv[:, 1] * xv[:, 2]
        est = pkg.LGBMRegressor(n_estimators=5, objective=_l2_objective,
                                **kw)
        est.fit(x, t, eval_set=[(xv, tv)], eval_metric=_l2_metric,
                verbose=False)
    else:
        x, rel, sizes = ranking_data(3000)
        x = x.astype(np.float64)
        xv, relv, sizes_v = ranking_data(1000, seed=1)
        est = pkg.LGBMRanker(n_estimators=5, **kw)
        est.fit(x, rel, group=sizes, eval_set=[(xv, relv)],
                eval_group=[sizes_v], eval_at=[1, 3], verbose=False)
    return est, xv


ESTIMATOR_CASES = ("binary_strings", "balanced", "three_classes",
                   "regressor_callables", "ranker_eval_at")


@pytest.mark.parametrize("case", ESTIMATOR_CASES)
def test_estimator_matches_the_jax_package(case):
    (jest, xv), (test, _) = _fit(jlgb, case), _fit(tlgb, case)
    np.testing.assert_allclose(test.predict(xv, raw_score=True),
                               jest.predict(xv, raw_score=True),
                               rtol=0, atol=PRED_TOL)
    assert test.best_iteration_ == jest.best_iteration_
    np.testing.assert_array_equal(test.feature_importances_,
                                  jest.feature_importances_)
    assert test.evals_result_.keys() == jest.evals_result_.keys()
    for name, per_metric in jest.evals_result_.items():
        assert test.evals_result_[name].keys() == per_metric.keys()
        for metric, values in per_metric.items():
            np.testing.assert_allclose(test.evals_result_[name][metric],
                                       values, rtol=EVAL_REL_TOL)
    if case in ("binary_strings", "balanced", "three_classes"):
        np.testing.assert_array_equal(test.classes_, jest.classes_)
        np.testing.assert_allclose(test.predict_proba(xv),
                                   jest.predict_proba(xv), rtol=0,
                                   atol=PRED_TOL)
        np.testing.assert_array_equal(test.predict(xv), jest.predict(xv))
    if case == "binary_strings":
        assert set(test.predict(xv)) == {"neg", "pos"}
        assert 0 < test.best_iteration_ <= 8


def _without_sklearn(monkeypatch):
    """A fresh copy of the port's estimator module imported as if
    scikit-learn were not installed."""
    for name in ("sklearn", "sklearn.base", "sklearn.preprocessing"):
        monkeypatch.setitem(sys.modules, name, None)
    spec = importlib.util.spec_from_file_location(
        "lightgbm_tpu_torch._sklearn_fallback", tsklearn.__file__)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_classifier_without_sklearn_matches_it(monkeypatch):
    fallback = _without_sklearn(monkeypatch)
    assert not fallback._SKLEARN_INSTALLED and tsklearn._SKLEARN_INSTALLED
    x, y = _binary(2000)
    labels = np.where(x[:, 1] > 0.3, "c", np.where(y > 0, "b", "a"))
    fits = [mod.LGBMClassifier(n_estimators=4, num_leaves=7,
                               device="cpu").fit(x, labels)
            for mod in (tsklearn, fallback)]
    np.testing.assert_array_equal(fits[0].classes_, fits[1].classes_)
    np.testing.assert_array_equal(fits[0].predict_proba(x),
                                  fits[1].predict_proba(x))
    np.testing.assert_array_equal(fits[0].predict(x), fits[1].predict(x))


def test_device_is_a_parameter_and_fit_trains_on_it(monkeypatch):
    est = tlgb.LGBMRegressor(n_estimators=2, device="cpu")
    assert est.get_params()["device"] == "cpu"
    x, y = _binary(500)
    assert est.fit(x, y).booster_.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.LGBMRegressor(n_estimators=2).fit(x, y)


_MODELS = {}


def _model_text(kind):
    """The port's model text of ``kind``, trained once: binary with a
    categorical column and missing values, or three classes."""
    if kind not in _MODELS:
        x, y = _binary(2000)
        params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
        cat = "auto"
        if kind == "multiclass":
            y = np.digitize(x[:, 0] + x[:, 1] * x[:, 2], [-0.5, 0.5])
            params.update(objective="multiclass", num_class=3)
        else:
            x[:, 7] = np.floor(np.abs(x[:, 7]) * 4)
            x[::7, 3] = np.nan
            cat = [7]
        bst = tlgb.train(params, tlgb.Dataset(
            x, label=y, categorical_feature=cat, device="cpu"),
            num_boost_round=4, device="cpu")
        _MODELS[kind] = (bst.model_to_string(), x, bst)
    return _MODELS[kind]


@pytest.mark.parametrize("kind", ["binary_categorical", "multiclass"])
def test_dump_histogram_and_leaf_output_match(kind):
    text, _, trained = _model_text(kind)
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    assert tb.dump_model() == jb.dump_model()
    assert trained.dump_model()["tree_info"] == jb.dump_model()["tree_info"]
    assert tb.dump_model(num_iteration=2) == jb.dump_model(num_iteration=2)
    names = tb.feature_name()
    for f in range(len(names)):
        for bins in (None, 5):
            th, te = tb.get_split_value_histogram(f, bins=bins)
            jh, je = jb.get_split_value_histogram(f, bins=bins)
            np.testing.assert_array_equal(th, jh)
            np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(
            tb.get_split_value_histogram(names[f], xgboost_style=True),
            jb.get_split_value_histogram(names[f], xgboost_style=True))
    for t, tree in enumerate(tb.models):
        for leaf in range(tree.num_leaves_actual):
            assert tb.get_leaf_output(t, leaf) == jb.get_leaf_output(t, leaf)
    with pytest.raises(tlgb.LightGBMError, match="out of range"):
        tb.get_leaf_output(len(tb.models), 0)


def test_split_histogram_counts_every_numerical_split():
    _, _, bst = _model_text("binary_categorical")
    for f in range(8):
        want = sum(int(((t.split_feature[:t.num_leaves_actual - 1] == f)
                        & ~t.is_categorical[:t.num_leaves_actual - 1]).sum())
                   for t in bst.models)
        assert bst.get_split_value_histogram(f)[0].sum() == want


def test_booster_pickles_as_its_model_text(monkeypatch):
    text, x, bst = _model_text("binary_categorical")
    bst.best_iteration = 3
    bst.best_score = {"training": {"auc": 0.9}}
    loaded = pickle.loads(pickle.dumps(bst))
    assert loaded.device == torch.device("cpu")
    assert loaded.best_iteration == 3 and loaded.best_score == bst.best_score
    # the trees' text; the loaded parameters gain the objective's tokens
    trees = [b.model_to_string().split("\nparameters:")[0]
             for b in (loaded, bst)]
    assert trees[0] == trees[1]
    np.testing.assert_array_equal(loaded.predict(x), bst.predict(x))
    bst.best_iteration, bst.best_score = -1, {}
    state = bst.__getstate__()
    assert state["device"] == "cpu"
    state["device"] = "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.Booster.__new__(tlgb.Booster).__setstate__(state)


def test_estimator_pickles_and_predicts_the_same():
    x, y = _binary(2000)
    est = tlgb.LGBMClassifier(n_estimators=4, num_leaves=7, device="cpu")
    est.fit(x, _labels(y))
    loaded = pickle.loads(pickle.dumps(est))
    np.testing.assert_array_equal(loaded.predict_proba(x),
                                  est.predict_proba(x))
    np.testing.assert_array_equal(loaded.predict(x), est.predict(x))
    assert loaded.get_params() == est.get_params()


FIELD_VALUES = {"label": lambda n: (np.arange(n) % 2).astype(float),
                "weight": lambda n: np.linspace(0.5, 1.5, n),
                "init_score": lambda n: np.linspace(-1, 1, n),
                "group": lambda n: [n // 4] * 4}


@pytest.mark.parametrize("when", ["before", "after"])
def test_dataset_fields_match(when):
    x, y = _binary(400)
    out = {}
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(x, label=y, **kw)
        if when == "after":
            ds.construct()
        for name, make in FIELD_VALUES.items():
            ds.set_field(name, make(len(x)))
        out[pkg] = {name: ds.get_field(name) for name in FIELD_VALUES}
        out[pkg]["query"] = ds.get_field("query")
        with pytest.raises(pkg.LightGBMError, match="Unknown field"):
            ds.get_field("nope")
        with pytest.raises(pkg.LightGBMError, match="after dataset"):
            ds.construct().set_reference(pkg.Dataset(x, **kw))
    for name, value in out[jlgb].items():
        np.testing.assert_array_equal(out[tlgb][name], value)


@pytest.mark.parametrize("parent", ["binned", "raw"])
def test_subset_bins_as_the_jax_package(parent):
    x, y = _binary(1000)
    w = np.linspace(0.5, 1.5, len(x))
    rows = np.random.RandomState(3).choice(len(x), 300, replace=False)
    got = {}
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(x, label=y, weight=w, free_raw_data=False,
                         params={"max_bin": 31}, **kw)
        if parent == "binned":
            ds.construct()
        sub = ds.subset(rows).construct()
        got[pkg] = sub._binned
        assert sub.num_data() == 300
        if parent == "binned":
            assert sub.reference is ds
    j, t = got[jlgb], got[tlgb]
    np.testing.assert_array_equal(t.X_binned, j.X_binned)
    np.testing.assert_array_equal(t.metadata.label, j.metadata.label)
    np.testing.assert_array_equal(t.metadata.weight, j.metadata.weight)
    assert t.get_feature_infos() == j.get_feature_infos()


def test_subset_of_a_freed_dataset_raises():
    x, y = _binary(300)
    ds = tlgb.Dataset(x, label=y, device="cpu").construct()
    assert ds.data is None
    with pytest.raises(tlgb.LightGBMError, match="free_raw_data=False"):
        ds.subset([0, 1, 2])


def test_plots_match_the_jax_package():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    text, _, _ = _model_text("binary_categorical")
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    for kind in ("split", "gain"):
        axes = [pkg.plot_importance(b, importance_type=kind)
                for pkg, b in ((jlgb, jb), (tlgb, tb))]
        bars = [[p.get_width() for p in ax.patches] for ax in axes]
        ticks = [[t.get_text() for t in ax.get_yticklabels()] for ax in axes]
        texts = [[t.get_text() for t in ax.texts] for ax in axes]
        assert bars[0] == bars[1] and ticks[0] == ticks[1]
        assert texts[0] == texts[1] and bars[1]
    history = {"valid_0": {"auc": [0.8, 0.85, 0.9]}}
    lines = [pkg.plot_metric(history).lines[0].get_ydata().tolist()
             for pkg in (jlgb, tlgb)]
    assert lines[0] == lines[1]
    plt.close("all")
    for tree in (0, 3):
        sources = [pkg.create_tree_digraph(
            b, tree_index=tree, show_info=["split_gain", "internal_count",
                                           "leaf_count"]).source
            for pkg, b in ((jlgb, jb), (tlgb, tb))]
        assert sources[0] == sources[1] and "split0" in sources[1]
    with pytest.raises(IndexError):
        tlgb.create_tree_digraph(tb, tree_index=99)


# the sequence of the JAX package's test_reset_training_data_keeps_valid_sets
# (test_api.py) in its boosting modes: (params, how the port resets). Its
# labels are a threshold of x0 + x1 with no noise, on which trees go on
# splitting at float32 gain noise (gains of 1e-5), where the two packages
# part (the f32 gain ties of ROADMAP Queue 3); here the labels carry noise
# and the trees stop at 7 leaves of at least 40 rows, where 31 leaves of 20
# on 800 rows met a tie within 4e-6 in the first tree
RESETS = {
    "gbdt": ({}, "reset_training_data"),
    "update_train_set": ({}, "update"),
    "bagging": ({"bagging_freq": 1, "bagging_fraction": 0.7}, "update"),
    "dart_uniform": ({"boosting": "dart", "uniform_drop": True},
                     "reset_training_data"),
    "rf": ({"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.7},
           "reset_training_data"),
}


def _reset_run(pkg, params, how, more=2):
    """The reset sequence in ``pkg``: 4 rounds on 800 rows with a valid
    set, a swap to 900 new rows binned with the same mappers, ``more``
    rounds; returns the booster and what was read on the way."""
    rng = np.random.RandomState(21)
    x = rng.randn(1200, 6)
    y = (x[:, 0] + x[:, 1] + 0.5 * rng.randn(1200) > 0).astype(np.float64)
    kw = {} if pkg is jlgb else {"device": "cpu"}
    dtrain = pkg.Dataset(x[:800], y[:800], free_raw_data=False, **kw)
    dvalid = pkg.Dataset(x[800:], y[800:], reference=dtrain,
                         free_raw_data=False, **kw)
    bst = pkg.Booster(params=dict(params, objective="binary", metric="auc",
                                  num_leaves=7, min_data_in_leaf=40,
                                  verbosity=-1), train_set=dtrain, **kw)
    bst.add_valid(dvalid, "v0")
    for _ in range(4):
        bst.update()
    out = {"before": bst.eval_valid()}
    x2 = rng.randn(900, 6)
    y2 = (x2[:, 0] + x2[:, 1] + 0.5 * rng.randn(900) > 0).astype(np.float64)
    dtrain2 = pkg.Dataset(x2, y2, reference=dtrain, free_raw_data=False,
                          **kw)
    out["x2"], out["xv"] = x2, x[800:]
    if pkg is tlgb and how == "update":
        bst.update(train_set=dtrain2)
        more -= 1
    else:
        bst.reset_training_data(dtrain2)
        out["after"] = bst.eval_valid()
        if pkg is jlgb:
            # the JAX package adds the init-score offsets to the replayed
            # scores although the first tree carries them (ROADMAP Queue 3)
            offsets = getattr(bst._impl, "init_score_offsets", None)
            if offsets is not None:
                bst._impl.scores = bst._impl.scores - np.asarray(
                    offsets, np.float32)[None, :]
        out["scores"] = np.asarray(bst._impl.scores)
        if pkg is jlgb and how == "update":
            bst.update()
            more -= 1
    for _ in range(more):
        bst.update()
    out["final_scores"] = np.asarray(bst._impl.scores)
    return bst, out


@pytest.mark.parametrize("case", sorted(RESETS))
def test_reset_training_data_matches_the_jax_package(case):
    params, how = RESETS[case]
    jb, jout = _reset_run(jlgb, params, how)
    tb, tout = _reset_run(tlgb, params, how)
    if "after" in tout:
        # the model is unchanged and the valid sets keep it; the training
        # scores are its replay on the new rows
        assert tout["after"] == pytest.approx(tout["before"], abs=1e-7)
        np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=0,
                                   atol=1e-5)
        if case != "rf":
            np.testing.assert_allclose(
                tout["scores"][:, 0],
                tb.predict(tout["x2"], raw_score=True, num_iteration=4),
                rtol=0, atol=1e-5)
    for x in (tout["x2"], tout["xv"]):
        np.testing.assert_allclose(tb.predict(x, raw_score=True),
                                   jb.predict(x, raw_score=True), rtol=0,
                                   atol=PRED_TOL)
    # RF's running training sums start over in both packages: its scores
    # hold only the trees grown since the reset
    np.testing.assert_allclose(tout["final_scores"], jout["final_scores"],
                               rtol=0, atol=PRED_TOL)
    assert tb.current_iteration() == jb.current_iteration == 6


def test_weighted_dart_cannot_train_on_after_a_reset():
    """DART's tree weights start over at a reset while its iterations go
    on: the JAX package indexes past them (IndexError), the port raises."""
    params = {"boosting": "dart", "skip_drop": 0.0}
    with pytest.raises(IndexError):
        _reset_run(jlgb, params, "reset_training_data")
    with pytest.raises(tlgb.LightGBMError, match="tree weights were lost"):
        _reset_run(tlgb, params, "reset_training_data")


def test_reset_refuses_other_mappers():
    rng = np.random.RandomState(5)
    x, y = rng.randn(600, 4), (rng.rand(600) > 0.5).astype(float)
    msgs = []
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        bst = pkg.train({"objective": "binary", "verbosity": -1},
                        pkg.Dataset(x, y, **kw), num_boost_round=1, **kw)
        with pytest.raises(pkg.LightGBMError) as err:
            bst.reset_training_data(
                pkg.Dataset(x * 3 + 1, y, **kw).construct())
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "different bin mappers" in msgs[1]
