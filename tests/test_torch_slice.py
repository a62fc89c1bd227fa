"""The slice end to end: ``train`` then ``predict`` in both packages.

Both packages train on ``conftest.make_binary`` with num_leaves=15,
max_bin=63 for 3 rounds: the JAX package with its Pallas histogram kernel
in interpret mode, the port with ``device="cpu"`` (its plain histogram).
Tree 0 must be structurally identical with leaf values within 1e-5
relative. Later trees see gradients through earlier predictions, so an f32
gain tie may flip a split: they follow the tie rule of
tests/test_parity.py. Raw predictions agree within 1e-4, and models cross
between the packages through the model text and through numpy arrays.
"""
import collections

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.convert import booster_from_numpy, forest_from_numpy
from lightgbm_tpu_torch.metrics import auc

from conftest import make_binary

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbosity": -1}
ROUNDS = 3


@pytest.fixture(scope="module")
def trained():
    x, y = make_binary(n=2000, f=10)
    jb = jlgb.train(dict(PARAMS, tpu_hist_impl="pallas_interpret"),
                    jlgb.Dataset(x, label=y), num_boost_round=ROUNDS)
    tb = tlgb.train(PARAMS, tlgb.Dataset(x, label=y, device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    return x, y, jb, tb


def test_tree0_identical(trained):
    _, _, jb, tb = trained
    jt, tt = jb._impl.models[0], tb.models[0]
    assert tt.num_leaves_actual == jt.num_leaves_actual == 15
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "default_left", "split_leaf"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tt.threshold, jt.threshold)
    np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5)
    np.testing.assert_array_equal(tt.leaf_count, jt.leaf_count)


def test_later_trees_follow_the_tie_rule(trained):
    _, _, jb, tb = trained
    for jt, tt in zip(jb._impl.models[1:], tb.models[1:]):
        nn = jt.num_leaves_actual - 1
        assert tt.num_leaves_actual - 1 == nn
        mism = np.flatnonzero(tt.split_feature[:nn] != jt.split_feature[:nn])
        assert len(mism) <= 6
        ours = collections.Counter(zip(tt.split_feature[:nn].tolist(),
                                       np.round(tt.threshold[:nn], 9)))
        ref = collections.Counter(zip(jt.split_feature[:nn].tolist(),
                                      np.round(jt.threshold[:nn], 9)))
        assert sum(((ours - ref) + (ref - ours)).values()) <= 4
        np.testing.assert_allclose(tt.split_gain[:nn].sum(),
                                   jt.split_gain[:nn].sum(), rtol=1e-3)


def test_predictions_agree(trained):
    x, y, jb, tb = trained
    raw_j = jb.predict(x, raw_score=True)
    raw_t = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(raw_t, raw_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), atol=1e-4)
    (_, name, value, bigger), = tb.eval_train()
    assert name == "binary_logloss" and not bigger
    assert abs(auc(raw_t, y) - auc(raw_j, y)) < 1e-4


def test_port_model_text_loads_in_jax(trained, tmp_path):
    x, _, _, tb = trained
    path = tmp_path / "model.txt"
    tb.save_model(str(path))
    loaded = jlgb.Booster(model_file=str(path))
    np.testing.assert_allclose(loaded.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)
    back = tlgb.Booster(model_file=str(path), device="cpu")
    np.testing.assert_array_equal(back.predict(x, raw_score=True),
                                  tb.predict(x, raw_score=True))


def test_forest_from_numpy_predicts_like_jax(trained):
    x, _, jb, _ = trained
    fields = ("split_feature", "threshold", "threshold_bin", "default_left",
              "missing_type", "left_child", "right_child", "leaf_value",
              "internal_value", "split_gain", "leaf_count", "internal_count")
    trees = [{k: np.asarray(getattr(t, k)) for k in fields}
             | {"shrinkage": t.shrinkage} for t in jb._impl.models]
    ds = jb._train_set._binned
    mappers = [m.to_dict() for m in ds.bin_mappers]
    forest = forest_from_numpy(trees)
    for ft, jt in zip(forest, jb._impl.models):
        np.testing.assert_array_equal(ft.split_leaf, jt.split_leaf)
    booster = booster_from_numpy(trees, mappers, device="cpu")
    np.testing.assert_allclose(booster.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)
    assert booster.model_to_string().count("Tree=") == ROUNDS


def _missing_data(kind):
    x, y = make_binary(n=1500, f=6, seed=21)
    r = np.random.RandomState(3)
    if kind == "nan":
        x[r.rand(*x.shape) < 0.15] = np.nan
    else:
        x[r.rand(*x.shape) < 0.25] = 0.0
    return x, y


@pytest.mark.parametrize("kind,extra", [
    ("nan", {}),
    ("zero", {"zero_as_missing": True}),
    ("nan", {"lambda_l2": 1.0, "lambda_l1": 0.1, "min_data_in_leaf": 5,
             "max_depth": 3, "feature_fraction": 0.7, "weighted": True}),
])
def test_missing_values_and_options_train_like_jax(kind, extra):
    """NaN and zero missing values route the same way in training (bin
    space) and prediction (raw values), and the regularisation, depth,
    column-sampling and weight options build the JAX package's trees."""
    x, y = _missing_data(kind)
    params = dict(PARAMS, **extra)
    w = None
    if params.pop("weighted", False):
        w = np.random.RandomState(8).rand(len(y)) + 0.5
    jb = jlgb.train(params, jlgb.Dataset(x, label=y, weight=w),
                    num_boost_round=2)
    tb = tlgb.train(params, tlgb.Dataset(x, label=y, weight=w, device="cpu"),
                    num_boost_round=2, device="cpu")
    jt, tt = jb._impl.models[0], tb.models[0]
    for name in ("split_feature", "threshold_bin", "default_left",
                 "missing_type", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), atol=1e-4)
