"""The prediction extras (ROADMAP Queue 1 #8) in the port and in the JAX
package: ``pred_leaf``, ``pred_contrib`` and ``pred_early_stop``.

Every model is trained once per module by the port (binary on bench.py's
features, three classes, binary with categorical id columns, RF,
regression; 2,000-3,000 rows, 15 leaves, 10 rounds) and loaded by the JAX
package from the port's model text, so that both predict from the same
trees:

- ``pred_leaf``: [N, T] int32, class-major for K classes (class 0's
  iterations, then class 1's), equal to the JAX package's; a row that
  differs lies within a float32 rounding of a threshold of that tree (the
  JAX package compares raw values in float32, the port in float64). The
  leaf values at those ids sum to the raw scores.
- ``pred_contrib``: the port's recursion (``predict_contrib_plain``) and
  its vectorized device version (``predict_contrib``) against the JAX
  package's ``predict_contrib`` on the same trees, within 1e-9 of each
  row's sum of |contrib| (a class's), for binary, three classes,
  categorical splits, a model loaded from text (both packages load the
  port's text), RF's averaged model and ``num_iteration``; each class's
  columns sum to its raw score.
- ``pred_early_stop``: at margin 1e30 it is ``predict``; at margin 10 and
  freq 5, and at freq 1 with a margin that stops some rows, it matches the
  JAX package, except a row within a float32 rounding of a threshold or
  whose margin at a check lies within 1e-5 of the margin; regression (an
  objective that needs accurate prediction) is not early-stopped.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import CATEGORICAL_FEATURES, bench_data, categorical_data
from conftest import make_multiclass
from lightgbm_tpu.core.shap import predict_contrib as jax_contrib
from lightgbm_tpu_torch.core import shap as tshap
from lightgbm_tpu_torch.core import tree as tree_mod

ROUNDS = 10
PARAMS = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 40,
          "verbosity": -1}
KINDS = {
    "binary": ({"objective": "binary"}, None),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, None),
    "categorical": ({"objective": "binary"}, CATEGORICAL_FEATURES),
    "rf": ({"objective": "binary", "boosting": "rf", "bagging_freq": 1,
            "bagging_fraction": 0.5}, None),
    "regression": ({"objective": "regression"}, None),
}
CONTRIB_ROWS = 100
_TRAINED = {}


def _data(kind):
    if kind == "multiclass":
        return make_multiclass(n=2000, f=10, k=3, seed=13)
    if kind == "categorical":
        return categorical_data(3000)
    x, y = bench_data(3000)
    if kind == "regression":
        y = x[:, 0] + x[:, 1] * x[:, 2]
    return x, y


def _trained(kind):
    """(x, the port's booster of ``kind``, the JAX package's booster
    loaded from its model text), trained once."""
    if kind not in _TRAINED:
        extra, cat = KINDS[kind]
        x, y = _data(kind)
        tb = tlgb.train(dict(PARAMS, **extra), tlgb.Dataset(
            x, label=y, categorical_feature=cat or "auto", device="cpu"),
            num_boost_round=ROUNDS, device="cpu")
        _TRAINED[kind] = (x, tb, jlgb.Booster(
            model_str=tb.model_to_string()))
    return _TRAINED[kind]


def _f32_flips(tree, x) -> np.ndarray:
    """[N] whether a node of ``tree`` decides each row of ``x`` otherwise
    when its value and threshold are compared in float32."""
    nn = tree.num_leaves_actual - 1
    num = ~np.asarray(tree.is_categorical[:nn], bool)
    v = x[:, tree.split_feature[:nn][num]]
    thr = tree.threshold[:nn][num]
    return ((v.astype(np.float32) <= thr.astype(np.float32))
            != (v <= thr)).any(axis=1)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_pred_leaf_matches_jax(kind):
    x, tb, jb = _trained(kind)
    k = tb.num_model_per_iteration()
    got = tb.predict(x, pred_leaf=True)
    want = np.asarray(jb.predict(x, pred_leaf=True))
    assert got.dtype == np.int32 and got.shape == want.shape \
        == (len(x), ROUNDS * k)
    for c in range(got.shape[1]):
        # class-major: column c is class c // ROUNDS, iteration c % ROUNDS
        tree = tb.models[(c % ROUNDS) * k + c // ROUNDS]
        differs = got[:, c] != want[:, c]
        assert _f32_flips(tree, x[differs]).all(), c
    # the leaf values at those ids are the raw scores
    raw = tb.predict(x, raw_score=True).reshape(len(x), k)
    for c in range(k):
        total = np.zeros(len(x), np.float32)
        for it in range(ROUNDS):
            tree = tb.models[it * k + c]
            total += tree.leaf_value.astype(np.float32)[
                got[:, c * ROUNDS + it]]
        np.testing.assert_allclose(total, raw[:, c], rtol=0, atol=1e-6)


def test_forest_leaves_are_the_replay_of_each_tree():
    x, tb, _ = _trained("multiclass")
    trees = tree_mod.stack_predict_trees(tb.models, torch.device("cpu"))
    leaves = tree_mod.predict_forest_leaves(trees, torch.as_tensor(x))
    assert leaves.dtype == torch.int32
    for i in range(len(tb.models)):
        np.testing.assert_array_equal(
            leaves[:, i].numpy(),
            tree_mod.tree_leaves(trees, i, torch.as_tensor(x)).numpy())


CONTRIB_CASES = ["binary", "multiclass", "categorical", "rf", "text",
                 "num_iteration"]


@pytest.mark.parametrize("case", CONTRIB_CASES)
def test_pred_contrib_matches_jax(case):
    kind = case if case in KINDS else (
        "multiclass" if case == "text" else "binary")
    x, tb, _ = _trained(kind)
    xs = x[:CONTRIB_ROWS]
    num_iteration = 4 if case == "num_iteration" else None
    if case == "text":
        text = tb.model_to_string()
        tb = tlgb.Booster(model_str=text, device="cpu")
        want = np.asarray(jlgb.Booster(model_str=text).predict(
            xs, pred_contrib=True))
    else:
        # the JAX package's function on the port's trees
        want = jax_contrib(tb._impl, xs, num_iteration)
    k = tb.num_model_per_iteration()
    got = tb.predict(xs, pred_contrib=True, num_iteration=num_iteration)
    plain = tshap.predict_contrib_plain(tb._impl, xs, num_iteration)
    assert got.shape == plain.shape == want.shape \
        == (len(xs), (x.shape[1] + 1) * k)
    scale = np.abs(want).reshape(len(xs), k, -1).sum(axis=2)
    for ours in (got, plain):
        err = np.abs(ours - want).reshape(len(xs), k, -1).max(axis=2)
        assert (err <= 1e-9 * scale).all(), (err / scale).max()
    raw = tb.predict(xs, raw_score=True, num_iteration=num_iteration)
    np.testing.assert_allclose(got.reshape(len(xs), k, -1).sum(axis=2),
                               raw.reshape(len(xs), k), rtol=0, atol=1e-5)


def test_contrib_chunks_rows():
    """Rows chunked to a tiny budget give the same values."""
    x, tb, _ = _trained("categorical")
    xs = x[:64]
    want = tb.predict(xs, pred_contrib=True)
    budget = tshap.CHUNK_BYTES
    tshap.CHUNK_BYTES = 1
    try:
        got = tb.predict(xs, pred_contrib=True)
    finally:
        tshap.CHUNK_BYTES = budget
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# margins at which some rows stop and others run on
MID_MARGIN = {"binary": 2.0, "multiclass": 0.5}


def _margins_at_checks(tb, x, freq):
    """[checks, N] each row's margin after every ``freq``-th iteration,
    from its leaves' values summed in float32."""
    k = tb.num_model_per_iteration()
    leaves = tb.predict(x, pred_leaf=True)
    acc = np.zeros((len(x), k), np.float32)
    out = []
    for it in range(ROUNDS):
        for c in range(k):
            acc[:, c] += tb.models[it * k + c].leaf_value.astype(
                np.float32)[leaves[:, c * ROUNDS + it]]
        if (it + 1) % freq == 0:
            top = np.sort(acc, axis=1)
            out.append(top[:, -1] - top[:, -2] if k > 1
                       else 2 * np.abs(acc[:, 0]))
    return np.array(out)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
@pytest.mark.parametrize("freq, margin", [(5, 1e30), (5, 10.0), (1, None)])
def test_pred_early_stop_matches_jax(kind, freq, margin):
    x, tb, jb = _trained(kind)
    margin = margin or MID_MARGIN[kind]
    kw = dict(raw_score=True, pred_early_stop=True,
              pred_early_stop_freq=freq, pred_early_stop_margin=margin)
    got = tb.predict(x, **kw)
    want = np.asarray(jb.predict(x, **kw), np.float64)
    if margin == 1e30:
        np.testing.assert_allclose(got, tb.predict(x, raw_score=True),
                                   rtol=0, atol=1e-6)
    margins = _margins_at_checks(tb, x, freq)
    stops = (margins >= margin).any(axis=0)
    if margin == MID_MARGIN[kind]:
        assert 0 < stops.sum() < len(x)
    near = (np.abs(margins - margin) <= 1e-5).any(axis=0)
    flips = np.any([_f32_flips(t, x) for t in tb.models], axis=0)
    diff = np.abs(got - want).reshape(len(x), -1).max(axis=1)
    assert (diff[~(near | flips)] <= 1e-5).all()


def test_regression_is_not_early_stopped():
    x, tb, _ = _trained("regression")
    np.testing.assert_array_equal(
        tb.predict(x, pred_early_stop=True, pred_early_stop_freq=1,
                   pred_early_stop_margin=0.0),
        tb.predict(x))
