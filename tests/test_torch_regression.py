"""The regression family in the port and in the JAX package.

- Gradients and hessians of the nine regression objectives (and
  ``reg_sqrt``), with and without weights, against the JAX objectives on
  the same scores: rtol 1e-6, atol 1e-6 (float32 elementwise; ``exp`` may
  differ in the last bit, which the atol covers where a difference of
  unit-scale terms cancels to near zero, as in gamma's 1 - y/exp(s)).
  ``boost_from_score`` within rtol 1e-7 (the same numpy on the same
  float32 host copies).
- Every ported metric against the JAX metric on the same scores: rtol
  1e-12 (both float64 numpy).
- ``core/renew.py`` against ``lightgbm_tpu/core/renew.py`` on seeded
  residuals, leaf ids and masks: equal with integer weights, and equal on
  the CPU with float32 weights too (both sum the weights sequentially; a
  card's parallel cumsum rounds otherwise, and tests/test_torch_kernels_cuda.py
  states the tolerance there).
- End to end at n=2000, f=10, num_leaves=15, max_bin=63, 3 rounds, under
  ``exact``: tree 0 structurally identical with leaf values within 1e-5
  relative, later trees under tests/test_torch_slice.py's tie rule, raw
  predictions within 1e-4. The JAX package runs its default histogram on
  the CPU; frontier, batched and batched_part growth are in
  tests/test_torch_regression_waves.py.
- The two repairs of this slice: the default metric follows the objective,
  and ``regression sqrt`` / ``quantile alpha:X`` survive the model text in
  both directions. The default call, ``train({}, Dataset(X, y))``, is held
  against the JAX package's in tests/test_torch_valid.py.

Quantile's gradients at alpha=0.9 (0.1 and -0.9) are not exact in float32,
so two candidate splits with the same row counts tie in exact arithmetic
and their float32 gains differ by summation order: either package may take
either split from tree 1 on. The multi-tree checks use alpha=0.75, whose
gradients (0.25, -0.75) sum exactly; alpha=0.9 is held in tree 0 here and
at full size by chip_smoke.py.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import metrics as jmetrics
from lightgbm_tpu import objectives as jobjectives
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core.renew import renew_leaf_values as jax_renew
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu_torch import metrics as tmetrics
from lightgbm_tpu_torch import objectives as tobjectives
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.core.renew import renew_leaf_values
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata

OBJECTIVES = ["regression", "regression_l1", "huber", "fair", "poisson",
              "quantile", "mape", "gamma", "tweedie"]
POSITIVE = ("poisson", "gamma", "tweedie")
PARAMS = {"num_leaves": 15, "max_bin": 63, "verbosity": -1}
ROUNDS = 3
CPU = torch.device("cpu")


def regression_data(objective="regression", n=2000, f=10, seed=7):
    """bench.py's features and its target before the threshold; labels
    made positive for the log-link objectives (Poisson counts, and
    ``exp(t/2)`` for gamma)."""
    r = np.random.RandomState(seed)
    x = r.randn(n, f)
    t = x[:, 0] + x[:, 1] * x[:, 2] + 0.5 * np.sin(3 * x[:, 3]) \
        + 0.3 * r.randn(n)
    if objective in ("poisson", "tweedie"):
        y = r.poisson(np.exp(t / 2)).astype(np.float64)
    elif objective == "gamma":
        y = np.exp(t / 2)
    else:
        y = t
    return x, y


def _objectives(name, label, weight, **params):
    """(JAX objective, port objective), both initialised on the same
    labels and weights."""
    params = dict(params, objective=name)
    jo = jobjectives.create_objective(JConfig(params))
    to = tobjectives.create_objective(TConfig(params))
    jm, tm = JMetadata(), TMetadata()
    for m in (jm, tm):
        m.set_label(label)
        m.set_weight(weight)
    jo.init(jm, len(label))
    to.init(tm, CPU)
    return jo, to


OBJECTIVE_CASES = [(o, w, {}) for o in OBJECTIVES for w in (False, True)] \
    + [("regression", w, {"reg_sqrt": True}) for w in (False, True)] \
    + [("quantile", False, {"alpha": 0.3}), ("huber", True, {"alpha": 0.5}),
       ("fair", False, {"fair_c": 0.3}),
       ("tweedie", True, {"tweedie_variance_power": 1.2})]


@pytest.mark.parametrize("name,weighted,params", OBJECTIVE_CASES,
                         ids=["%s-%s%s" % (o, "w" if w else "unw",
                                           "-" + "-".join(p) if p else "")
                              for o, w, p in OBJECTIVE_CASES])
def test_gradients_match_jax(name, weighted, params):
    r = np.random.RandomState(11)
    _, label = regression_data(name, n=500, seed=3)
    weight = r.rand(500) + 0.5 if weighted else None
    jo, to = _objectives(name, label, weight, **params)
    score = (r.randn(500) * 0.5).astype(np.float32)
    score[:5] = 0.0                       # residuals at zero below
    if name not in POSITIVE:
        score[5:10] = np.asarray(to.trans_label if hasattr(to, "trans_label")
                                 else to.label)[5:10]
    jg, jh = jo.get_gradients(jnp.asarray(score))
    tg, th = to.get_gradients(torch.as_tensor(score))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    assert tg.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(to.boost_from_score(), jo.boost_from_score(),
                               rtol=1e-7)
    raw = r.randn(50)
    np.testing.assert_allclose(to.convert_output(raw),
                               np.asarray(jo.convert_output(raw)),
                               rtol=1e-6)
    assert hasattr(to, "renew_percentile") == hasattr(jo, "renew_percentile")
    if hasattr(to, "renew_percentile"):
        assert to.renew_percentile() == jo.renew_percentile()


def test_zero_residual_keeps_a_zero_sign():
    """torch.sign(0) is 0, as jnp.sign is: L1 and MAPE rows on their label
    carry no gradient."""
    label = np.array([1.0, 2.0, -3.0, 4.0])
    for name in ("regression_l1", "mape"):
        _, to = _objectives(name, label, None)
        g, _ = to.get_gradients(torch.as_tensor(label, dtype=torch.float32))
        assert torch.equal(g, torch.zeros(4))


def test_negative_labels_refused_by_log_link_objectives():
    meta = TMetadata()
    meta.set_label(np.array([1.0, -1.0, 2.0]))
    for name in POSITIVE:
        obj = tobjectives.create_objective(TConfig({"objective": name}))
        with pytest.raises(tlgb.LightGBMError, match="negative"):
            obj.init(meta, CPU)


METRICS = ["l2", "rmse", "l1", "quantile", "huber", "fair", "poisson",
           "mape", "gamma", "gamma_deviance", "tweedie", "binary_logloss",
           "binary_error", "auc", "mae", "mse", "l2_root", "regression"]


@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "w"])
@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name, weighted):
    r = np.random.RandomState(5)
    n = 400
    if name.startswith("binary") or name == "auc":
        label = (r.rand(n) > 0.4).astype(np.float64)
        score = r.randn(n)
        conv = tobjectives.BinaryLogloss(TConfig({})).convert_output
    else:
        label = np.abs(r.randn(n)) + 0.1 * (name in ("gamma", "poisson",
                                                     "gamma_deviance",
                                                     "tweedie"))
        score = np.abs(r.randn(n)) + 0.05
        conv = None
    weight = r.rand(n) + 0.5 if weighted else None
    params = {"alpha": 0.7, "fair_c": 0.6, "tweedie_variance_power": 1.3}
    jm = jmetrics.create_metric(name, JConfig(params))
    tm = tmetrics.create_metric(name, TConfig(params))
    meta_j, meta_t = JMetadata(), TMetadata()
    for m in (meta_j, meta_t):
        m.set_label(label)
        m.set_weight(weight)
    jm.init(meta_j, n)
    tm.init(meta_t, n)
    assert tm.names == jm.names
    assert tm.factor_to_bigger_better == jm.factor_to_bigger_better
    # auc is not new here: the JAX package sums float32 weights in float32
    np.testing.assert_allclose(tm.eval(score, conv), jm.eval(score, conv),
                               rtol=1e-6 if name == "auc" else 1e-12)


@pytest.mark.parametrize("objective", OBJECTIVES + ["binary", "multiclass",
                                                    "lambdarank"])
def test_default_metric_matches_jax(objective):
    assert (tmetrics.default_metric_for_objective(objective)
            == jmetrics.default_metric_for_objective(objective))


def _renew_case(seed, n, leaves, weights):
    r = np.random.RandomState(seed)
    resid = np.round(r.randn(n), 2).astype(np.float32)   # ties included
    leaf_id = r.randint(0, leaves - 2, n).astype(np.int32)  # 2 empty
    mask = (r.rand(n) < 0.8).astype(np.float32)
    if weights == "int":
        w = r.randint(1, 4, n).astype(np.float32)
    elif weights == "f32":
        w = (r.rand(n) * 2).astype(np.float32)
    else:
        w = np.ones(n, np.float32)
    orig = r.randn(leaves).astype(np.float32)
    return resid, w, leaf_id, mask, orig


@pytest.mark.parametrize("weights", ["ones", "int", "f32"])
@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.1])
def test_renew_matches_jax(alpha, weights):
    resid, w, leaf_id, mask, orig = _renew_case(int(alpha * 10), 3000, 31,
                                                weights)
    want = np.asarray(jax_renew(jnp.asarray(resid), jnp.asarray(w),
                                jnp.asarray(leaf_id), jnp.asarray(mask), 31,
                                alpha, jnp.asarray(orig)))
    got = renew_leaf_values(torch.as_tensor(resid), torch.as_tensor(w),
                            torch.as_tensor(leaf_id).long(),
                            torch.as_tensor(mask), 31, alpha,
                            torch.as_tensor(orig)).numpy()
    np.testing.assert_array_equal(got, want)
    # the empty leaves keep their value; a bool mask gives the same
    np.testing.assert_array_equal(got[-2:], orig[-2:])
    again = renew_leaf_values(torch.as_tensor(resid), torch.as_tensor(w),
                              torch.as_tensor(leaf_id).long(),
                              torch.as_tensor(mask > 0), 31, alpha,
                              torch.as_tensor(orig)).numpy()
    np.testing.assert_array_equal(again, got)


def test_renew_is_the_weighted_percentile_of_each_leaf():
    resid, w, leaf_id, mask, orig = _renew_case(4, 500, 9, "int")
    got = renew_leaf_values(torch.as_tensor(resid), torch.as_tensor(w),
                            torch.as_tensor(leaf_id).long(),
                            torch.as_tensor(mask), 9, 0.7,
                            torch.as_tensor(orig)).numpy()
    for leaf in range(7):
        rows = (leaf_id == leaf) & (mask > 0)
        want = tobjectives._weighted_percentile(resid[rows], w[rows], 0.7)
        assert got[leaf] == np.float32(want)


# ------------------------------------------------------------ end to end
_TRAINED = {}


def train_both(objective, growth_params=(), weighted=False, **extra):
    """(x, y, JAX booster, port booster) on regression_data, trained once
    per module and case."""
    key = (objective, tuple(growth_params), weighted,
           tuple(sorted(extra.items())))
    if key not in _TRAINED:
        x, y = regression_data(objective)
        w = np.random.RandomState(9).rand(len(y)) + 0.5 if weighted else None
        params = dict(PARAMS, objective=objective, **dict(growth_params),
                      **extra)
        jb = jlgb.train(params, jlgb.Dataset(x, label=y, weight=w),
                        num_boost_round=ROUNDS)
        tb = tlgb.train(params, tlgb.Dataset(x, label=y, weight=w,
                                             device="cpu"),
                        num_boost_round=ROUNDS, device="cpu")
        _TRAINED[key] = (x, y, jb, tb)
    return _TRAINED[key]


def assert_tie_rule(jt, tt):
    """A later tree: the same size, at most 6 positional and 4 substituted
    splits apart (f32 gain ties)."""
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual - 1 == nn
    mism = np.flatnonzero(tt.split_feature[:nn] != jt.split_feature[:nn])
    assert len(mism) <= 6
    ours = collections.Counter(zip(tt.split_feature[:nn].tolist(),
                                   np.round(tt.threshold[:nn], 9)))
    ref = collections.Counter(zip(jt.split_feature[:nn].tolist(),
                                  np.round(jt.threshold[:nn], 9)))
    assert sum(((ours - ref) + (ref - ours)).values()) <= 4


def assert_parity(x, jb, tb):
    """Tree 0 identical, later trees under the tie rule, raw predictions
    within 1e-4 (tests/test_torch_slice.py's contract)."""
    jt, tt = jb._impl.models[0], tb.models[0]
    nn = jt.num_leaves_actual - 1
    assert tt.num_leaves_actual == jt.num_leaves_actual
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "default_left", "split_leaf"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      getattr(jt, name)[:nn], err_msg=name)
    np.testing.assert_allclose(tt.leaf_value[:nn + 1],
                               jt.leaf_value[:nn + 1], rtol=1e-5)
    for jt, tt in zip(jb._impl.models[1:], tb.models[1:]):
        assert_tie_rule(jt, tt)
    assert len(tb.models) == len(jb._impl.models) == ROUNDS
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=1e-4,
                               atol=1e-4)


EXACT_CASES = [(o, False, {}) for o in OBJECTIVES if o != "quantile"] + [
    ("quantile", False, {"alpha": 0.75}), ("regression_l1", True, {}),
    ("mape", True, {}), ("regression", False, {"reg_sqrt": True})]


@pytest.mark.parametrize("objective,weighted,extra", EXACT_CASES,
                         ids=["%s%s%s" % (o, "-w" if w else "",
                                          "-" + "-".join(e) if e else "")
                              for o, w, e in EXACT_CASES])
def test_exact_matches_jax(objective, weighted, extra):
    x, y, jb, tb = train_both(objective, weighted=weighted, **extra)
    assert_parity(x, jb, tb)
    (_, jname, jval, _), = jb.eval_train()
    (_, tname, tval, _), = tb.eval_train()
    assert tname == jname
    np.testing.assert_allclose(tval, jval, rtol=1e-4)


def test_quantile_at_0_9_tree0_matches_jax():
    x, y, jb, tb = train_both("quantile")
    jt, tt = jb._impl.models[0], tb.models[0]
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    # renewed leaves are residual quantiles: equal, not merely close
    np.testing.assert_array_equal(tt.leaf_value, jt.leaf_value)


@pytest.mark.parametrize("objective", OBJECTIVES + ["binary"])
def test_default_metric_follows_the_objective(objective):
    """The metric defaults to the objective's own, not binary_logloss."""
    x, y = regression_data(objective, n=300)
    if objective == "binary":
        y = (y > 0).astype(float)
    bst = tlgb.train({"objective": objective, "verbosity": -1},
                     tlgb.Dataset(x, y, device="cpu"), num_boost_round=1,
                     device="cpu")
    (_, name, _, bigger), = bst.eval_train()
    assert name == jmetrics.default_metric_for_objective(objective)
    assert not bigger


ROUND_TRIP = [("regression", {"reg_sqrt": True}, "regression sqrt"),
              ("quantile", {"alpha": 0.75}, "quantile alpha:0.75"),
              ("poisson", {}, "poisson"), ("mape", {}, "mape")]


@pytest.mark.parametrize("objective,extra,header", ROUND_TRIP,
                         ids=[r[0] + "-" + "-".join(r[1]) for r in ROUND_TRIP])
def test_model_text_round_trips(objective, extra, header):
    """The objective line carries reg_sqrt and alpha, and the port reads
    bare tokens: a model loads in either package with the same
    predictions, back-transform included."""
    x, _, jb, tb = train_both(objective, **extra)
    text = tb.model_to_string()
    assert "objective=%s\n" % header in text
    for loaded in (tlgb.Booster(model_str=text, device="cpu"),
                   jlgb.Booster(model_str=text)):
        np.testing.assert_allclose(loaded.predict(x), tb.predict(x),
                                   rtol=1e-6, atol=1e-6)
    jtext = jb.model_to_string()
    assert "objective=%s\n" % header in jtext
    back = tlgb.Booster(model_str=jtext, device="cpu")
    np.testing.assert_allclose(back.predict(x), jb.predict(x), rtol=1e-6,
                               atol=1e-6)
    assert "objective=%s\n" % header in back.model_to_string()


def test_reg_sqrt_back_transform_survives_loading():
    x, y = regression_data(n=600)
    y = y * np.abs(y)
    tb = tlgb.train(dict(PARAMS, objective="regression", reg_sqrt=True),
                    tlgb.Dataset(x, y, device="cpu"), num_boost_round=2,
                    device="cpu")
    loaded = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    assert loaded.config.reg_sqrt
    raw = loaded.predict(x, raw_score=True)
    np.testing.assert_allclose(loaded.predict(x),
                               np.sign(raw) * raw * raw, rtol=1e-6)
    np.testing.assert_allclose(loaded.predict(x), tb.predict(x), rtol=1e-6)
